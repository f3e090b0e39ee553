"""Swift-SRGAN training in the port against the JAX package, on the CPU: the
generator's train-mode BatchNorm, the Discriminator, the adversarial BCE,
one pretrain step and one GAN step, the two-phase loop with its checkpoints
and resume, and `train-srgan` through the CLI into `super-resolve` and
`translate`'s loader.

JAX parameters are drawn with numpy from a seed (torch_parity.seeded_leaves)
and cross over through compat/from_jax with strict=True. The steps run both
sides in float64 (a fresh BatchNorm network's f32 step is not reproducible;
tests/test_torch_seg_training.py), held as the seg steps are: losses to
1e-6, every parameter's update to 2e-4 of its largest entry, every
BatchNorm running statistic to 1e-6 of its largest, and Adam's first moments
(0.1 g on a first step: the update alone, about lr * sign(g), cannot see a
gradient's scale) to 1e-6 of the largest of the network's. Forwards in f32:
rtol 1e-3 and atol 1e-4 of max |output| (tests/test_torch_models.py).
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch_parity import nhwc_to_nchw, seeded_leaves

from weatherconverter_tpu.models import srgan as JM
from weatherconverter_tpu.ops.image import adaptive_avg_pool
from weatherconverter_tpu.training import losses as JL
from weatherconverter_tpu.training import srgan as JT
from weatherconverter_tpu_torch.cli import commands as PC
from weatherconverter_tpu_torch.cli import main as PM
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core import precision
from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager
from weatherconverter_tpu_torch.core.config import SRGANTrainConfig, load_translation_config
from weatherconverter_tpu_torch.models import srgan as PMod
from weatherconverter_tpu_torch.training import loop_srgan
from weatherconverter_tpu_torch.training import losses as PL
from weatherconverter_tpu_torch.training import srgan as PT

# a narrow generator and discriminator (the JAX modules take the widths)
G_KW = dict(num_channels=8, num_blocks=2, upscale_factor=2)
D_FEATURES = (8, 8, 16, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_vars(module, hw, seed, dtype=np.float32):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), seeded_leaves(shapes, seed))


def _port_gen(variables):
    gen = PMod.Generator(3, **G_KW)
    gen.load_state_dict(from_jax.srgan_generator_state_dict(variables, G_KW["num_blocks"]), strict=True)
    return gen


def _port_disc(variables, features=D_FEATURES):
    disc = PMod.Discriminator(3, features)
    disc.load_state_dict(from_jax.srgan_discriminator_state_dict(variables), strict=True)
    return disc


def _close_stats(got_sd, want_sd):
    """Every BatchNorm running statistic of `want_sd` in `got_sd`, to 1e-6 of its largest."""
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        w = want_sd[k].numpy()
        np.testing.assert_allclose(got_sd[k].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=k)


# --- the models ---

def test_generator_train_mode_running_statistics_match_flax():
    """One train-mode forward: flax updates the running variance with the
    biased batch variance, and so must the port (torch.nn.BatchNorm2d takes
    the unbiased one, n / (n - 1) times it: here n = 2 * 4 * 4, 3 % apart);
    the output, normalized by the batch's statistics, equal too."""
    jgen = JM.Generator(**G_KW, train=True)
    variables = _jax_vars(jgen, (4, 4), 1)
    x = np.random.default_rng(2).uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    out, upd = jgen.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    gen = _port_gen(variables).train()
    got = gen(nhwc_to_nchw(x))
    ref = np.asarray(out)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())
    want = from_jax.srgan_generator_state_dict({"params": variables["params"], "batch_stats": upd["batch_stats"]},
                                               G_KW["num_blocks"])
    got_sd = gen.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            w = want[k].numpy()
            np.testing.assert_allclose(got_sd[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("hw, features", [((96, 96), (64, 64, 128, 128, 256, 256, 512, 512)),
                                          ((40, 56), (64, 64, 128, 128, 256, 256, 512, 512)),
                                          ((44, 52), D_FEATURES)])
def test_discriminator_matches_jax(hw, features):
    """The default discriminator at 96 px (a 6 x 6 map before the pool) and at
    40 x 56 (3 x 4: the pool's torch bins repeat cells), a narrow one at 44 x 52
    (11 x 13); eval mode, f32 probabilities."""
    jdisc = JM.Discriminator(features=features)
    variables = _jax_vars(jdisc, hw, 3)
    x = np.random.default_rng(4).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jdisc.apply(variables, jnp.asarray(x)))
    disc = _port_disc(variables, features).eval()
    with torch.no_grad():
        got = disc(nhwc_to_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)
    sd = from_jax.srgan_discriminator_state_dict(variables)
    assert all(torch.equal(disc.state_dict()[k].reshape(v.shape), v) for k, v in sd.items())


@pytest.mark.parametrize("hw", [(6, 6), (7, 9), (13, 20), (3, 4)])
def test_adaptive_avg_pool_bins_match_jax(hw):
    """torch's bin edges, [floor(i h / 6), ceil((i + 1) h / 6)), at sizes that divide and that do not."""
    x = np.random.default_rng(5).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(adaptive_avg_pool(jnp.asarray(x), (6, 6)))
    got = F.adaptive_avg_pool2d(nhwc_to_nchw(x), (6, 6)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_bce_on_probabilities_matches_jax():
    """BCE on probabilities clipped to [1e-7, 1 - 1e-7] (0 and 1 included), not on logits."""
    rng = np.random.default_rng(6)
    pred = rng.uniform(0, 1, (8, 1)).astype(np.float32)
    pred[0], pred[1] = 0.0, 1.0
    for target in (np.ones_like(pred), np.zeros_like(pred), (rng.uniform(size=pred.shape) > 0.5).astype(np.float32)):
        ref = float(JL.bce_logits(jnp.asarray(pred), jnp.asarray(target)))
        got = PL.bce_logits(torch.from_numpy(pred), torch.from_numpy(target))
        assert got.dtype == torch.float32 and np.isfinite(got.item())
        np.testing.assert_allclose(got.item(), ref, rtol=1e-6)
    logits = torch.from_numpy(pred)
    assert not torch.isclose(PL.bce_logits(logits[2:], torch.ones_like(logits[2:])),
                             F.binary_cross_entropy_with_logits(logits[2:], torch.ones_like(logits[2:])))


# --- one pretrain step and one GAN step, float64 ---

def _step_inputs(b=2, lr_hw=(6, 7), seed=7):
    rng = np.random.default_rng(seed)
    hr = rng.uniform(0, 1, (b, 2 * lr_hw[0], 2 * lr_hw[1], 3))
    lr = hr.reshape(b, lr_hw[0], 2, lr_hw[1], 2, 3).mean(axis=(2, 4))
    return lr, hr


def _port_moments(state):
    """{parameter name: Adam's exp_avg} of a port state."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: s["exp_avg"].clone() for p, s in state.optimizer.state.items()}


def _jax_moments(state, convert):
    """optax's mu of a JAX state under the port's parameter names."""
    return convert({"params": jax.device_get(state.opt_state[0].mu), "batch_stats": state.batch_stats})


def _close_moments(got, want, names, what):
    """Every parameter's first moment, to 1e-6 of the largest entry of the network's."""
    scale = max(np.abs(want[k].numpy()).max() for k in names)
    assert scale > 0 and sorted(got) == sorted(names), what
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6 * scale, err_msg=f"{what} {k}")


def _close_params(got_sd, want_sd, start_sd, names, what):
    for k in names:
        dw = want_sd[k].numpy() - start_sd[k].numpy()
        dg = got_sd[k].numpy() - start_sd[k].numpy()
        assert np.abs(dw).max() > 0, (what, k)
        np.testing.assert_allclose(dg, dw, rtol=0, atol=2e-4 * np.abs(dw).max(), err_msg=f"{what} {k}")


@pytest.mark.parametrize("pixel_loss", ["l1", "l2"])
def test_pretrain_then_gan_step_match_jax(pixel_loss):
    """A pretrain step, then a GAN step (the D update, then the G update
    against the updated D): each step's losses, every parameter of G and D,
    Adam's first moments, and every BatchNorm statistic: G's moved once a
    step, D's twice in the GAN step (real, then fake) and not by the G
    update's forward."""
    lr, hr = _step_inputs()
    g_convert = lambda v: from_jax.srgan_generator_state_dict(v, G_KW["num_blocks"])  # noqa: E731
    with jax.enable_x64(True):
        jgen = JM.Generator(**G_KW, train=True, dtype=jnp.float64)
        jdisc = JM.Discriminator(features=D_FEATURES, train=True, dtype=jnp.float64)
        gv, dv = _jax_vars(jgen, lr.shape[1:3], 8, np.float64), _jax_vars(jdisc, hr.shape[1:3], 9, np.float64)
        gs = JT.SRGANState.create(apply_fn=jgen.apply, params=gv["params"], batch_stats=gv["batch_stats"],
                                  tx=optax.adam(1e-3))
        ds = JT.SRGANState.create(apply_fn=jdisc.apply, params=dv["params"], batch_stats=dv["batch_stats"],
                                  tx=optax.adam(2e-3))
        gs, jpre = JT.make_pretrain_step(pixel_loss)(gs, jnp.asarray(lr), jnp.asarray(hr))
        g_mid = jax.device_get({"params": gs.params, "batch_stats": gs.batch_stats})
        mu_mid = _jax_moments(gs, g_convert)
        gs, ds, jg, jd = JT.make_gan_step(adv_weight=0.1, pixel_loss=pixel_loss)(gs, ds, jnp.asarray(lr),
                                                                                 jnp.asarray(hr))
        g_end = jax.device_get({"params": gs.params, "batch_stats": gs.batch_stats})
        d_end = jax.device_get({"params": ds.params, "batch_stats": ds.batch_stats})
        mu_g, mu_d = _jax_moments(gs, g_convert), _jax_moments(ds, from_jax.srgan_discriminator_state_dict)
    gen, disc = _port_gen(gv).double(), _port_disc(dv).double()
    g0, d0 = {k: v.clone() for k, v in gen.state_dict().items()}, {k: v.clone() for k, v in disc.state_dict().items()}
    pgs, pds = PT.create_srgan_states(gen, disc, 1e-3, 2e-3)
    lr_t, hr_t = torch.from_numpy(lr), torch.from_numpy(hr)
    _, pre = PT.make_pretrain_step(pixel_loss)(pgs, lr_t, hr_t)
    np.testing.assert_allclose(pre.item(), float(jpre), rtol=1e-6)
    want_mid = from_jax.srgan_generator_state_dict(g_mid, G_KW["num_blocks"])
    g_names = [k for k, _ in gen.named_parameters()]
    _close_params(gen.state_dict(), want_mid, g0, g_names, "pretrain G")
    _close_stats(gen.state_dict(), want_mid)
    _close_moments(_port_moments(pgs), mu_mid, g_names, "pretrain G")
    assert all(torch.equal(v, d0[k]) for k, v in disc.state_dict().items())  # D untouched by pretraining
    g_mid_sd = {k: v.clone() for k, v in gen.state_dict().items()}
    _, _, g_loss, d_loss = PT.make_gan_step(adv_weight=0.1, pixel_loss=pixel_loss)(pgs, pds, lr_t, hr_t)
    np.testing.assert_allclose([g_loss.item(), d_loss.item()], [float(jg), float(jd)], rtol=1e-6)
    want_g = from_jax.srgan_generator_state_dict(g_end, G_KW["num_blocks"])
    want_d = from_jax.srgan_discriminator_state_dict(d_end)
    _close_params(gen.state_dict(), want_g, g_mid_sd, g_names, "gan G")
    _close_params(disc.state_dict(), want_d, d0, [k for k, _ in disc.named_parameters()], "gan D")
    _close_stats(gen.state_dict(), want_g)
    _close_stats(disc.state_dict(), want_d)
    _close_moments(_port_moments(pgs), mu_g, g_names, "gan G")
    _close_moments(_port_moments(pds), mu_d, [k for k, _ in disc.named_parameters()], "gan D")
    assert (pgs.step, pds.step) == (2, 1)
    tracked = [v.item() for k, v in disc.state_dict().items() if k.endswith("num_batches_tracked")]
    assert tracked and set(tracked) == {2}  # real and fake; the G update's forward left no trace


def test_gan_step_with_d_statistics_left_updated_breaks_the_comparison(monkeypatch):
    """The G update's D forward must not move D's statistics: without the
    restore, D's buffers differ from JAX's by far more than the bound."""
    lr, hr = _step_inputs(seed=10)
    with jax.enable_x64(True):
        jgen = JM.Generator(**G_KW, train=True, dtype=jnp.float64)
        jdisc = JM.Discriminator(features=D_FEATURES, train=True, dtype=jnp.float64)
        gv, dv = _jax_vars(jgen, lr.shape[1:3], 11, np.float64), _jax_vars(jdisc, hr.shape[1:3], 12, np.float64)
        gs = JT.SRGANState.create(apply_fn=jgen.apply, params=gv["params"], batch_stats=gv["batch_stats"],
                                  tx=optax.adam(1e-3))
        ds = JT.SRGANState.create(apply_fn=jdisc.apply, params=dv["params"], batch_stats=dv["batch_stats"],
                                  tx=optax.adam(1e-3))
        _, ds, _, _ = JT.make_gan_step()(gs, ds, jnp.asarray(lr), jnp.asarray(hr))
        want_d = from_jax.srgan_discriminator_state_dict(jax.device_get(
            {"params": ds.params, "batch_stats": ds.batch_stats}))
    monkeypatch.setattr(PT, "frozen_statistics", lambda module: contextlib.nullcontext())
    pgs, pds = PT.create_srgan_states(_port_gen(gv).double(), _port_disc(dv).double())
    PT.make_gan_step()(pgs, pds, torch.from_numpy(lr), torch.from_numpy(hr))
    with pytest.raises(AssertionError):
        _close_stats(pds.model.state_dict(), want_d)


FROZEN = PT.frozen_statistics


@contextlib.contextmanager
def _adversarial_term_detached(module):
    """A planted fault: the G update's D forward sees G's output detached, so
    the adversarial term adds nothing to G's gradient."""
    hook = module.register_forward_pre_hook(lambda m, args: (args[0].detach(),))
    try:
        with FROZEN(module):
            yield
    finally:
        hook.remove()


def test_gan_step_with_the_adversarial_term_detached_breaks_the_moments(monkeypatch):
    """A gradient fault at the default adv_weight (1e-3): with the
    adversarial term detached from G's update, G's first moments after the
    GAN step must break their limit."""
    lr, hr = _step_inputs(seed=13)
    g_convert = lambda v: from_jax.srgan_generator_state_dict(v, G_KW["num_blocks"])  # noqa: E731
    with jax.enable_x64(True):
        jgen = JM.Generator(**G_KW, train=True, dtype=jnp.float64)
        jdisc = JM.Discriminator(features=D_FEATURES, train=True, dtype=jnp.float64)
        gv, dv = _jax_vars(jgen, lr.shape[1:3], 14, np.float64), _jax_vars(jdisc, hr.shape[1:3], 15, np.float64)
        gs = JT.SRGANState.create(apply_fn=jgen.apply, params=gv["params"], batch_stats=gv["batch_stats"],
                                  tx=optax.adam(1e-3))
        ds = JT.SRGANState.create(apply_fn=jdisc.apply, params=dv["params"], batch_stats=dv["batch_stats"],
                                  tx=optax.adam(1e-3))
        gs, _, _, _ = JT.make_gan_step()(gs, ds, jnp.asarray(lr), jnp.asarray(hr))
        mu_g = _jax_moments(gs, g_convert)
    g_names = [k for k, _ in PMod.Generator(3, **G_KW).named_parameters()]

    def g_moments():
        pgs, pds = PT.create_srgan_states(_port_gen(gv).double(), _port_disc(dv).double(), 1e-3, 1e-3)
        PT.make_gan_step()(pgs, pds, torch.from_numpy(lr), torch.from_numpy(hr))
        return _port_moments(pgs)

    _close_moments(g_moments(), mu_g, g_names, "gan G")
    monkeypatch.setattr(PT, "frozen_statistics", _adversarial_term_detached)
    with pytest.raises(AssertionError):
        _close_moments(g_moments(), mu_g, g_names, "gan G with the adversarial term detached")


def test_steps_refuse_a_mesh_and_an_unknown_pixel_loss():
    """A mesh that is not the port's ("data",) DeviceMesh is refused by name
    (data parallelism itself: tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="DeviceMesh"):
        PT.make_gan_step(mesh=object())
    with pytest.raises(ValueError, match="pixel_loss"):
        PT.make_pretrain_step("l3")


# --- the loop, the CLI ---

class FakeImages:
    def __init__(self, n=8, hw=(18, 18)):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.RandomState(i).randint(0, 255, self.hw + (3,), dtype=np.uint8)


def _cfg(out, **training):
    return SRGANTrainConfig(srgan=dict(num_channels=8, num_blocks=1, upscale_factor=2),
                            training=dict(dict(device="cpu", epochs=2, pretrain_epochs=1, batch_size=4, hr_crop=16,
                                               log_interval=1, save_interval=10), **training),
                            folders=dict(output=str(out)))


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_loop_runs_both_phases(tmp_path):
    """max_steps=4 with 2 steps an epoch: a pretrain epoch then a GAN epoch (as
    tests/test_loops.py's JAX run); the epoch it stops in is saved."""
    gs, ds = loop_srgan.train(_cfg(tmp_path), max_steps=4, dataset=FakeImages())
    assert (gs.step, ds.step, gs.epoch) == (4, 2, 2)
    recs = [r for r in _records(tmp_path / "0") if "train/g_loss" in r]
    assert [r["phase"] for r in recs] == ["pretrain"] * 2 + ["gan"] * 2
    assert all("train/d_loss" in r for r in recs[2:]) and not any("train/d_loss" in r for r in recs[:2])
    assert all(np.isfinite(r["train/g_loss"]) for r in recs)
    assert CheckpointManager(str(tmp_path / "0" / "checkpoints")).all_steps() == [2]


def test_loop_resumes_at_the_phase_boundary(tmp_path):
    """A run of the pretrain epoch alone, then a resume from its checkpoint
    directory into the GAN phase; the checkpoint restores equal."""
    gs, ds = loop_srgan.train(_cfg(tmp_path, epochs=1, save_interval=1), dataset=FakeImages())
    ckdir = str(tmp_path / "0" / "checkpoints")
    assert (gs.step, ds.step, gs.epoch) == (2, 0, 1)
    saved = CheckpointManager(ckdir).restore(step=1)
    assert all(torch.equal(saved["model"][k], v) for k, v in gs.model.state_dict().items())
    assert all(torch.equal(saved["disc"][k], v) for k, v in ds.model.state_dict().items())
    gs2, ds2 = loop_srgan.train(_cfg(tmp_path, resume_training=True, resume_checkpoint=ckdir), dataset=FakeImages())
    assert (gs2.step, ds2.step, gs2.epoch) == (4, 2, 2)
    assert {r["phase"] for r in _records(tmp_path / "1") if "train/g_loss" in r} == {"gan"}


def test_loop_cut_short_in_an_epoch_resumes_that_epoch(tmp_path):
    """max_steps=1 stops inside the (last) pretrain epoch: its checkpoint holds
    the epoch counter at 0, so a resume runs the pretrain epoch again, then
    the GAN epoch, where counting the cut epoch as done would skip to GAN."""
    gs, ds = loop_srgan.train(_cfg(tmp_path, save_interval=1), max_steps=1, dataset=FakeImages())
    ckdir = str(tmp_path / "0" / "checkpoints")
    assert (gs.step, ds.step, gs.epoch) == (1, 0, 0)
    assert CheckpointManager(ckdir).restore()["epoch"] == 0
    gs2, ds2 = loop_srgan.train(_cfg(tmp_path, resume_training=True, resume_checkpoint=ckdir), dataset=FakeImages())
    assert (gs2.step, ds2.step, gs2.epoch) == (5, 2, 2)
    recs = [r for r in _records(tmp_path / "1") if "train/g_loss" in r]
    assert [r["phase"] for r in recs] == ["pretrain"] * 2 + ["gan"] * 2


def test_loop_f32_run_on_cuda_trains_without_tf32(tmp_path, monkeypatch):
    """An f32 run as on the card (`dtype` None, the loop's `f32_arithmetic`
    called with "cuda") takes its steps with cuDNN's TF32 off and matmuls at
    "highest", as loop_diffusion does, and the settings come back after."""
    real = precision.f32_arithmetic
    monkeypatch.setattr(loop_srgan, "f32_arithmetic", lambda device: real("cuda"))
    seen = []
    for name in ("make_pretrain_step", "make_gan_step"):
        def spy_make(*args, _make=getattr(loop_srgan, name), **kwargs):
            step = _make(*args, **kwargs)

            def spy(*step_args):
                seen.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
                return step(*step_args)
            return spy
        monkeypatch.setattr(loop_srgan, name, spy_make)
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True  # torch's default, which an f32 run must turn off
    torch.set_float32_matmul_precision("high")
    try:
        loop_srgan.train(_cfg(tmp_path), max_steps=1, dataset=FakeImages())
        assert seen == [(False, "highest")]
        assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == (True, "high")
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_train_srgan_cli_on_the_cpu_into_super_resolve_and_translate(tmp_path):
    """train-srgan --device cpu on an image tree, then its run's checkpoints
    into super-resolve (a PNG at twice the size) and into translate's SRGAN
    loader (the trained generator's weights)."""
    for i in range(4):
        path = tmp_path / "data" / "ACDC" / "rgb_anon" / "fog" / "train" / f"{i}.png"
        os.makedirs(path.parent, exist_ok=True)
        Image.fromarray(np.random.default_rng(i).integers(0, 256, (20, 40, 3), dtype=np.uint8)).save(path)
    cfg = tmp_path / "s.yaml"
    cfg.write_text("srgan: {num_channels: 8, num_blocks: 1, upscale_factor: 2}\n"
                   "data: {weather: [fog]}\n"
                   "training: {epochs: 2, pretrain_epochs: 1, batch_size: 2, hr_crop: 16, log_interval: 1}\n")
    out = tmp_path / "out"
    assert PM.main(["train-srgan", "--config", str(cfg), "--max-steps", "3", "--device", "cpu", "--set",
                    f"data.root_dir={tmp_path / 'data'}", f"folders.output={out}"]) == 0
    ckdir = out / "0" / "checkpoints"
    saved = CheckpointManager(str(ckdir)).restore()
    assert saved["step"] == 3 and saved["disc_step"] == 1
    Image.fromarray(np.random.default_rng(9).integers(0, 256, (12, 10, 3), dtype=np.uint8)).save(tmp_path / "in.png")
    png = tmp_path / "sr.png"
    assert PM.main(["super-resolve", "--config", str(cfg), "--image", str(tmp_path / "in.png"), "--checkpoint",
                    str(ckdir), "--out", str(png), "--device", "cpu"]) == 0
    assert Image.open(png).size == (20, 24)
    tcfg = load_translation_config(None, srgan=dict(num_channels=8, num_blocks=1, upscale_factor=2))
    loaded = PC.load_srgan(tcfg.srgan, str(ckdir), seed=5).state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in saved["model"].items())
