"""The PyTorch port's DDPM training slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both; where JAX draws
from a key (timesteps, noise, crop offsets, flips), the test derives JAX's
draws from that key and hands them to the port. JAX's flash attention runs
in interpret mode, as the JAX suite runs it; the port runs its plain
versions, which its CUDA kernels are held to on the card
(tests/test_torch_kernels.py). Everything is f32; each tolerance is stated
where it is used.
"""

import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import TINY_UNET, tiny_unet_pair

from weatherconverter_tpu.core import config as JC
from weatherconverter_tpu.data import transforms as JTF
from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.training import diffusion as JD
from weatherconverter_tpu.training import losses as JL
from weatherconverter_tpu.training import optim as JO
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core import config as PC
from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager, restore_auto
from weatherconverter_tpu_torch.data import transforms as PTF
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.models.unet import Unet
from weatherconverter_tpu_torch.training import diffusion as PD
from weatherconverter_tpu_torch.training import losses as PL
from weatherconverter_tpu_torch.training import optim as PO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_STEPS = 1000


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(port, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(port, dtype=np.float32), np.asarray(ref, dtype=np.float32),
                               rtol=rtol, atol=atol)


def _jax_draws(key, shape):
    """The (t, noise) that JAX's ddpm_loss_fn draws from `key`
    (training/diffusion.py:74-77)."""
    tkey, nkey = jax.random.split(key)
    t = jax.random.randint(tkey, (shape[0],), 0, T_STEPS)
    noise = jax.random.normal(nkey, shape, dtype=jnp.float32)
    return torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise))


def _grads_by_name(model):
    return {n: p.grad for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# losses, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mse_loss_matches_jax(dtype):
    """f32 in both, whatever the inputs' dtype: the same sum in another order."""
    pred, target = _rand((2, 3, 8, 8), 0), _rand((2, 3, 8, 8), 1)
    ref = JL.mse_loss(jnp.asarray(pred, getattr(jnp, dtype)), jnp.asarray(target))
    port = PL.mse_loss(torch.from_numpy(pred).to(getattr(torch, dtype)), torch.from_numpy(target))
    assert port.dtype == torch.float32
    _close(port, ref, rtol=1e-6, atol=0)


def test_adam_matches_optax_over_three_steps():
    """Three updates from the same gradients. Adam's first step is
    +-lr * sign(g), so an atol of lr/100 catches a sign or bias-correction
    error; f32 rounding in the moments stays far below it."""
    lr = 1e-3
    shapes = {"w": (4, 5), "b": (5,)}
    params = {k: _rand(s, i) for i, (k, s) in enumerate(shapes.items())}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tx = JO.adam(lr)
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = PO.adam(tparams.values(), lr)
    for step in range(3):
        grads = {k: _rand(s, 10 * step + i, -3, 3) for i, (k, s) in enumerate(shapes.items())}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            _close(tparams[k].detach(), jparams[k], rtol=0, atol=lr / 100)
    _close(PO.global_norm(p.detach() for p in tparams.values()), JO.global_norm(jparams), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------


def test_diffusion_train_augment_replays_jax_draws():
    """JAX's crop offsets and flips (data/transforms.py:76-78, 100, 248)
    replayed in the port: the same uint8 values through the same f32
    arithmetic, so the outputs agree to the last bit."""
    b, h, w, crop = 6, 20, 36, 16
    images = np.random.default_rng(0).integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    ref = JTF.diffusion_train_augment(key, jnp.asarray(images), crop=crop)
    kc, kf = jax.random.split(key)
    ky, kx = jax.random.split(kc)
    ys = jax.random.randint(ky, (b,), 0, h - crop + 1)
    xs = jax.random.randint(kx, (b,), 0, w - crop + 1)
    flip = jax.random.uniform(kf, (b,)) < 0.5
    assert 0 < int(flip.sum()) < b  # both branches are exercised
    port = PTF.diffusion_train_augment(torch.from_numpy(images), crop=crop,
                                       offsets=(torch.tensor(np.asarray(ys)), torch.tensor(np.asarray(xs))),
                                       flip=torch.tensor(np.asarray(flip)))
    _close(port, ref, rtol=0, atol=0)
    drawn = PTF.diffusion_train_augment(torch.from_numpy(images), torch.Generator().manual_seed(0), crop)
    assert drawn.shape == (b, crop, crop, 3) and drawn.min() >= -1 and drawn.max() <= 1
    with pytest.raises(ValueError, match="exceeds"):
        PTF.random_crop(torch.from_numpy(images), (h + 1, crop))


# ---------------------------------------------------------------------------
# the DDPM loss and the train step, tiny UNet (flash attention at N = 1024)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    junet, params, port = tiny_unet_pair()
    return junet, params, port


def _port_twin(tiny):
    junet, params, _ = tiny
    model = Unet(PC.UnetModelConfig(**TINY_UNET))
    model.load_state_dict(from_jax.unet_state_dict(params, PC.UnetModelConfig(**TINY_UNET)), strict=True)
    return model


def _jax_tree_as_torch(tree):
    return from_jax.unet_state_dict(jax.tree_util.tree_map(np.asarray, tree), PC.UnetModelConfig(**TINY_UNET))


# Gradients of a 2-image f32 loss through ~40 layers, attention included:
# per tensor, |port - jax| <= 2e-4 * max |jax| (sums in another order; the
# largest tensors carry a few 1e-5 of relative drift)
GRAD_TOL = 2e-4


def _close_per_tensor(port: dict, ref: dict, tol: float):
    assert port.keys() == ref.keys()
    for name in ref:
        r = ref[name].numpy()
        _close(port[name].detach(), r, rtol=tol, atol=tol * float(np.abs(r).max()))


def test_ddpm_loss_and_grads_match_jax(tiny):
    junet, params, _ = tiny
    model = _port_twin(tiny)
    images = _rand((2, 32, 32, 3), 5)
    key = jax.random.PRNGKey(7)
    jsched = JS.linear_schedule(T_STEPS)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(lambda p, x, k: JD.ddpm_loss_fn(p, junet.apply, jsched, x, k)))(
        params, jnp.asarray(images), key)
    t, noise = _jax_draws(key, images.shape)
    loss = PD.ddpm_loss_fn(model, PS.linear_schedule(T_STEPS), torch.from_numpy(images), t=t, noise=noise)
    loss.backward()
    _close(loss.detach(), loss_ref, rtol=1e-5, atol=0)
    _close_per_tensor(_grads_by_name(model), _jax_tree_as_torch(grads_ref), GRAD_TOL)
    eval_loss = PD.make_eval_loss(PS.linear_schedule(T_STEPS), model)(torch.from_numpy(images), t=t, noise=noise)
    assert not eval_loss.requires_grad
    torch.testing.assert_close(eval_loss, loss.detach(), rtol=0, atol=0)


def test_train_step_with_accumulation_matches_jax(tiny):
    """accum_steps=2: the mean of the two microbatch gradients, then one
    Adam update and one EMA update. lr 1e-3 makes Adam's first step
    +-1e-3 * sign(g) wherever |g| >> eps, so holding those elements to
    lr/100 catches a sign error."""
    junet, params, _ = tiny
    lr, decay = 1e-3, 0.5
    images = _rand((4, 32, 32, 3), 6)
    key = jax.random.PRNGKey(8)
    jsched = JS.linear_schedule(T_STEPS)
    jstate = JD.DDPMTrainState.create(apply_fn=junet.apply, params=params, tx=JO.adam(lr),
                                      ema=JD.EMA.create(params, decay=decay))
    jstate, loss_ref = jax.jit(lambda s, x, k: JD.train_step(s, x, k, jsched, accum_steps=2))(
        jstate, jnp.asarray(images), key)
    draws = [_jax_draws(k, (2, 32, 32, 3)) for k in jax.random.split(key, 2)]
    t, noise = torch.cat([d[0] for d in draws]), torch.cat([d[1] for d in draws])

    state = PD.create_ddpm_state(_port_twin(tiny), lr=lr, ema_decay=decay)
    step = PD.make_train_step(PS.linear_schedule(T_STEPS), accum_steps=2)
    state, loss = step(state, torch.from_numpy(images), t=t, noise=noise)
    assert state.step == 1
    _close(loss, loss_ref, rtol=1e-5, atol=0)
    # Adam's first update is -lr * g / (|g| + eps): where |g| is within ten
    # eps of 0 its size hangs on g's last bits, so those few elements are
    # only held to the update's bound. The EMA moves (1 - decay) of it.
    start = _jax_tree_as_torch(params)
    for tree, got, bound in ((jstate.params, dict(state.model.named_parameters()), lr),
                             (jstate.ema.params, state.ema.params, (1 - decay) * lr)):
        firm_total = 0.0
        for name, ref in _jax_tree_as_torch(tree).items():
            step_ref, step_got = (ref - start[name]).numpy(), (got[name].detach() - start[name]).numpy()
            firm = np.abs(step_ref) >= 0.9 * bound
            firm_total += firm.mean() / len(start)
            _close(step_got[firm], step_ref[firm], rtol=0, atol=bound / 100)
            _close(step_got, step_ref, rtol=0, atol=bound)
        assert firm_total > 0.98


def test_ema_is_an_unaliased_f32_shadow_updated_after_the_step(tiny):
    model = _port_twin(tiny)
    state = PD.create_ddpm_state(model, lr=1e-3, ema_decay=0.9)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for name, p in model.named_parameters():
        e = state.ema.params[name]
        assert e.dtype == torch.float32 and e.data_ptr() != p.data_ptr()
        torch.testing.assert_close(e, p.detach(), rtol=0, atol=0)
    step = PD.make_train_step(PS.linear_schedule(T_STEPS))
    step(state, torch.from_numpy(_rand((2, 32, 32, 3), 9)), torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        want = before[name] * 0.9 + p.detach() * (1 - 0.9)
        torch.testing.assert_close(state.ema.params[name], want, rtol=1e-6, atol=1e-7)
        assert not torch.equal(p.detach(), before[name])


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(fsdp=True)])
def test_parallel_training_is_not_ported_yet(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        PD.make_train_step(PS.linear_schedule(4), **kw)


# ---------------------------------------------------------------------------
# config, checkpoints, the loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", [None, "configs/diffusion.yaml"])
def test_load_diffusion_config_matches_jax(path):
    path = path and os.path.join(REPO, path)
    assert PC.load_diffusion_config(path).model_dump() == JC.load_diffusion_config(path).model_dump()


def test_checkpoint_round_trip_restores_the_train_state(tmp_path, tiny):
    state = PD.create_ddpm_state(_port_twin(tiny), lr=1e-3, ema_decay=0.9)
    PD.make_train_step(PS.linear_schedule(T_STEPS))(state, torch.from_numpy(_rand((2, 32, 32, 3), 10)),
                                                    torch.Generator().manual_seed(1))
    state.epoch = 4
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    fresh = PD.create_ddpm_state(Unet(PC.UnetModelConfig(**TINY_UNET)), lr=1e-3, ema_decay=0.9)
    restored = restore_auto(str(tmp_path / "ckpt"), fresh)
    assert (restored.step, restored.epoch) == (1, 4)
    saved, loaded = state.state_dict(), restored.state_dict()
    for part in ("model",):
        for name, value in saved[part].items():
            torch.testing.assert_close(loaded[part][name], value, rtol=0, atol=0)
    for name, value in saved["ema"]["params"].items():
        torch.testing.assert_close(loaded["ema"]["params"][name], value, rtol=0, atol=0)
    for pid, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(loaded["optimizer"]["state"][pid][k], v, rtol=0, atol=0)


LOOP_MODEL = {
    "im_size": 16, "down_channels": [8, 16, 24], "mid_channels": [24, 24, 16], "down_sample": [True, False],
    "time_emb_dim": 16, "num_down_layers": 1, "num_mid_layers": 1, "num_up_layers": 1, "num_heads": 2,
    "attn_resolutions": [8],
}


class FakeImages:
    """uint8 (16, 28, 3) images from a seed, the shape the loader ships."""

    def __init__(self, n=6, hw=(16, 28)):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.RandomState(i).randint(0, 255, self.hw + (3,), dtype=np.uint8)


def _loop_cfg(tmp_path, **training):
    return PC.DiffusionConfig(model=LOOP_MODEL, diffusion={"num_timesteps": 20},
                              training={"batch_size": 2, "log_interval": 1, "save_interval": 1, "device": "cpu",
                                        **training},
                              folders={"output": str(tmp_path / "out")})


def _logged_steps(run_dir):
    import json

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["_step"] for r in map(json.loads, f) if "train/loss" in r]


def test_train_loop_three_steps_then_resume_continues_the_step_count(tmp_path):
    """6 images at batch 2: one epoch is 3 steps and saves checkpoint 1. A
    resumed run restores step 3 and epoch 1 and runs the second epoch as
    steps 4-6."""
    from weatherconverter_tpu_torch.training import loop_diffusion

    state = loop_diffusion.train(_loop_cfg(tmp_path, epochs=1), dataset=FakeImages())
    assert (state.step, state.epoch) == (3, 1)
    run0 = tmp_path / "out" / "0"
    assert _logged_steps(run0) == [1, 2, 3]
    assert CheckpointManager(str(run0 / "checkpoints")).latest_step() == 1
    cfg = _loop_cfg(tmp_path, epochs=2, resume_training=True, resume_checkpoint=str(run0 / "checkpoints"))
    resumed = loop_diffusion.train(cfg, dataset=FakeImages())
    assert (resumed.step, resumed.epoch) == (6, 2)
    assert _logged_steps(tmp_path / "out" / "1") == [4, 5, 6]
    moved = sum((e - p.detach()).abs().sum().item()
                for e, p in zip(resumed.ema.params.values(), resumed.model.parameters()))
    assert moved > 0.0  # the EMA is a shadow, not the live parameters


class PreemptedImages(FakeImages):
    """Delivers SIGTERM while the loader builds the second batch, by calling
    the handler the loop installed (as the signal would, without the risk of
    the default action if none were installed)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __getitem__(self, i):
        self.calls += 1
        if self.calls == 3:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler), handler
            handler(signal.SIGTERM, None)
        return super().__getitem__(i)


def test_sigterm_flushes_a_checkpoint_and_resume_restarts_the_epoch(tmp_path):
    """The loop finishes the step in flight, saves the post-step state and
    returns; a resume restores step 2 and epoch 0 and reruns epoch 0."""
    from weatherconverter_tpu_torch.training import loop_diffusion

    before = signal.getsignal(signal.SIGTERM)
    state = loop_diffusion.train(_loop_cfg(tmp_path, epochs=1), dataset=PreemptedImages())
    assert (state.step, state.epoch) == (2, 0)
    assert signal.getsignal(signal.SIGTERM) == before  # the guard put the old handler back
    ckpts = str(tmp_path / "out" / "0" / "checkpoints")
    assert CheckpointManager(ckpts).latest_step() == 2
    cfg = _loop_cfg(tmp_path, epochs=1, resume_training=True, resume_checkpoint=ckpts)
    resumed = loop_diffusion.train(cfg, dataset=FakeImages())
    assert (resumed.step, resumed.epoch) == (5, 1)


def test_train_without_images_raises(tmp_path):
    cfg = _loop_cfg(tmp_path, epochs=1)
    cfg.data.root_dir = str(tmp_path / "no_data")
    with pytest.raises(FileNotFoundError, match="dataset is empty"):
        from weatherconverter_tpu_torch.training import loop_diffusion

        loop_diffusion.train(cfg)


def test_train_device_auto_raises_without_a_card(tmp_path, monkeypatch):
    """`training.device="auto"` (the default) is the CUDA card: without one
    the loop raises and names the explicit CPU request; it never falls back."""
    from weatherconverter_tpu_torch.training import loop_diffusion

    assert PC.DiffusionConfig().training.device == "auto"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='training.device="cpu"'):
        loop_diffusion.train(_loop_cfg(tmp_path, epochs=1, device="auto"), dataset=FakeImages())
    assert not (tmp_path / "out").exists()  # raised before a run directory was made
    assert loop_diffusion._device("cpu") == torch.device("cpu")


def _write_png_tree(root):
    """A synthetic ACDC-style tree plus a BDD-style one: PNGs and a JPEG of
    several sizes (wide, tall, near-square), and a file the glob must skip."""
    from PIL import Image

    rng = np.random.default_rng(0)
    sizes = {"rain/train/a/x1.png": (40, 71), "rain/train/a/x0.png": (33, 90), "rain/val/b.png": (64, 48),
             "fog/train/c/d/e.png": (30, 31), "fog/test/f.jpg": (50, 120), "night/train/g.png": (20, 20),
             "snow/train/skipped.png": (20, 40)}
    for rel, (h, w) in sizes.items():
        path = os.path.join(root, "rgb_anon", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
    with open(os.path.join(root, "rgb_anon", "rain", "train", "notes.txt"), "w") as f:
        f.write("not an image")
    for rel in ("rain/r.png", "fog/deep/s.png"):
        path = os.path.join(root, "bdd", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (24, 60, 3), dtype=np.uint8)).save(path)


def test_diffusion_image_dataset_matches_jax(tmp_path):
    """The port's DiffusionImageDataset against the JAX package's on one
    synthetic tree: the same length, the same paths in the same order, and
    the same uint8 arrays (against the JAX class's PIL path, bit for bit;
    its optional C++ decoder, where built, within one grey level)."""
    from weatherconverter_tpu.data import datasets as JDS
    from weatherconverter_tpu_torch.data import datasets as PDS

    _write_png_tree(str(tmp_path))
    root = str(tmp_path / "rgb_anon")
    ref, port = JDS.DiffusionImageDataset(root, resize_to=16), PDS.DiffusionImageDataset(root, resize_to=16)
    for ds in (ref, port):
        ds.add_images(str(tmp_path / "bdd"))
    assert len(port) == len(ref) == 8
    assert port.img_paths == ref.img_paths and port.out_wh == ref.out_wh == (16, 28)
    for i in range(len(ref)):
        got = port[i]
        assert got.dtype == np.uint8 and got.shape == (16, 28, 3)
        np.testing.assert_array_equal(got, JDS.load_image_resized(ref.img_paths[i], 16, ref.out_wh))
        assert np.abs(got.astype(np.int16) - ref[i].astype(np.int16)).max() <= 1
    np.testing.assert_array_equal(PDS.load_image_resized(ref.img_paths[0], 16),
                                  JDS.load_image_resized(ref.img_paths[0], 16))
    cfg = _loop_cfg(tmp_path, epochs=1)
    cfg.data.root_dir, cfg.data.acdc_images, cfg.data.bdd_dir, cfg.data.dawn_dir = str(tmp_path), "rgb_anon", "bdd", ""
    cfg.data.weather = ["rain", "fog", "night"]
    cfg.model.im_size = 16
    from weatherconverter_tpu_torch.training import loop_diffusion

    built = loop_diffusion.build_dataset(cfg)
    assert isinstance(built, PDS.DiffusionImageDataset) and built.img_paths == port.img_paths


def test_train_with_a_dataset_imports_neither_pil_nor_jax(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from weatherconverter_tpu_torch.core.config import DiffusionConfig\n"
        "from weatherconverter_tpu_torch.training import loop_diffusion\n"
        "class D:\n"
        "    def __len__(self): return 2\n"
        "    def __getitem__(self, i): return np.zeros((16, 28, 3), np.uint8)\n"
        f"cfg = DiffusionConfig(model={LOOP_MODEL!r}, diffusion={{'num_timesteps': 20}},\n"
        "    training={'batch_size': 2, 'epochs': 1, 'device': 'cpu'}, folders={'output': sys.argv[1]})\n"
        "assert loop_diffusion.train(cfg, dataset=D()).step == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'jax', 'flax'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
