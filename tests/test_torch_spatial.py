"""Spatial sharding in the port (weatherconverter_tpu_torch/parallel/spatial.py
and `sample_with_sgg(spatial_mesh=...)`) against the JAX package's
unsharded functions, on the CPU.

As in tests/test_torch_parallel.py, the fixture `sp` writes the inputs
(numpy from seeds over JAX's parameter shapes, carried across by
compat/from_jax), starts this file as `__main__` twice, rank 0 and rank 1
of a gloo group over a (data=1, space=2) mesh (the ranks import no JAX), and
while they run computes JAX's unsharded references: `seg.apply` and
`seg_input_gradients` of DeepLabV3 and DeepLabV3+ on ResNet-18 at 64 px, and
the 4-step guided chain of tests/test_parallel_spatial.py (its tiny UNet and
2x SRGAN, DeepLabV3/ResNet-18 at 32 px) under GSG and `alternate`, whose
jax.random draws the ranks replay through `noise=`. JAX's 8-device sharded
jit is not run again here.

Tolerances are JAX's own (tests/test_parallel_spatial.py): 2e-4 for the
forward and the translation, 1e-3 absolute / 5e-3 relative for the input
gradient. The seg functions of both sides add one fixed dither to their
input (the SRGAN output saturates at exactly 1.0, and XLA and ATen break
max-pool ties differently). The planted faults (a per-shard valid-pixel
count, a halo of zeros, a halo from the rank above only) must break the
gradient's bound.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
B, HW, C = 2, 64, 5
SEG_NAMES = ("deeplabv3_resnet18", "deeplabv3plus_resnet18")
# the chain of tests/test_parallel_spatial.py:60-102
H, SR, STEPS, START_T, LAM = 16, 2, 4, 3, 10.0
HR = H * SR
TR_SEG = "deeplabv3_resnet18"
STYLES = ("gsg", "alternate")
UNET = dict(im_size=H, down_channels=[8, 16, 24], mid_channels=[24, 24, 16], down_sample=[True, False],
            time_emb_dim=16, num_down_layers=1, num_mid_layers=1, num_up_layers=1, num_heads=2, attn_resolutions=[8])
G_KW = dict(num_channels=8, num_blocks=1, upscale_factor=SR)
DITHER = 1e-2
FAULTS = ("shard_count", "zero_halo", "one_neighbour")
WORKER_TIMEOUT_S = 240


def _seg_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    gt = rng.integers(0, C, (B, HW, HW)).astype(np.int64)
    gt[:, :8, :8] = 255  # an ignored patch: the shards' valid counts differ
    return x, gt


def _translate_inputs():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, H, H, 3)) * 0.2).astype(np.float32)
    gt = rng.integers(0, C, (B, HR, HR)).astype(np.int64)
    gt[:, :4] = 255
    return x, gt


def _dither(hw):
    return (DITHER * np.random.default_rng(hw).standard_normal((1, hw, hw, 3))).astype(np.float32)


# ---------------------------------------------------------------------------
# the ranks (this file as __main__): torch and the port only
# ---------------------------------------------------------------------------


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _dithered(seg, hw):
    """seg(x + dither) in the model's dtype (the SRGAN's output is f32 even in
    f64), the dither cut to this rank's rows under a SpatialContext."""
    from weatherconverter_tpu_torch.parallel import spatial

    d = _nchw(_dither(hw))
    dtype = next(seg.parameters()).dtype

    def fn(x):
        ctx = spatial.current()
        return seg((x + (d if ctx is None else ctx.own_rows(d, 2))).to(dtype))

    return fn


def _seg_model(name, sd):
    from weatherconverter_tpu_torch.models.factory import make_seg_model

    seg = make_seg_model(name, num_classes=C)
    seg.load_state_dict(sd, strict=True)
    return seg.eval().requires_grad_(False)


def _sharded_seg(mesh, seg, x, gt):
    """(logits, input gradient) of the sharded seg model, each rank's rows gathered (NCHW)."""
    from weatherconverter_tpu_torch.guidance.sgg import seg_input_gradients
    from weatherconverter_tpu_torch.parallel.spatial import SpatialContext

    ctx = SpatialContext(mesh)
    with ctx:
        xs, gs = ctx.own_rows(x, 2), ctx.own_rows(gt, 1)
        out = seg(xs)
        grad = seg_input_gradients(seg, xs, gs)
    return ctx.gather_rows(out).numpy(), ctx.gather_rows(grad).numpy()


def _planted(fault):
    """A context manager planting `fault` in parallel.spatial."""
    import contextlib

    from weatherconverter_tpu_torch.parallel import spatial

    @contextlib.contextmanager
    def plant():
        saved = spatial._all_gather, spatial.SpatialContext.sum_over_space
        if fault == "shard_count":
            def sum_over_space(self, x, differentiable):
                return saved[1](self, x, differentiable) if differentiable else x
            spatial.SpatialContext.sum_over_space = sum_over_space
        else:
            def gather(x, group, width):
                parts = saved[0](x, group, width)
                me = torch.distributed.get_rank(group)
                return [p if q == me or (fault == "one_neighbour" and q < me) else torch.zeros_like(p)
                        for q, p in enumerate(parts)]
            spatial._all_gather = gather
        try:
            yield
        finally:
            spatial._all_gather, spatial.SpatialContext.sum_over_space = saved

    return plant()


def _translation(inp, mesh, style, dtype=torch.float32):
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.translate import sample_with_sgg
    from weatherconverter_tpu_torch.models.srgan import Generator
    from weatherconverter_tpu_torch.models.unet import Unet

    unet = Unet(UnetModelConfig(**UNET), fused=False)
    unet.load_state_dict(inp["unet"], strict=True)
    gen = Generator(**G_KW)
    gen.load_state_dict(inp["gen"], strict=True)
    unet, gen = unet.to(dtype), gen.to(dtype)
    seg = _dithered(_seg_model(TR_SEG, inp["tr_seg"]).to(dtype), HR)
    x, gt = torch.from_numpy(inp["translate"][0]).to(dtype), torch.from_numpy(inp["translate"][1])
    noise = tuple(torch.from_numpy(a).to(dtype) for a in inp["noise"][style])
    with torch.no_grad():
        return sample_with_sgg(unet.eval(), linear_schedule(20), seg, gen.eval(), x, gt, None, lam=LAM,
                               num_steps=STEPS, num_classes=C, mode="fixed", start_t=START_T,
                               guidance_style=style, spatial_mesh=mesh, noise=noise).numpy()


def _refusal(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no refusal"


def _refusals(inp, mesh):
    """The messages of what the spatial path refuses."""
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.translate import sample_with_sgg
    from weatherconverter_tpu_torch.models.factory import make_seg_model
    from weatherconverter_tpu_torch.models.srgan import Generator

    out = {}
    for name, hw in (("deeplabv3plus_mobilenet", 64), ("deeplabv3plus_xception", 96)):
        seg = make_seg_model(name, num_classes=C).eval().requires_grad_(False)
        x = torch.randn(1, 3, hw, hw, generator=torch.Generator().manual_seed(0))
        out[name] = _refusal(lambda: _sharded_seg(mesh, seg, x, torch.zeros(1, hw, hw, dtype=torch.long)))
    seg = _seg_model(TR_SEG, inp["tr_seg"])
    gen = Generator(**G_KW).eval()
    ident = lambda xt, t: torch.zeros_like(xt)  # noqa: E731
    for key, latent in (("height_pool", 15), ("height_stride", 12)):
        x, gt = torch.zeros(1, latent, latent, 3), torch.zeros(1, latent * SR, latent * SR, dtype=torch.long)
        out[key] = _refusal(lambda: sample_with_sgg(ident, linear_schedule(20), seg, gen, x, gt, None, lam=LAM,
                                                    num_steps=2, num_classes=C, start_t=1, guidance_style="gsg",
                                                    spatial_mesh=mesh))
    return out


def _hrnet(mesh):
    """HRNetV2-W32's sharded forward and input gradient beside the unsharded
    port's (the unsharded forward is held against JAX by tests/test_torch_seg_zoo.py)."""
    from weatherconverter_tpu_torch.guidance.sgg import seg_input_gradients
    from weatherconverter_tpu_torch.models.factory import make_seg_model

    with torch.random.fork_rng():
        torch.manual_seed(0)
        seg = make_seg_model("deeplabv3plus_hrnetv2_32", num_classes=C).eval().requires_grad_(False)
    x, gt = (torch.from_numpy(a) for a in _seg_inputs())
    x = x.permute(0, 3, 1, 2).contiguous()
    ref, gref = seg(x).numpy(), seg_input_gradients(seg, x, gt).numpy()
    out, grad = _sharded_seg(mesh, seg, x, gt)
    return dict(fwd=(out, ref), grad=(grad, gref))


def _worker(workdir: str) -> None:
    import torch.distributed as dist

    from weatherconverter_tpu_torch.parallel import make_spatial_mesh, maybe_initialize_distributed
    from weatherconverter_tpu_torch.parallel.distributed import is_primary

    torch.set_num_threads(1)
    assert maybe_initialize_distributed("cpu") and dist.get_backend() == "gloo"
    mesh = make_spatial_mesh(data=1, space=WORLD)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    x, gt = (torch.from_numpy(a) for a in inp["seg"])
    x = x.permute(0, 3, 1, 2).contiguous()
    out, times = {}, {}
    cases = [(f"seg_{n}", (lambda n: lambda: _sharded_seg(mesh, _dithered(_seg_model(n, inp[n]), HW), x, gt))(n))
             for n in SEG_NAMES]
    cases += [(f"fault_{f}", (lambda f: lambda: _with(_planted(f), lambda: _sharded_seg(
        mesh, _dithered(_seg_model(SEG_NAMES[1], inp[SEG_NAMES[1]]), HW), x, gt)))(f)) for f in FAULTS]
    f64 = torch.float64
    cases += [(f"translate_{s}", (lambda s: lambda: (_translation(inp, mesh, s), _translation(inp, mesh, s, f64),
                                                     _translation(inp, None, s, f64)))(s)) for s in STYLES]
    cases += [("translate_data2", lambda: _translation(inp, make_spatial_mesh(data=WORLD, space=1), "gsg", f64)),
              ("hrnet", lambda: _hrnet(mesh)), ("refusals", lambda: _refusals(inp, mesh))]
    for name, case in cases:
        t0 = time.perf_counter()
        out[name] = case()
        times[name] = round(time.perf_counter() - t0, 2)
    out["times"] = times
    out["jax_imported"] = [m for m in sys.modules if m in ("jax", "weatherconverter_tpu")
                           or m.startswith(("jax.", "weatherconverter_tpu."))]
    if is_primary():
        torch.save(out, os.path.join(workdir, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _with(cm, fn):
    with cm:
        return fn()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the test process: inputs, the ranks, JAX's references
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_side():
    """(the port's state dicts and inputs, the JAX references' thunk)."""
    import jax
    import jax.numpy as jnp
    from torch_parity import seeded_leaves

    from weatherconverter_tpu.core.config import UnetModelConfig as JUnetConfig
    from weatherconverter_tpu.models.factory import make_seg_model as j_make_seg_model
    from weatherconverter_tpu.models.srgan import Generator as JGenerator
    from weatherconverter_tpu.models.unet import Unet as JUnet
    from weatherconverter_tpu_torch.compat import from_jax
    from weatherconverter_tpu_torch.core.config import UnetModelConfig

    def leaves(module, args, seed):
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), seeded_leaves(shapes, seed))

    segs = {n: j_make_seg_model(n, num_classes=C) for n in SEG_NAMES}
    seg_vars = {n: leaves(m, (jnp.zeros((1, HW, HW, 3)),), 10 + i) for i, (n, m) in enumerate(segs.items())}
    junet = JUnet(config=JUnetConfig(**UNET), fused=False)
    uparams = leaves(junet, (jnp.zeros((1, H, H, 3)), jnp.zeros((1,), jnp.int32)), 1)["params"]
    jgen = JGenerator(**G_KW)
    gvars = leaves(jgen, (jnp.zeros((1, H, H, 3)),), 3)
    tr_seg = segs[TR_SEG]
    tr_vars = leaves(tr_seg, (jnp.zeros((1, HR, HR, 3)),), 2)
    keys = {s: jax.random.PRNGKey(5 + i) for i, s in enumerate(STYLES)}

    def draws(key):
        """The draws sample_with_sgg makes from `key`, in its split order (translate.py:171-177, 185, 189)."""
        key, _tkey, nkey = jax.random.split(key, 3)
        noise0 = jax.random.normal(nkey, (B, H, H, 3))
        zs = []
        for _ in range(STEPS):
            key, zkey = jax.random.split(key)
            zs.append(np.asarray(jax.random.normal(zkey, (B, H, H, 3))))
        return np.asarray(noise0), np.stack(zs)

    inp = dict(seg=_seg_inputs(), translate=_translate_inputs(), noise={s: draws(k) for s, k in keys.items()},
               unet=from_jax.unet_state_dict(uparams, UnetModelConfig(**UNET)),
               gen=from_jax.srgan_generator_state_dict(gvars, G_KW["num_blocks"]),
               tr_seg=from_jax.deeplab_state_dict(tr_vars, TR_SEG),
               **{n: from_jax.deeplab_state_dict(v, n) for n, v in seg_vars.items()})

    def references():
        from weatherconverter_tpu.diffusion.schedule import linear_schedule
        from weatherconverter_tpu.guidance.sgg import seg_input_gradients
        from weatherconverter_tpu.guidance.translate import sample_with_sgg

        ref = {}
        x, gt = inp["seg"][0], inp["seg"][1].astype(np.int32)
        for n, m in segs.items():
            v, d = seg_vars[n], _dither(HW)
            fn = lambda im, m=m, v=v, d=d: m.apply(v, im + d)  # noqa: E731
            ref[f"seg_{n}"] = (np.asarray(jax.jit(fn)(x)),
                               np.asarray(jax.jit(lambda im, fn=fn: seg_input_gradients(fn, im, gt))(x)))
        tx, tgt = inp["translate"][0], inp["translate"][1].astype(np.int32)
        d = _dither(HR)
        for s in STYLES:
            chain = lambda s=s: sample_with_sgg(  # noqa: E731
                lambda xt, tt: junet.apply({"params": uparams}, xt, tt), linear_schedule(20),
                lambda im: tr_seg.apply(tr_vars, im + d), lambda im: jgen.apply(gvars, im), tx, tgt, keys[s],
                lam=LAM, num_steps=STEPS, num_classes=C, mode="fixed", start_t=START_T, guidance_style=s)
            ref[f"translate_{s}"] = np.asarray(jax.jit(chain)())
        unguided = lambda: sample_with_sgg(  # noqa: E731
            lambda xt, tt: junet.apply({"params": uparams}, xt, tt), linear_schedule(20),
            lambda im: tr_seg.apply(tr_vars, im + d), lambda im: jgen.apply(gvars, im), tx, tgt, keys["gsg"],
            lam=LAM, num_steps=STEPS, num_classes=C, mode="fixed", start_t=START_T, guidance_style="none")
        ref["translate_none"] = np.asarray(jax.jit(unguided)())
        return ref

    return inp, references


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """(the ranks' results, JAX's references)."""
    workdir = str(tmp_path_factory.mktemp("spatial"))
    inp, references = _jax_side()
    torch.save(inp, os.path.join(workdir, "inputs.pt"))
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), workdir],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        ref = references()
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, f"ranks exited {codes}:\n" + "\n".join(log[-4000:] for log in logs)
    return torch.load(os.path.join(workdir, "results.pt"), weights_only=False), ref


def _nhwc(a):
    return np.asarray(a).transpose(0, 2, 3, 1)


def test_ranks_import_no_jax(sp):
    got, _ = sp
    assert got["jax_imported"] == []


@pytest.mark.parametrize("name", SEG_NAMES)
def test_sharded_seg_forward_matches_jax(sp, name):
    got, ref = sp
    np.testing.assert_allclose(_nhwc(got[f"seg_{name}"][0]), ref[f"seg_{name}"][0], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", SEG_NAMES)
def test_sharded_input_gradient_matches_jax(sp, name):
    got, ref = sp
    want = ref[f"seg_{name}"][1]
    assert np.abs(want).max() > 1e-2  # the bound below is not met by a gradient of ~0
    np.testing.assert_allclose(_nhwc(got[f"seg_{name}"][1]), want, atol=1e-3, rtol=5e-3)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_break_the_input_gradient(sp, fault):
    """Each fault moves the gradient well past the bound the sharded path meets."""
    got, ref = sp
    want = ref[f"seg_{SEG_NAMES[1]}"][1]
    err = np.abs(_nhwc(got[f"fault_{fault}"][1]) - want) - (1e-3 + 5e-3 * np.abs(want))
    assert err.max() > 1e-3, (fault, err.max())


@pytest.mark.parametrize("style", STYLES)
def test_sharded_translation_matches_unsharded_and_jax(sp, style):
    """sample_with_sgg(spatial_mesh=(data=1, space=2)) in f32 equals JAX's
    unsharded chain (the draws replayed) at JAX's 2e-4, and the guidance
    moves the output far past it. Against the port's unsharded chain the
    comparison runs in float64 on both sides: in f32 the guidance amplifies
    the rounding of convolutions that add in another order (an input of
    other height) to ~2.7e-4 here, as it does between the port and JAX
    (tests/test_torch_sr_precision.py); in f64 what is left is the
    exchange's own arithmetic."""
    got, ref = sp
    sharded, sharded64, single64 = got[f"translate_{style}"]
    np.testing.assert_allclose(sharded, ref[f"translate_{style}"], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(sharded64, single64, atol=1e-9, rtol=1e-9)
    assert np.abs(ref[f"translate_{style}"] - ref["translate_none"]).max() > 1e-2


def test_translation_over_the_data_axis_matches_unsharded(sp):
    """A (data=2, space=1) mesh: each rank translates its row, the rows gathered (f64)."""
    got, _ = sp
    np.testing.assert_allclose(got["translate_data2"], got["translate_gsg"][2], atol=1e-9, rtol=1e-9)


def test_hrnet_sharded_matches_unsharded(sp):
    got, _ = sp
    out, want = got["hrnet"]["fwd"]
    np.testing.assert_allclose(out, want, atol=2e-4, rtol=2e-4)
    grad, gwant = got["hrnet"]["grad"]
    np.testing.assert_allclose(grad, gwant, atol=1e-3 * np.abs(gwant).max(), rtol=5e-3)


@pytest.mark.parametrize("key, match", [
    ("deeplabv3plus_mobilenet", "F.conv2d gives a map of height 31"),
    ("deeplabv3plus_xception", "F.conv2d gives a map of height 47"),
    ("height_pool", "HR height 30 is not divisible by space=2 x the pool factor 2"),
    ("height_stride", "gives a map of height 3, which does not split over space=2"),
])
def test_refusals_by_name(sp, key, match):
    """MobileNetV2's and Xception's padding-0 stems give odd map heights, which
    no even split holds; an HR height that does not pool to whole latent rows
    a rank is refused before anything runs, and one whose seg maps do not
    split when its op runs."""
    got, _ = sp
    assert match in got["refusals"][key], got["refusals"][key]


@pytest.fixture()
def fake_world():
    """A process group of `world` fake ranks in this process (no collectives)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world):
        dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_spatial_mesh_checks_the_world(fake_world):
    """JAX's checks and messages, on a fake world of 8."""
    from weatherconverter_tpu_torch.parallel import SPACE_AXIS, make_spatial_mesh, spatial_image_sharding

    fake_world(8)
    with pytest.raises(ValueError, match="8 devices not divisible by data=3"):
        make_spatial_mesh(data=3)
    with pytest.raises(ValueError, match=r"data\*space 4 != 8 devices"):
        make_spatial_mesh(data=2, space=2)
    mesh = make_spatial_mesh(data=2)
    assert mesh.mesh_dim_names == ("data", SPACE_AXIS) and tuple(mesh.shape) == (2, 4)
    from torch.distributed.tensor import Replicate, Shard

    assert spatial_image_sharding(mesh) == (Shard(0), Shard(1))
    assert spatial_image_sharding(mesh, batch_sharded=False) == (Replicate(), Shard(1))


def test_shard_spatial_takes_the_rank_rows(fake_world):
    """Rank 0 of (data=2, space=4): its H rows of an NHWC image and of labels,
    and its batch rows; constrain_spatial is the identity without a mesh."""
    from weatherconverter_tpu_torch.parallel import constrain_spatial, make_spatial_mesh, shard_spatial

    fake_world(8)
    mesh = make_spatial_mesh(data=2)
    x, y = torch.arange(4 * 8 * 3 * 2).reshape(4, 8, 3, 2), torch.arange(4 * 8 * 3).reshape(4, 8, 3)
    xs, ys = shard_spatial(mesh, (x, y))
    assert torch.equal(xs, x[:2, :2]) and torch.equal(ys, y[:2, :2])
    assert torch.equal(shard_spatial(mesh, x, batch_sharded=False), x[:, :2])
    assert constrain_spatial(x, None) is x
    with pytest.raises(ValueError, match="height 6 does not split over space=4"):
        shard_spatial(mesh, torch.zeros(2, 6, 3, 3))
