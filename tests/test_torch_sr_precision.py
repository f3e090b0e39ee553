"""The guided chain in `guidance_space="sr"` against JAX in float64: the
'sr'-space gap settled.

In f32 the port's 'sr' chain (the tiny models of tests/test_torch_translate.py,
GSG, 4 steps) sits up to 3.2e-3 from JAX's at `_inputs(3)` (key 0, JAX's
models jitted one by one, as that file runs them) and up to 9.1e-5 with
JAX's chain jitted whole: the gap moves with XLA's fusion (the latent
chain, too, reaches 2.2e-4 at `_inputs(4)` op by op). Run both sides in
float64 -- JAX under `jax.enable_x64` with its models' dtype float64, the
port's models `.double()`, the same weights, the draws JAX makes replayed
-- and every seed agrees to 1.0e-6-1.6e-6 in both spaces, either way. What is
left is the f32 rounding both packages do on purpose at the same points
(the models' outputs, GroupNorm's statistics, the CE's logits, the guidance
field). So the f32 gap is rounding in the f32 convolutions (XLA and ATen
add in other orders), amplified by the guidance: the perturbed seg
model's logits are large, its CE's softmax near one-hot, and where two
classes nearly tie an ulp moves the gradient. Not a fault of the port.

`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sr_precision.py` prints the differences of both
precisions at seeds 0-4 (CPU, ~2 min).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TINY_UNET, generator_pair, seg_pair, tiny_unet_pair

from weatherconverter_tpu.core.config import UnetModelConfig as JUnetConfig
from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu.models.factory import make_seg_model as j_make_seg_model
from weatherconverter_tpu.models.srgan import Generator as JGenerator
from weatherconverter_tpu.models.unet import Unet as JUnet
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.guidance import translate as PT

B, LATENT, HR, STEPS = 2, 32, 64, 4
SCHED_ARGS = (STEPS, 1e-3, 0.2)
LAM = 0.5
SEEDS = range(5)
# f64 on both sides, but the f32 rounding both packages do by design at the same points (above): ~20 f32 ulps
F64_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for the port's side, as the suite's other parity
    files take it: beside the suite's parallel workers more threads
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    _, uparams, unet = tiny_unet_pair()
    _, seg_vars, seg = seg_pair("deeplabv3plus_resnet18", HR)
    _, gen_vars, gen = generator_pair(2, hw=LATENT)
    return (uparams, seg_vars, gen_vars), (unet, seg.requires_grad_(False), gen)


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, LATENT, LATENT, 3)) * 0.2).astype(dtype)
    gt = rng.integers(0, 19, (B, HR, HR)).astype(np.int32)
    gt[:, :8, :8] = 255
    return x, gt


def _jax_draws(key, shape, dtype):
    """The draws sample_with_sgg makes from `key`, in its split order and the input's dtype."""
    key, _tkey, nkey = jax.random.split(key, 3)
    noise0 = jax.random.normal(nkey, shape, dtype)
    zs = []
    for _ in range(STEPS):
        key, zkey = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(zkey, shape, dtype)))
    return torch.from_numpy(np.array(noise0)), torch.from_numpy(np.stack(zs))


def chain_differences(weights, seeds=SEEDS, space="sr", f64=True, whole_jit=True):
    """max |port - JAX| of the guided chain's output at each seed, both sides
    in f64 (`f64`) or in f32; JAX's chain jitted whole, or (not
    `whole_jit`) its models jitted one by one, as tests/test_torch_translate.py
    runs it: XLA then fuses and rounds otherwise."""
    (uparams, seg_vars, gen_vars), (unet, seg, gen) = weights
    jdt = jnp.float64 if f64 else jnp.float32
    tdt = torch.float64 if f64 else torch.float32
    cast = (lambda m: copy.deepcopy(m).to(tdt))
    unet, seg, gen = (cast(m) for m in (unet, seg, gen))
    with jax.enable_x64(f64):
        to = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)  # noqa: E731
        junet = JUnet(config=JUnetConfig(**TINY_UNET), fused=True, dtype=jdt)
        jseg = j_make_seg_model("deeplabv3plus_resnet18", 19, dtype=jdt)
        jgen = JGenerator(upscale_factor=2, num_blocks=2, dtype=jdt)
        up, sv, gv = to(uparams), to(seg_vars), to(gen_vars)
        diff_fn = lambda x, t: junet.apply({"params": up}, x, t)  # noqa: E731
        seg_fn = lambda x: jseg.apply(sv, x)  # noqa: E731
        sr_fn = lambda x: jgen.apply(gv, x)  # noqa: E731
        if not whole_jit:
            diff_fn, seg_fn, sr_fn = jax.jit(diff_fn), jax.jit(seg_fn), jax.jit(sr_fn)
        kw = dict(lam=LAM, num_steps=STEPS, mode="fixed", start_t=STEPS - 1, guidance_space=space,
                  guidance_style="gsg")
        jchain = (lambda x, gt, key: JT.sample_with_sgg(diff_fn, JS.linear_schedule(*SCHED_ARGS), seg_fn, sr_fn, x,
                                                        gt, key, **kw))
        jchain = jax.jit(jchain) if whole_jit else jchain
        out = []
        for seed in seeds:
            x, gt = _inputs(seed, np.float64 if f64 else np.float32)
            key = jax.random.PRNGKey(0)
            ref = jchain(jnp.asarray(x), jnp.asarray(gt), key)
            # the JAX modules cast their input to their dtype; the port's seg model takes the SRGAN's f32 output
            got = PT.sample_with_sgg(unet, PS.linear_schedule(*SCHED_ARGS), lambda im: seg(im.to(tdt)), gen,
                                     torch.from_numpy(x), torch.from_numpy(gt).long(),
                                     noise=_jax_draws(key, x.shape, jdt), **kw)
            out.append(float(np.abs(got.numpy() - np.asarray(ref)).max()))
    return out


def test_sr_space_chain_agrees_with_jax_in_f64_at_every_seed(weights):
    diffs = chain_differences(weights)
    assert all(d <= F64_ATOL for d in diffs), diffs


if __name__ == "__main__":
    torch.set_num_threads(4)
    w = weights.__wrapped__()
    for space in ("sr", "latent"):
        for f64 in (False, True):
            for whole_jit in (True, False):
                diffs = chain_differences(w, space=space, f64=f64, whole_jit=whole_jit)
                print(space, "f64" if f64 else "f32", "chain jitted whole" if whole_jit else "models jitted",
                      [f"{d:.2e}" for d in diffs])
