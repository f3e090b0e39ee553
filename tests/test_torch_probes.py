"""The H100 micro-probes' plain versions (weatherconverter_tpu_torch/probes,
K4-K7) against the Pallas kernel bodies of the JAX package's `scripts/`
probes, run in interpret mode on the CPU, at small shapes, with inputs made
from numpy seeds.

The scripts are loaded by path (`scripts/` is no package). Importing
micro_attn.py and probe_dw3x3.py sets JAX's compilation-cache options and
makes a cache directory under HOME, so the loader points HOME at a
temporary directory and puts every option it touches back afterwards.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from weatherconverter_tpu_torch.probes import micro_attn as K4
from weatherconverter_tpu_torch.probes import probe_dw3x3 as K6
from weatherconverter_tpu_torch.probes import probe_dw9x9_floor as K5
from weatherconverter_tpu_torch.probes import probe_int8_dot as K7

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
PROBES = ("micro_attn", "probe_dw9x9_floor", "probe_dw3x3", "probe_int8_dot")
JAX_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _load_scripts(home: str) -> dict:
    saved = {name: getattr(jax.config, name) for name in JAX_OPTIONS}
    saved_home, saved_path = os.environ.get("HOME"), list(sys.path)
    os.environ["HOME"] = home
    try:
        modules = {}
        for name in PROBES:
            spec = importlib.util.spec_from_file_location(f"wc_scripts_{name}", os.path.join(SCRIPTS, name + ".py"))
            modules[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(modules[name])
        return modules
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        sys.path[:] = saved_path
        if saved_home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = saved_home


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    return _load_scripts(str(tmp_path_factory.mktemp("home")))


def _normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_loading_the_scripts_leaves_jax_options_and_home_alone(tmp_path):
    before = ({name: getattr(jax.config, name) for name in JAX_OPTIONS}, os.environ.get("HOME"), list(sys.path))
    modules = _load_scripts(str(tmp_path))
    assert set(modules) == set(PROBES)
    assert os.path.isdir(tmp_path / ".cache" / "jax_compcache")  # the scripts' cache went to the stand-in HOME
    assert ({name: getattr(jax.config, name) for name in JAX_OPTIONS}, os.environ.get("HOME"), sys.path) == before


# f32: the two differ in summation order only (2e-5 on outputs of O(1));
# bf16: p and O round to bf16 (K1's 1e-2). At input scale 6 the upper clamp
# fires: scores far past 60 log2 e share exp2's ceiling
@pytest.mark.parametrize("shape,dtype,scale,atol", [
    ((1, 2, 512, 16), "f32", 1.0, 2e-5),
    ((1, 1, 512, 64), "f32", 1.0, 2e-5),
    ((1, 2, 512, 32), "bf16", 1.0, 1e-2),
    ((1, 2, 512, 16), "f32", 6.0, 2e-5),
])
def test_exp2_attention_plain_matches_jax_kernel(scripts, shape, dtype, scale, atol):
    (qj, qt), (kj, kt) = (_pair(_normal(shape, seed, scale), dtype) for seed in (0, 1))
    vj, vt = _pair(_normal(shape, 2), dtype)
    want = scripts["micro_attn"].exp2_attention(qj, kj, vj, interpret=True)
    got = K4.exp2_attention(qt, kt, vt)
    assert got.dtype == qt.dtype and got.shape == shape
    if scale > 1:
        s2 = torch.matmul(qt * (K4.LOG2E / shape[-1] ** 0.5), kt.transpose(-1, -2))
        assert (s2 > K4.CLAMP2).any()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def test_dw_fma81_plain_matches_jax_kernel(scripts):
    """`dw_vpu_kernel` in a grid of (1, 8, 16, 8) blocks; f32, within 1e-6
    of max |out| (81 chained multiply-adds, which XLA may fuse)."""
    x = _normal((2, 16, 32, 16), 0)
    w = np.linspace(0.9, 1.1, K5.TAPS, dtype=np.float32)
    block = pl.BlockSpec((1, 8, 16, 8), lambda b, i, j, c: (b, i, j, c))
    want = pl.pallas_call(
        scripts["probe_dw9x9_floor"].dw_vpu_kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        grid=(2, 2, 2, 2),
        in_specs=[block, pl.BlockSpec((K5.TAPS,), lambda b, i, j, c: (0,))],
        out_specs=block,
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(w))
    got = K5.dw_fma81(torch.from_numpy(x), torch.from_numpy(w))
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6 * np.abs(want).max())


def _dw3x3_inputs(mod):
    """The script's (8, 128, 128, 64) f32 input and taps, and both padded as
    its main() pads them: H by 1, W to 136, the taps to 16 rows."""
    x = _normal((mod.B, mod.H, mod.W, mod.C), 0)
    k = _normal((3, 3, 1, mod.C), 1, K6.TAP_SCALE)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 7), (0, 0)))
    kv = jnp.pad(jnp.asarray(k).reshape(9, mod.C), ((0, 7), (0, 0)))
    return x, k, xp, kv


def test_dw3x3_plain_matches_jax_kernel(scripts):
    """The script's kernel body `_kernel` over every (TH + 2)-row band of the
    padded input, each band starting at row j * TH, f32 (atol 1e-5). The
    port pads nothing."""
    mod = scripts["probe_dw3x3"]
    x, k, xp, kv = _dw3x3_inputs(mod)
    nb = mod.H // mod.TH
    bands = jnp.stack([xp[:, j * mod.TH:j * mod.TH + mod.TH + 2] for j in range(nb)], axis=1)
    want = pl.pallas_call(
        mod._kernel,
        out_shape=jax.ShapeDtypeStruct((mod.B * nb, mod.TH, mod.W, mod.C), jnp.float32),
        grid=(mod.B * nb,),
        in_specs=[pl.BlockSpec((1, mod.TH + 2, mod.WP, mod.C), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((16, mod.C), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, mod.TH, mod.W, mod.C), lambda i: (i, 0, 0, 0)),
        interpret=True,
    )(bands.reshape(mod.B * nb, mod.TH + 2, mod.WP, mod.C), kv)
    want = _np(want).reshape(x.shape)
    got = K6.dw3x3(torch.from_numpy(x), torch.from_numpy(k))
    assert got.shape == x.shape
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)


def test_script_dw3x3_reads_the_wrong_rows_past_the_first_band(scripts):
    """The script's own `dw3x3` addresses its (TH + 2)-row input blocks by
    block index, so program j reads padded rows j * (TH + 2) onward, not
    j * TH: only each image's first TH rows are the conv (the last band runs
    past the input, NaN in interpret mode). The port computes the conv the
    script meant, which the test above holds against the kernel body."""
    mod = scripts["probe_dw3x3"]
    x, k, xp, kv = _dw3x3_inputs(mod)
    script = _np(mod.dw3x3(xp, kv)[:, :, :mod.W, :])
    got = _np(K6.dw3x3(torch.from_numpy(x), torch.from_numpy(k)))
    np.testing.assert_allclose(got[:, :mod.TH], script[:, :mod.TH], rtol=0, atol=1e-5)
    assert np.nanmax(np.abs(got[:, mod.TH:2 * mod.TH] - script[:, mod.TH:2 * mod.TH])) > 1.0
    xpn = np.asarray(xp)
    shifted = sum(xpn[:, mod.TH + 2 + dh:2 * mod.TH + 2 + dh, dw:dw + mod.W] * k[dh, dw, 0]
                  for dh in range(3) for dw in range(3))
    np.testing.assert_allclose(script[:, mod.TH:2 * mod.TH], shifted, rtol=0, atol=1e-5)


def _qk_call(kernel, q, k, out_dtype):
    """`k_int8` / `k_bf16` over (1, 256, D) query blocks against the whole K."""
    b, n, d = q.shape
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b, n, n), out_dtype),
        grid=(b, n // 256),
        in_specs=[pl.BlockSpec((1, 256, d), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, n, d), lambda i, j: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, 256, n), lambda i, j: (i, j, 0)),
        interpret=True,
    )(q, k)


@pytest.mark.parametrize("shape", [(1, 512, 64), (2, 256, 32)])
def test_qk_dot_i8_plain_matches_jax_kernel(scripts, shape):
    rng = np.random.default_rng(3)
    q8, k8 = (rng.integers(-127, 128, shape, dtype=np.int8) for _ in range(2))
    want = np.asarray(_qk_call(scripts["probe_int8_dot"].k_int8, jnp.asarray(q8), jnp.asarray(k8), jnp.int32))
    got = K7.qk_dot_i8(torch.from_numpy(q8), torch.from_numpy(k8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 512, 64), (2, 256, 32)])
def test_qk_dot_bf16_plain_matches_jax_kernel(scripts, shape):
    """Products of bf16 values are exact in f32; the sums differ in order:
    within 1e-5 of max |S|."""
    (qj, qt), (kj, kt) = (_pair(_normal(shape, seed), "bf16") for seed in (4, 5))
    want = _np(_qk_call(scripts["probe_int8_dot"].k_bf16, qj, kj, jnp.float32))
    got = K7.qk_dot_bf16(qt, kt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=K7.BF16_RTOL * np.abs(want).max())
