"""The port's visualization and instrumentation utilities against the JAX
package, on the CPU: utils/images.py's process strips, save_strip and
augmentation galleries, utils/debug.py's debug_tensor, and core/profiling.py.

PNG bytes are compared for the same numpy input (the port does the uint8
conversion in numpy f32, as JAX's to_uint8_image). The strips and galleries
replay JAX's draws: the forward strip's noise, the photometric gallery's
jitter factors. Images to 1e-5 absolute (tests/test_torch_seg_geometric.py:
the same f32 arithmetic; the trigonometric functions and the bilinear sum
may round their last bit differently).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherconverter_tpu.core import profiling as JP
from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.utils import debug as JD
from weatherconverter_tpu.utils import images as JI
from weatherconverter_tpu_torch.core import profiling as PP
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.utils import debug as PD
from weatherconverter_tpu_torch.utils import images as PI

IMG_TOL = 1e-5


def _image(h, w, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (h, w, 3)).astype(np.float32)


def test_forward_process_strip_matches_jax():
    """q(x_t | x_0) at t = 0, 7, 14, ... of a 20-step schedule, one noise
    for every frame (JAX's draw from the key, replayed): f32 elementwise,
    to one ulp of values of order 1."""
    x0 = _image(8, 6, 0, -1.0, 1.0)
    key = jax.random.PRNGKey(3)
    ref = JI.forward_process_strip(JS.linear_schedule(20), jnp.asarray(x0), key, every=7)
    noise = np.asarray(jax.random.normal(key, x0.shape))
    got = PI.forward_process_strip(PS.linear_schedule(20), torch.from_numpy(x0), noise=torch.from_numpy(noise), every=7)
    assert got.shape == (3, 8, 6, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    # drawn from a generator: still one draw behind every frame
    sched, x = PS.linear_schedule(20), torch.from_numpy(x0)
    drawn = PI.forward_process_strip(sched, x, torch.Generator().manual_seed(0), every=7)
    n7, n14 = ((drawn[i] - sched.sqrt_alpha_cum_prod[t] * x) / sched.sqrt_one_minus_alpha_cum_prod[t]
               for i, t in ((1, 7), (2, 14)))
    torch.testing.assert_close(n7, n14, rtol=0, atol=1e-5)


def test_backward_process_strip_takes_one_sample():
    traj = np.arange(4 * 3 * 2 * 2 * 3, dtype=np.float32).reshape(4, 3, 2, 2, 3)
    assert np.array_equal(PI.backward_process_strip(torch.from_numpy(traj), 1).numpy(),
                          np.asarray(JI.backward_process_strip(jnp.asarray(traj), 1)))


@pytest.mark.parametrize("from_range", ["pm1", "unit"])
def test_save_strip_png_bytes_equal_jax(tmp_path, from_range):
    strip = np.random.default_rng(1).uniform(-1.2, 1.2, (4, 5, 7, 3)).astype(np.float32)
    ours = PI.save_strip(torch.from_numpy(strip), str(tmp_path / "p" / "s.png"), from_range)
    theirs = JI.save_strip(jnp.asarray(strip), str(tmp_path / "j" / "s.png"), from_range)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def _debug_input(kind):
    rng = np.random.default_rng(2)
    if kind == "label":
        lbl = rng.integers(0, 19, (2, 9, 11)).astype(np.int32)
        lbl[:, :2] = 255
        return lbl
    if kind == "image":
        return rng.uniform(-1.3, 1.3, (5, 6, 7, 3)).astype(np.float32)
    return rng.standard_normal((3, 4)).astype(np.float32)  # no image shape: the .npy fallback


@pytest.mark.parametrize("kind", ["label", "image", "npy"])
def test_debug_tensor_writes_jax_bytes(tmp_path, kind, capsys):
    x = _debug_input(kind)
    ours = PD.debug_tensor(torch.from_numpy(x), str(tmp_path / "p" / "d.png"), "title")
    theirs = JD.debug_tensor(x, str(tmp_path / "j" / "d.png"), "title")
    assert os.path.basename(ours) == os.path.basename(theirs) == ("d.npy" if kind == "npy" else "d.png")
    if kind == "npy":
        assert np.array_equal(np.load(ours), np.load(theirs))
    else:
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    out = capsys.readouterr().out
    assert "Tensor shape" in out and "Image saved to" in out


def test_augmentation_galleries_match_jax():
    """Geometric: JAX's apply_affine panels. Photometric: JAX's jitter
    factors, drawn from its split keys (augmentation_galleries, then
    color_jitter's and hue_jitter's own splits), replayed."""
    img = _image(12, 16, 5)
    key = jax.random.PRNGKey(1)
    ref = JI.augmentation_galleries(jnp.asarray(img), key)
    ks = jax.random.split(key, 4)

    def jitter_factor(k, which):
        sub = jax.random.split(k, 3)[which]
        return np.asarray(jax.random.uniform(sub, (1, 1, 1, 1), minval=0.5, maxval=1.5)).reshape(1)

    factors = [jitter_factor(ks[i], i) for i in range(3)]
    factors.append(np.asarray(jax.random.uniform(ks[3], (1, 1, 1), minval=-0.3, maxval=0.3)).reshape(1))
    got = PI.augmentation_galleries(torch.from_numpy(img), factors=factors)
    for name in ("photometric", "geometric"):
        assert got[name].shape == (5, 12, 16, 3)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=0, atol=IMG_TOL)
    drawn = PI.augmentation_galleries(torch.from_numpy(img), torch.Generator().manual_seed(0))
    assert torch.equal(drawn["geometric"], got["geometric"])
    assert not torch.equal(drawn["photometric"], got["photometric"])


def test_step_timer_summary_matches_jax_on_a_fake_clock(monkeypatch):
    ticks = iter([0.0, 1.0, 1.0, 3.0, 3.0, 3.5, 3.5, 7.5, 7.5, 8.0] * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    summaries = []
    for timer in (PP.StepTimer(warmup=1, device="cpu"), JP.StepTimer(warmup=1)):
        for _ in range(5):
            with timer:
                pass
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1] == dict(steps=4, mean_s=1.75, p50_s=2.0, p90_s=4.0, min_s=0.5, max_s=4.0)
    assert PP.StepTimer(device="cpu").summary() == JP.StepTimer().summary() == {"steps": 0}


def test_trace_writes_a_chrome_trace_and_memory_stats_are_empty_on_the_cpu(tmp_path):
    with PP.trace(str(tmp_path / "tr")) as prof:
        with PP.annotate("the_step"):
            torch.ones(8).add_(1)
    path = tmp_path / "tr" / PP.TRACE_FILE
    assert path.is_file() and path.stat().st_size > 0 and "the_step" in path.read_text()
    assert any(e.key == "the_step" for e in prof.key_averages())
    assert PP.device_memory_stats("cpu") == {} == JP.device_memory_stats(jax.devices("cpu")[0])
    assert PP.format_memory("cpu") == "memory stats unavailable"


def test_enable_nan_debugging_turns_anomaly_mode_on_and_off():
    try:
        PP.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        PP.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
