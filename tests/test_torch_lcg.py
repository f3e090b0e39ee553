"""The PyTorch port's local class-wise guidance (LCG), its present-class
packing and the nearest resize under it against the JAX package, on the CPU,
in f32; the `alternate` / `lcg` schedules of `sample_with_sgg` are in
tests/test_torch_lcg_chains.py (the two files split the time of one).

The models, their dither and the sizes are tests/lcg_parity.py's, the same
perturbed weights on both sides.
Tolerances: one operator call agrees to 1e-5 of the largest value (f32
through ResNet-18's forward and backward, sums in another order).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from lcg_parity import CLASSES, HR, LAM, LATENT, B, blocky_gt as _blocky_gt, build_models
from torch_parity import nhwc_to_nchw

from weatherconverter_tpu.guidance import sgg as JG
from weatherconverter_tpu.ops import image as JI
from weatherconverter_tpu_torch.guidance import sgg as PG
from weatherconverter_tpu_torch.ops import image as PI

# one operator call: max |port - jax| over max |jax|
OP_REL_TOL = 1e-5
# the sweep over all 19 classes, 38 masked copies: in one of them a ReLU of the
# ASPP's pooled branch sits within rounding of 0 and opens in one framework
# only, which moves that copy's whole field by 1e-3 of itself
SWEEP_REL_TOL = 5e-5


@pytest.fixture(scope="module")
def models():
    return build_models()


def _operator_inputs(seed, classes=range(CLASSES), hr=HR):
    rng = np.random.default_rng(seed)
    sr_xt = rng.uniform(0, 1, (B, hr, hr, 3)).astype(np.float32)
    gt = _blocky_gt(rng, list(classes), size=hr)
    mu = rng.standard_normal((B, LATENT, LATENT, 3)).astype(np.float32)
    z = rng.standard_normal((B, LATENT, LATENT, 3)).astype(np.float32)
    return sr_xt, gt, mu, z


def _port_lcg(port_seg, sr_xt, gt, mu, z, sigma=0.3, **kw):
    out = PG.apply_lcg(port_seg, nhwc_to_nchw(mu), torch.tensor(sigma), nhwc_to_nchw(sr_xt),
                       torch.from_numpy(gt).long(), LAM, noise=None if z is None else nhwc_to_nchw(z), **kw)
    return out.permute(0, 2, 3, 1).numpy()


def _jax_lcg(seg_fn, sr_xt, gt, mu, z, sigma=0.3, class_ids=None, noise_scale=None, **kw):
    fn = jax.jit(partial(JG.apply_lcg, seg_fn, lam=LAM, **kw))
    return np.asarray(fn(mu=jnp.asarray(mu), sigma=jnp.float32(sigma), sr_xt=jnp.asarray(sr_xt), gt=jnp.asarray(gt),
                         noise=None if z is None else jnp.asarray(z), class_ids=class_ids,
                         noise_scale=noise_scale))


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# --- resize_nearest ---

@pytest.mark.parametrize("src, dst", [((12, 16), (6, 8)), ((12, 16), (3, 4)), ((10, 14), (4, 6)), ((5, 6), (10, 9))],
                         ids=["half", "quarter", "non-integer", "upsample"])
def test_resize_nearest_matches_jax(src, dst):
    """JAX samples at half-pixel centres (12 -> 3 reads 2, 6, 10). Exact."""
    x = np.random.default_rng(0).standard_normal((2, *src, 3)).astype(np.float32)
    ref = np.asarray(JI.resize_nearest(jnp.asarray(x), dst))
    out = PI.resize_nearest(nhwc_to_nchw(x), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out, ref)
    rows = PI.resize_nearest(torch.arange(12.0).reshape(1, 1, 12, 1), (3, 1)).flatten().tolist()
    assert rows == [2.0, 6.0, 10.0]


# --- present_class_ids ---

def _tricky_gt():
    """Image 0: classes 3 and 5 tied at 4 pixels, 7 at 6, 255 and an id past
    the classes; image 1: nothing but 255; image 2: every class once, ties
    everywhere; image 3: one class."""
    gt = np.full((4, 6, 6), 255, dtype=np.int32)
    gt[0].flat[:16] = [5, 5, 5, 5, 3, 3, 3, 3, 7, 7, 7, 7, 7, 7, 19, 40]
    gt[2].flat[:19] = np.arange(19)[::-1]
    gt[3] = 11
    return gt


@pytest.mark.parametrize("k", [1, 2, 3, 8, 19])
def test_present_class_ids_equal_jax(k):
    gt = _tricky_gt()
    ref = np.asarray(JG.present_class_ids(jnp.asarray(gt), k, CLASSES))
    out = PG.present_class_ids(torch.from_numpy(gt), k, CLASSES)
    assert out.dtype == torch.int32 and out.shape == (4, k)
    np.testing.assert_array_equal(out.numpy(), ref)
    if k == 2:  # the tie between 3 and 5 goes to the smaller id, after the larger class 7
        assert out[0].tolist() == [3, 7] and out[1].tolist() == [-1, -1]


@pytest.mark.parametrize("k", [0, 20, -1])
def test_present_class_ids_refuses_k_out_of_range(k):
    with pytest.raises(ValueError, match="lcg_present_k out of range"):
        PG.present_class_ids(torch.zeros((1, 4, 4), dtype=torch.long), k, CLASSES)
    with pytest.raises(ValueError, match="lcg_present_k out of range"):
        JG.present_class_ids(jnp.zeros((1, 4, 4), jnp.int32), k, CLASSES)


# --- apply_lcg and apply_gsg against JAX ---

@pytest.mark.parametrize("mode", ["fixed", "reference"])
def test_apply_lcg_full_sweep_matches_jax(models, mode):
    """All 19 classes, 4 a seg call; an ignored patch, so 'fixed' also takes
    the base update there."""
    sr_xt, gt, mu, z = _operator_inputs(1)
    gt[:, :16, :16] = 255
    ref = _jax_lcg(models["jax_fns"][1], sr_xt, gt, mu, z, mode=mode)
    out = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode=mode)
    assert out.shape == (B, LATENT, LATENT, 3) and np.isfinite(out).all()
    assert _rel(out, ref) <= SWEEP_REL_TOL
    # the guidance term is what is compared: it moves the update
    base = mu + 0.3 * (z if mode == "fixed" else 1.0)
    assert np.abs(out - base)[:, 8:, 8:].max() > 100 * SWEEP_REL_TOL * np.abs(ref).max()


def test_apply_lcg_at_latent_resolution_matches_jax(models):
    """`guidance_space='latent'`: the image and the labels at the latent's size, pool 1."""
    sr_xt, gt, mu, z = _operator_inputs(2, hr=LATENT)
    ref = _jax_lcg(models["jax_fns"][1], sr_xt, gt, mu, z, mode="fixed")
    out = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode="fixed")
    assert _rel(out, ref) <= OP_REL_TOL


def test_apply_lcg_packed_slots_and_noise_scale_match_jax(models):
    """Per-image slots from `present_class_ids` (K = 4 of 5 present classes,
    so one class an image is dropped) and a noise scale of its own."""
    sr_xt, gt, mu, z = _operator_inputs(3, classes=[0, 4, 9, 13, 18])
    ids = JG.present_class_ids(jnp.asarray(gt), 4, CLASSES)
    ref = _jax_lcg(models["jax_fns"][1], sr_xt, gt, mu, z, mode="fixed", class_ids=ids, noise_scale=jnp.float32(0.7))
    port_ids = PG.present_class_ids(torch.from_numpy(gt), 4, CLASSES)
    np.testing.assert_array_equal(port_ids.numpy(), np.asarray(ids))
    out = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode="fixed", class_ids=port_ids,
                    noise_scale=torch.tensor(0.7))
    assert _rel(out, ref) <= OP_REL_TOL


@pytest.mark.parametrize("mode", ["fixed", "reference"])
def test_apply_gsg_noise_scale_matches_jax(models, mode):
    sr_xt, gt, mu, z = _operator_inputs(4)
    ref = JG.apply_gsg(models["jax_fns"][1], jnp.asarray(mu), jnp.float32(0.3), jnp.asarray(sr_xt), jnp.asarray(gt),
                       LAM, noise=jnp.asarray(z), mode=mode, noise_scale=jnp.float32(0.7))
    out = PG.apply_gsg(models["port"][1], nhwc_to_nchw(mu), torch.tensor(0.3), nhwc_to_nchw(sr_xt),
                       torch.from_numpy(gt).long(), LAM, noise=nhwc_to_nchw(z), mode=mode,
                       noise_scale=torch.tensor(0.7))
    assert _rel(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref)) <= OP_REL_TOL


# --- apply_lcg's own rules, in the port ---

@pytest.mark.parametrize("chunk", [1, 19, 32])
def test_apply_lcg_class_chunk_changes_nothing(models, chunk):
    """The chunk width is a throughput knob: each masked copy's CE is
    normalised per image. Against the default of 4, to f32 rounding (a seg
    call on another batch size may sum in another order)."""
    sr_xt, gt, mu, z = _operator_inputs(5, classes=[1, 2, 6, 17])
    want = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode="fixed", class_chunk=4)
    out = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode="fixed", class_chunk=chunk)
    assert _rel(out, want) <= OP_REL_TOL


@pytest.mark.parametrize("mode", ["fixed", "reference"])
def test_apply_lcg_packed_sweep_equals_full_sweep_bit_for_bit(models, mode):
    """K = 4 slots cover each image's present classes (image 0 has three,
    image 1 four, and some 255): absent classes add +-0 in the full sweep and
    the ids are ascending, so not one bit differs."""
    sr_xt, gt, mu, z = _operator_inputs(6, classes=[2, 5, 11, 16])
    gt[0][gt[0] == 16] = 5
    gt[1, :8, :8] = 255
    ids = PG.present_class_ids(torch.from_numpy(gt), 4, CLASSES)
    assert ids.tolist() == [[2, 5, 11, -1], [2, 5, 11, 16]]
    full = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode=mode)
    packed = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode=mode, class_ids=ids)
    np.testing.assert_array_equal(packed, full)
    shared = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode=mode, class_ids=torch.tensor([2, 5, 11, 16]))
    np.testing.assert_array_equal(shared, full)


def test_apply_lcg_small_k_gives_dropped_classes_the_base_update(models):
    """Class 0 fills three quarters of each image and class 1 the rest: K = 1
    keeps class 0, and class 1's pixels take mu + sigma * z exactly."""
    sr_xt, _, mu, z = _operator_inputs(7)
    gt = np.zeros((B, HR, HR), dtype=np.int32)
    gt[:, HR // 2:, HR // 2:] = 1
    ids = PG.present_class_ids(torch.from_numpy(gt), 1, CLASSES)
    assert ids.tolist() == [[0], [0]]
    out = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode="fixed", class_ids=ids)
    base = mu + np.float32(0.3) * z
    half = LATENT // 2
    np.testing.assert_array_equal(out[:, half:, half:], base[:, half:, half:])
    assert np.abs(out[:, :half] - base[:, :half]).max() > 1e-3


def test_apply_lcg_uncovered_pixels(models):
    """All labels 255: 'fixed' returns the base update everywhere, 'reference'
    the empty sum (the original code's zeros)."""
    sr_xt, _, mu, z = _operator_inputs(8)
    gt = np.full((B, HR, HR), 255, dtype=np.int32)
    out = _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode="fixed", class_ids=torch.tensor([3, 4]))
    np.testing.assert_array_equal(out, mu + np.float32(0.3) * z)
    assert not _port_lcg(models["port"][1], sr_xt, gt, mu, z, mode="reference", class_ids=torch.tensor([3, 4])).any()
    no_noise = _port_lcg(models["port"][1], sr_xt, gt, mu, None, mode="fixed", class_ids=torch.tensor([3]))
    np.testing.assert_array_equal(no_noise, mu + np.float32(0.3))


def test_apply_lcg_labels_the_masked_out_pixels_as_class_0(models, monkeypatch):
    """The masked label is gt * mask: outside class c it is 0, not 255, so the
    CE of class c's copy also pulls the blacked-out pixels towards class 0."""
    seen = []

    def spy_seg(x):
        seen.append(x.detach().clone())
        return models["port"][1](x)

    sr_xt, gt, mu, z = _operator_inputs(9, classes=[0, 7])
    calls = []
    real = PG._per_pixel_ce
    monkeypatch.setattr(PG, "_per_pixel_ce",
                        lambda logits, labels, ignore: (calls.append(labels.clone()), real(logits, labels, ignore))[1])
    PG.apply_lcg(spy_seg, nhwc_to_nchw(mu), torch.tensor(0.3), nhwc_to_nchw(sr_xt), torch.from_numpy(gt).long(),
                 LAM, noise=nhwc_to_nchw(z), class_ids=torch.tensor([7]))
    (labels,), (image,) = calls, seen
    gt_t = torch.from_numpy(gt).long()
    assert torch.equal(labels, torch.where(gt_t == 7, 7, 0))
    assert torch.equal(image, nhwc_to_nchw(sr_xt) * (gt_t == 7)[:, None])
