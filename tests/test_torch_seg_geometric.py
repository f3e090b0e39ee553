"""The geometric legs of the port's seg augment against the JAX package's, on
the CPU: random_scale_crop, random_rotation, pad_to_multiple, hue_jitter,
apply_affine, and the full seg_train_augment with every leg on.

JAX draws from split keys; the test draws JAX's own values from the same
keys, in each function's split order, and replays them through the port's
`scale=`/`crop=`, `angle=`, `factor=` and `SegDraws`. Labels must come out
equal: they are sampled at the nearest pixel (half to even, as jnp.round)
and filled with 255. Images to 1e-5 absolute (values in [0, 1]: the same
f32 arithmetic; the trigonometric functions and the bilinear sum may round
their last bit differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherconverter_tpu.data import transforms as JT
from weatherconverter_tpu_torch.data import transforms as PT

IMG_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _float_images(b, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def _labels(b, h, w, seed, ids=(0, 1, 2, 8, 10, 13, 255)):
    """Train-id labels in a checkerboard of 3 x 5 cells of ids drawn per cell:
    every resampled edge lands on a change of label."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(np.array(ids, np.uint8), size=(b, h // 3 + 1, w // 5 + 1))
    return np.ascontiguousarray(cells.repeat(3, axis=1)[:, :h].repeat(5, axis=2)[:, :, :w])


def _same(got, ref):
    gx, gy = got
    rx, ry = ref
    assert gy.dtype == torch.uint8 and np.array_equal(gy.numpy(), np.asarray(ry))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), rtol=0, atol=IMG_TOL)


def _scale_draws(key, b, scale_range):
    ks, ky, kx = jax.random.split(key, 3)
    s = jax.random.uniform(ks, (b,), minval=scale_range[0], maxval=scale_range[1])
    return _t(s), (_t(jax.random.uniform(ky, (b,))), _t(jax.random.uniform(kx, (b,))))


@pytest.mark.parametrize("scale_range, size", [((0.5, 2.0), (16, 20)), ((0.3, 0.6), (16, 20)), ((1.5, 2.5), (23, 11))])
def test_random_scale_crop_matches_jax(scale_range, size):
    """Down- and upscaling; at (0.3, 0.6) the scaled plane is smaller than the
    crop, whose rows and columns past it take the fills."""
    key, b = jax.random.PRNGKey(int(10 * scale_range[0])), 4
    x, y = _float_images(b, 27, 33, 1), _labels(b, 27, 33, 2)
    ref = JT.random_scale_crop(key, jnp.asarray(x), size, jnp.asarray(y), scale_range=scale_range)
    s, crop = _scale_draws(key, b, scale_range)
    got = PT.random_scale_crop(_t(x), size, _t(y), scale_range, scale=s, crop=crop)
    _same(got, ref)
    assert got[0].shape == (b, *size, 3)
    if scale_range[1] < 1:
        assert (got[1] == 255).any() and (got[0] == 0).any()


@pytest.mark.parametrize("degrees", [10.0, (-30.0, 45.0)])
def test_random_rotation_matches_jax(degrees):
    key, b = jax.random.PRNGKey(7), 3
    x, y = _float_images(b, 21, 26, 3), _labels(b, 21, 26, 4)
    ref = JT.random_rotation(key, jnp.asarray(x), jnp.asarray(y), degrees=degrees)
    lo, hi = (-degrees, degrees) if isinstance(degrees, float) else degrees
    angle = _t(jax.random.uniform(key, (b,), minval=lo, maxval=hi))
    got = PT.random_rotation(_t(x), _t(y), degrees, angle=angle)
    _same(got, ref)
    assert (got[1] == 255).sum() > (_t(y) == 255).sum()  # the corners rotated in are ignored, never road


@pytest.mark.parametrize("hw, diviser", [((21, 26), 8), ((32, 16), 16), ((5, 40), 32)])
def test_pad_to_multiple_matches_jax(hw, diviser):
    x, y = _float_images(2, *hw, 5), _labels(2, *hw, 6)
    ref = JT.pad_to_multiple(jnp.asarray(x), jnp.asarray(y), diviser)
    got = PT.pad_to_multiple(_t(x), _t(y), diviser)
    assert got[0].shape == ref[0].shape
    _same(got, ref)
    assert PT.pad_to_multiple(_t(x), None, diviser)[1] is None


def test_hue_jitter_and_hsv_round_trip_match_jax():
    """Gray pixels (no hue), each primary as the maximum, negative hues
    wrapped by floor-mod (torch.remainder, not fmod), values past [0, 1]."""
    key, b = jax.random.PRNGKey(9), 5
    x = np.random.default_rng(7).uniform(-0.1, 1.1, (b, 8, 9, 3)).astype(np.float32)
    x[:, 0, 0] = 0.5
    x[:, 0, 1] = (0.9, 0.2, 0.4)
    x[:, 0, 2] = (0.2, 0.9, 0.4)
    x[:, 0, 3] = (0.2, 0.4, 0.9)
    x[:, 0, 4] = (0.9, 0.2, 0.6)  # g < b under a red maximum: a negative hue before the mod
    ref = JT.hue_jitter(key, jnp.asarray(x), 0.4)
    factor = _t(jax.random.uniform(key, (b, 1, 1), minval=-0.4, maxval=0.4)).reshape(b)
    got = PT.hue_jitter(_t(x), 0.4, factor=factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=IMG_TOL)
    h, s, v = PT._rgb_to_hsv(_t(np.clip(x, 0, 1)))
    jh, js, jv = JT._rgb_to_hsv(jnp.clip(jnp.asarray(x), 0, 1))
    for a, r in ((h, jh), (s, js), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(PT._hsv_to_rgb(h, s, v).numpy(), np.clip(x, 0, 1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(angle=17.0), dict(angle=-8.0, translate=(0.1, -0.05), scale=1.3, shear=12.0),
                                dict(scale=0.7)])
def test_apply_affine_matches_jax(kw):
    x, y = _float_images(2, 19, 24, 8), _labels(2, 19, 24, 9)
    _same(PT.apply_affine(_t(x), _t(y), **kw), JT.apply_affine(jnp.asarray(x), jnp.asarray(y), **kw))


def _jax_full_draws(key, b, crop, scale_range, degrees, hue, hflip_p=0.5, jitter=(0.2, 0.2, 0.2),
                    std_range=(0.0, 0.05), masking_p=0.1):
    """Every draw of seg_train_augment with the geometric legs on, from `key`
    split kc, kf, kj, kn, km, kr, kh as the JAX chain splits it."""
    kc, kf, kj, kn, km, kr, kh = jax.random.split(key, 7)
    th, tw = crop
    scale, crop_u = _scale_draws(kc, b, scale_range)
    angle = _t(jax.random.uniform(kr, (b,), minval=-degrees, maxval=degrees))
    flip = _t(jax.random.uniform(kf, (b,)) < hflip_p)
    factors = tuple(_t(jax.random.uniform(k, (b, 1, 1, 1), minval=max(0.0, 1.0 - a), maxval=1.0 + a))
                    for k, a in zip(jax.random.split(kj, 3), jitter))
    hue_f = _t(jax.random.uniform(kh, (b, 1, 1), minval=-hue, maxval=hue)).reshape(b)
    ks, kn2 = jax.random.split(kn)
    std = _t(jax.random.uniform(ks, (b, 1, 1, 1), minval=std_range[0], maxval=std_range[1]))
    noise = _t(jax.random.normal(kn2, (b, th, tw, 3)))
    kp, kg = jax.random.split(km)
    apply = np.asarray(jax.random.uniform(kp, (b,))) < masking_p
    u = jax.random.uniform(kg, (b, len(PT.CLASSWISE_CANDIDATES)), minval=1e-6, maxval=1.0)
    return PT.SegDraws(None, flip, factors, std, noise, _t(apply), _t(-jnp.log(-jnp.log(u))), scale=scale,
                       crop=crop_u, angle=angle, hue=hue_f)


@pytest.mark.parametrize("masking_p", [0.1, 1.0])
def test_seg_train_augment_with_every_leg_matches_jax(masking_p):
    """Scale-and-crop instead of the uint8 crop, then rotation, flip, jitter,
    hue, noise and masking, in JAX's order; the config's legs through the
    loop's augment function."""
    key, b, crop = jax.random.PRNGKey(11), 4, (16, 20)
    x = np.random.default_rng(12).integers(0, 256, (b, 27, 33, 3), dtype=np.uint8)
    y = _labels(b, 27, 33, 13)
    legs = dict(scale_range=(0.5, 2.0), rotation_degrees=10.0, hue=0.1)
    ref_x, ref_y = JT.seg_train_augment(key, jnp.asarray(x), jnp.asarray(y), crop=crop, masking_p=masking_p, **legs)
    draws = _jax_full_draws(key, b, crop, legs["scale_range"], legs["rotation_degrees"], legs["hue"],
                            masking_p=masking_p)
    got = PT.seg_train_augment(_t(x), _t(y), crop=crop, masking_p=masking_p, draws=draws, **legs)
    assert got[0].shape == (b, *crop, 3)
    # normalized images: |x| up to ~2.6, so the image tolerance scales by 1 / min(std)
    assert np.array_equal(got[1].numpy(), np.asarray(ref_y))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref_x), rtol=0, atol=IMG_TOL / 0.225)
    # and through the seg loop's augment, which reads the legs from the config
    from weatherconverter_tpu_torch.core.config import SegConfig
    from weatherconverter_tpu_torch.training.loop_segmentation import make_augment

    cfg = SegConfig(data=dict(transform=dict(target_resolution=list(crop), scale_range=[0.5, 2.0],
                                             rotation_degrees=10.0, hue=0.1,
                                             class_wise_masking=dict(p=masking_p))))
    via_loop = make_augment(cfg)(_t(x), _t(y), None, draws)
    assert torch.equal(via_loop[0], got[0]) and torch.equal(via_loop[1], got[1])


def test_seg_train_augment_legs_draw_from_the_generator():
    """Without draws, each leg draws from the generator: the same seed the same
    pair, labels from the input's ids or 255."""
    x = _t(np.random.default_rng(1).integers(0, 256, (3, 24, 30, 3), dtype=np.uint8))
    y = _t(_labels(3, 24, 30, 2))
    run = lambda seed: PT.seg_train_augment(x, y, torch.Generator().manual_seed(seed), crop=(16, 16),  # noqa: E731
                                            scale_range=(0.5, 2.0), rotation_degrees=10.0, hue=0.1)
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and not torch.equal(a[0], c[0])
    assert set(a[1].unique().tolist()) <= set(y.unique().tolist()) | {255}
