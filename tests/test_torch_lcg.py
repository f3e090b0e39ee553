"""The PyTorch port's local class-wise guidance (LCG), its present-class
packing, the nearest resize under it and the `alternate` / `lcg` schedules of
`sample_with_sgg` against the JAX package, on the CPU, in f32.

The models are those of tests/test_torch_translate.py: the tiny UNet,
DeepLabV3+/ResNet-18 with 19 classes and a 2x Swift-SRGAN generator, the same
perturbed weights on both sides; the JAX noise stream is drawn in JAX and
replayed into the port.

LCG blacks out everything outside a class, and over an exactly constant
region the ResNet stem's max-pool sees windows of equal values: which
element of a tie takes the gradient differs between XLA and ATen (measured
here: 1 % of the input gradient, 6e-4 of an LCG update, against 2e-6 once the
ties are gone). That is no property of the operators under test, so the seg
function of both sides first adds one fixed low-amplitude pattern (DITHER) to
its input, which breaks the ties and leaves d CE / d x as it is.
Tolerances: one operator call agrees to 1e-5 of the largest value (f32
through ResNet-18's forward and backward, sums in another order); the chains
take the GSG chain tests' tolerance.
"""

import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import generator_pair, jax_fns, nhwc_to_nchw, seg_pair, tiny_unet_pair

from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.guidance import sgg as JG
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu.ops import image as JI
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.guidance import sgg as PG
from weatherconverter_tpu_torch.guidance import translate as PT
from weatherconverter_tpu_torch.ops import image as PI

B, LATENT, HR, STEPS, CLASSES = 2, 32, 64, 4, 19
SCHED_ARGS = (STEPS, 1e-3, 0.2)
LAM = 0.05
DITHER = 1e-2  # against images in [0, 1]
# one operator call: max |port - jax| over max |jax|
OP_REL_TOL = 1e-5
# the sweep over all 19 classes, 38 masked copies: in one of them a ReLU of the
# ASPP's pooled branch sits within rounding of 0 and opens in one framework
# only, which moves that copy's whole field by 1e-3 of itself
SWEEP_REL_TOL = 5e-5
# a chain: tests/test_torch_translate.py's CHAIN_RTOL / CHAIN_ATOL
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def models():
    junet, uparams, port_unet = tiny_unet_pair()
    jseg, seg_vars, port_seg = seg_pair("deeplabv3plus_resnet18", HR)
    jgen, gen_vars, port_gen = generator_pair(2, hw=LATENT)
    port_seg.requires_grad_(False)
    diff_fn, seg_fn, sr_fn = jax_fns(junet, uparams, jseg, seg_vars, jgen, gen_vars)
    dither = {hw: (DITHER * np.random.default_rng(hw).standard_normal((1, hw, hw, 3))).astype(np.float32)
              for hw in (LATENT, HR)}
    port_dither = {hw: nhwc_to_nchw(d) for hw, d in dither.items()}

    def jax_seg(x):
        return seg_fn(x + dither[x.shape[1]])

    def port_seg_fn(x):
        return port_seg(x + port_dither[x.shape[2]])

    return dict(jax_fns=(diff_fn, jax_seg, sr_fn), port=(port_unet, port_seg_fn, port_gen),
                port_modules=(port_unet, port_seg, port_gen))


def _blocky_gt(rng, classes, size=HR, block=8):
    """(B, size, size) labels constant over block x block squares, drawn from `classes`."""
    small = rng.choice(np.asarray(classes), size=(B, size // block, size // block))
    return small.repeat(block, 1).repeat(block, 2).astype(np.int32)


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


# --- the chain ---

def _jax_noise(key, num_steps):
    shape = (B, LATENT, LATENT, 3)
    key, _tkey, nkey = jax.random.split(key, 3)
    noise0 = jax.random.normal(nkey, shape)
    zs = []
    for _ in range(num_steps):
        key, zkey = jax.random.split(key)
        zs.append(jax.random.normal(zkey, shape))
    return torch.from_numpy(np.array(noise0)), torch.from_numpy(np.stack([np.asarray(z) for z in zs]))


def _chain_inputs(seed, classes=range(CLASSES)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, LATENT, LATENT, 3)) * 0.2).astype(np.float32)
    gt = _blocky_gt(rng, list(classes))
    gt[:, :8, :8] = 255
    return x, gt


@pytest.mark.parametrize("style, space, present_k", [("alternate", "sr", None), ("lcg", "latent", None),
                                                     ("alternate", "latent", 3)])
def test_sample_with_sgg_lcg_styles_match_jax(models, style, space, present_k):
    """Four steps: under 'alternate' i = 3 and 1 take GSG, i = 2 LCG, i = 0
    nothing; under 'lcg' all three take LCG."""
    diff_fn, seg_fn, sr_fn = models["jax_fns"]
    x, gt = _chain_inputs(10, classes=[0, 3, 8, 12] if present_k else range(CLASSES))
    key = jax.random.PRNGKey(10)
    kw = dict(lam=LAM, num_steps=STEPS, num_classes=CLASSES, mode="fixed", start_t=STEPS - 1, guidance_every=1,
              guidance_style=style, guidance_space=space, lcg_class_chunk=4, lcg_present_k=present_k)
    ref = np.asarray(JT.sample_with_sgg(diff_fn, JS.linear_schedule(*SCHED_ARGS), seg_fn, sr_fn, jnp.asarray(x),
                                        jnp.asarray(gt), key, **kw))
    sched, noise = PS.linear_schedule(*SCHED_ARGS), _jax_noise(key, STEPS)
    args = (*models["port"][:1], sched, *models["port"][1:], torch.from_numpy(x), torch.from_numpy(gt).long())
    out = PT.sample_with_sgg(*args, noise=noise, **kw).numpy()
    assert out.shape == (B, HR, HR, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    # LCG is what is compared: the chain differs from the all-GSG one by far more than the tolerance (least at
    # latent resolution, where lam is divided by pool^2)
    gsg = PT.sample_with_sgg(*args, noise=noise, **dict(kw, guidance_style="gsg")).numpy()
    assert np.abs(out - gsg).max() > 30 * CHAIN_ATOL


def test_sample_with_sgg_present_k_bit_identical_end_to_end(models):
    """`lcg_present_k` with enough slots gives the full sweep's chain bit for
    bit, through `make_translate_fn`, with every step guided."""
    x, gt = _chain_inputs(11, classes=[1, 6, 14])
    noise = _jax_noise(jax.random.PRNGKey(11), STEPS)
    outs = []
    for present_k in (None, 4):
        fn = PT.make_translate_fn(*models["port_modules"][:1], PS.linear_schedule(*SCHED_ARGS),
                                  *models["port_modules"][1:],
                                  lam=LAM, num_steps=STEPS, start_t=STEPS - 1, guidance_style="alternate",
                                  guidance_space="sr", lcg_class_chunk=4, lcg_present_k=present_k)
        outs.append(fn(torch.from_numpy(x), torch.from_numpy(gt).long(), noise=noise))
    assert torch.equal(outs[0], outs[1])


def test_sample_with_sgg_takes_every_keyword_of_the_jax_signature():
    """But `key` (a torch.Generator, or replayed noise, stands for it).
    `xt_init` / `t_offset`, the chain's segments, are ported too
    (tests/test_torch_segments.py). The defaults agree too."""
    jax_params = inspect.signature(JT.sample_with_sgg).parameters
    port_params = inspect.signature(PT.sample_with_sgg).parameters
    for name, p in jax_params.items():
        if name == "key":
            assert name not in port_params
            continue
        assert name in port_params, name
        assert port_params[name].default == p.default, name
    assert port_params["guidance_style"].default == "alternate"
    kw = {name: p.default for name, p in jax_params.items() if p.default is not inspect.Parameter.empty}
    kw.update(num_steps=2, start_t=1, lcg_present_k=2, num_classes=3)
    seg = lambda img: torch.cat([img, img.sum(1, keepdim=True)], dim=1)[:, :3]  # noqa: E731
    sr = lambda lat: torch.nn.functional.interpolate(lat, scale_factor=2).mul(0.5).add(0.5).clamp(0, 1)  # noqa: E731
    out = PT.sample_with_sgg(lambda xt, t: torch.zeros_like(xt), PS.linear_schedule(4), seg, sr,
                             torch.zeros(1, 8, 8, 3), torch.randint(0, 3, (1, 16, 16)),
                             torch.Generator().manual_seed(0), **kw)
    assert out.shape == (1, 16, 16, 3) and torch.isfinite(out).all()


def test_unknown_guidance_style_raises_as_in_jax():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="unknown guidance_style"):
        PT.sample_with_sgg(None, PS.linear_schedule(4), None, None, x, torch.zeros(1, 16, 16), guidance_style="both")
    with pytest.raises(ValueError, match="lcg_present_k out of range"):
        PT.sample_with_sgg(None, PS.linear_schedule(4), None, None, x, torch.zeros(1, 16, 16), lcg_present_k=0)
