"""The port's quality half (models/inception.py, compat/from_jax's Inception
exporter and loader, metrics/fid.py, metrics/quality.py) against the JAX
package on the CPU, in f32.

InceptionV3 runs at 75 x 75, the smallest input its stride-2 stem and two
reductions take, with parameters drawn by numpy on the JAX model's
eval_shape tree (tests/torch_parity.seeded_leaves; BatchNorm keeps the
activations O(1) through the 94 convs, no residual adds). The FID functions
run on synthetic feature sets of D = 64; mIoU-consistency on seeded logits
with ignored pixels.

Tolerances: Inception 1e-5 of max |ref| (f32 convolutions summed in other
orders: measured 1e-6); the FID 1e-5 relative (eigh in f32 in both
frameworks: measured 5e-7); the moments 1e-6 absolute; mIoU exact (integer
confusion counts, float64 metrics on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import seeded_leaves

from weatherconverter_tpu.compat.torch_import import convert_inception_v3
from weatherconverter_tpu.metrics import fid as JF
from weatherconverter_tpu.metrics import quality as JQ
from weatherconverter_tpu.models import inception as JI
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.metrics import fid as PF
from weatherconverter_tpu_torch.metrics import quality as PQ
from weatherconverter_tpu_torch.models.inception import InceptionV3, fid_input_resize

SIZE = 75
INCEPTION_REL_TOL = 1e-5
FID_RTOL = 1e-5


@pytest.fixture(scope="module")
def inception_variables():
    """Seeded variables of the JAX InceptionV3 with a 10-class fc."""
    model = JI.InceptionV3(classify=True, num_classes=10)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    return seeded_leaves(shapes, 0)


def _images(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("classify, transform_input", [(False, False), (True, True)],
                         ids=["pool3", "logits-transform-input"])
def test_inception_matches_jax(inception_variables, classify, transform_input):
    """pool3 features (2048-d, the FID's), and fc logits with torchvision's
    transform_input, from the same weights."""
    variables = dict(inception_variables)
    if not classify:
        variables["params"] = {k: v for k, v in variables["params"].items() if k != "fc"}
    jm = JI.InceptionV3(classify=classify, num_classes=10, transform_input=transform_input)
    x = _images(1)
    ref = np.asarray(jax.jit(lambda x: jm.apply(variables, x))(x))
    port = InceptionV3(num_classes=10, classify=classify, transform_input=transform_input)
    port.load_state_dict(from_jax.inception_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ref.shape == (2, 10 if classify else 2048) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= INCEPTION_REL_TOL * np.abs(ref).max()


def test_export_inception_v3_inverts_convert_inception_v3(inception_variables):
    """export -> the JAX converter gives back every leaf bit for bit; the
    torchvision-layout loader drops AuxLogits (and fc for pool3 features)
    and loads with strict=True, refusing any other stray key."""
    params, stats = inception_variables["params"], inception_variables["batch_stats"]
    sd = from_jax.export_inception_v3(params, stats)
    back_params, back_stats = convert_inception_v3(sd)
    for ours, theirs in ((back_params, params), (back_stats, stats)):
        assert jax.tree.structure(ours) == jax.tree.structure(theirs)
        assert jax.tree_util.tree_all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
                                                   ours, theirs))
    torchvision = from_jax.to_torch_state_dict(sd)
    torchvision["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    torchvision["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    features = from_jax.load_torchvision_inception(InceptionV3(), torchvision, classify=False)
    assert features.fc is None
    logits = from_jax.load_torchvision_inception(InceptionV3(num_classes=10, classify=True), torchvision,
                                                 classify=True)
    assert torch.equal(logits.fc.weight, torch.from_numpy(np.asarray(params["fc"]["kernel"]).T))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        from_jax.load_torchvision_inception(InceptionV3(), {**torchvision, "Mixed_8a.conv.weight": torch.zeros(1)},
                                            classify=False)


def test_fid_input_resize_matches_jax():
    x = (_images(2, n=1, size=40) + 1) / 2
    ref = np.asarray(JI.fid_input_resize(jnp.asarray(x)))
    got = fid_input_resize(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (1, 299, 299, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _features():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((300, 64)).astype(np.float32)
    b = (0.8 * rng.standard_normal((250, 64)) + 0.3).astype(np.float32)
    return a, b


def test_feature_stats_and_frechet_distance_match_jax():
    a, b = _features()
    jmu, jcov = JF.FeatureStats.init(64).update(jnp.asarray(a[:100])).update(jnp.asarray(a[100:])).finalize()
    pmu, pcov = PF.FeatureStats.init(64).update(torch.from_numpy(a[:100])).update(torch.from_numpy(a[100:])).finalize()
    np.testing.assert_allclose(pmu.numpy(), np.asarray(jmu), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pcov.numpy(), np.asarray(jcov), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pcov.numpy(), np.cov(a, rowvar=False), rtol=0, atol=1e-5)  # Bessel-corrected
    jb = JF.FeatureStats.init(64).update(jnp.asarray(b)).finalize()
    pb = PF.FeatureStats.init(64).update(torch.from_numpy(b)).finalize()
    ref = float(JF.frechet_distance(jmu, jcov, *jb))
    assert float(PF.frechet_distance(pmu, pcov, *pb)) == pytest.approx(ref, rel=FID_RTOL)
    assert ref > 1.0


def test_compute_fid_and_fid_from_batches_match_jax():
    a, b = _features()
    ref = float(JF.compute_fid(jnp.asarray(a), jnp.asarray(b)))
    assert float(PF.compute_fid(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(ref, rel=FID_RTOL)
    same = float(PF.compute_fid(torch.from_numpy(a), torch.from_numpy(a)))
    assert abs(same) <= 1e-3 * ref  # a set against itself

    def feats(x):  # a nonlinear extractor, the same in both frameworks
        return x * 2.0 + 0.5 * (x * x)

    ja = [jnp.asarray(a[:100]), jnp.asarray(a[100:])]
    jb = [jnp.asarray(b[:125]), jnp.asarray(b[125:])]
    ref = JF.fid_from_batches(feats, ja, jb)
    got = PF.fid_from_batches(feats, [torch.from_numpy(a[:100]), torch.from_numpy(a[100:])],
                              [torch.from_numpy(b[:125]), torch.from_numpy(b[125:])])
    assert isinstance(got, float) and got == pytest.approx(ref, rel=FID_RTOL)


def test_miou_consistency_and_gap_match_jax():
    """The seg function is the identity on seeded logits: JAX takes them NHWC,
    the port NCHW; labels hold ignored (255) pixels."""
    rng = np.random.default_rng(4)
    c = 5

    def batch(seed):
        g = np.random.default_rng(seed)
        logits = g.standard_normal((2, 12, 10, c)).astype(np.float32)
        gt = g.integers(0, c, (2, 12, 10)).astype(np.int32)
        gt[:, :2] = 255
        return logits, gt

    orig = [batch(s) for s in (10, 11)]
    # "translated" logits: the originals moved, so that some predictions change
    trans = [(lg + 0.8 * rng.standard_normal(lg.shape).astype(np.float32), gt) for lg, gt in orig]

    def jax_batches(bs):
        return [(jnp.asarray(lg), jnp.asarray(gt)) for lg, gt in bs]

    def port_batches(bs):
        return [(torch.from_numpy(lg).permute(0, 3, 1, 2), torch.from_numpy(gt.astype(np.int64))) for lg, gt in bs]

    ident = lambda x: x  # noqa: E731
    ref = JQ.consistency_gap(ident, jax_batches(orig), jax_batches(trans), c)
    got = PQ.consistency_gap(ident, port_batches(orig), port_batches(trans), c)
    for key in ("original_miou", "translated_miou", "miou_consistency_gap"):
        assert got[key] == ref[key], key
    assert got["original"] == ref["original"] and got["translated"] == ref["translated"]
    assert got["miou_consistency_gap"] > 0
    single = PQ.miou_consistency(ident, port_batches(orig), c)
    assert single == JQ.miou_consistency(ident, jax_batches(orig), c)
