"""The seg half of the port's data pipeline and the seg CLI against the JAX
package's, on the CPU.

JAX draws from split keys; the test draws JAX's own values from the same
keys, in each function's split order, and hands them to the port
(`offsets=`, `flip=`, `factors=`, `std=`/`noise=`, `apply=`/`gumbel=`,
`SegDraws`). Labels and masks must come out equal; f32 images equal to
1e-6 (the same arithmetic, summed in another order where a mean is taken).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import seg_pair_from_shapes

from weatherconverter_tpu.cli import commands as JC
from weatherconverter_tpu.core.checkpoint import save_pytree_npz
from weatherconverter_tpu.core.config import load_seg_config as j_load_seg_config
from weatherconverter_tpu.data import datasets as JD
from weatherconverter_tpu.data import transforms as JT
from weatherconverter_tpu_torch.cli import main as PM
from weatherconverter_tpu_torch.core.config import load_seg_config
from weatherconverter_tpu_torch.data import datasets as PD
from weatherconverter_tpu_torch.data import transforms as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# raw Cityscapes ids of road, sidewalk, building, wall, fence (train ids 0-4) and 'unlabeled' (255)
RAW_IDS = np.array([7, 8, 11, 12, 13, 0], dtype=np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(b, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def _labels(b, h, w, seed, ids=(0, 1, 2, 8, 10, 13, 255)):
    """Train-id labels in horizontal bands of ids drawn per band."""
    rng = np.random.default_rng(seed)
    bands = rng.choice(np.array(ids, np.uint8), size=(b, h // 4 + 1, 1))
    return np.ascontiguousarray(np.repeat(bands, 4, axis=1)[:, :h].repeat(w, axis=2))


def _jax_masking_draws(key, b):
    """(apply, gumbel) as class_wise_masking draws them (transforms.py:201-218)."""
    kp, kc = jax.random.split(key)
    apply = jax.random.uniform(kp, (b,))
    u = jax.random.uniform(kc, (b, len(PT.CLASSWISE_CANDIDATES)), minval=1e-6, maxval=1.0)
    return np.asarray(apply), np.asarray(-jnp.log(-jnp.log(u)))


def _jax_seg_draws(key, b, hw, crop, hflip_p=0.5, jitter=(0.2, 0.2, 0.2), std_range=(0.0, 0.05), masking_p=0.1):
    """The draws seg_train_augment takes from `key` (transforms.py:287-301)."""
    kc, kf, kj, kn, km, _, _ = jax.random.split(key, 7)
    (h, w), (th, tw) = hw, crop
    ky, kx = jax.random.split(kc)
    offsets = (_t(jax.random.randint(ky, (b,), 0, h - th + 1)), _t(jax.random.randint(kx, (b,), 0, w - tw + 1)))
    flip = _t(jax.random.uniform(kf, (b,)) < hflip_p)
    factors = tuple(_t(jax.random.uniform(k, (b, 1, 1, 1), minval=max(0.0, 1.0 - a), maxval=1.0 + a))
                    for k, a in zip(jax.random.split(kj, 3), jitter))
    ks, kn2 = jax.random.split(kn)
    std = _t(jax.random.uniform(ks, (b, 1, 1, 1), minval=std_range[0], maxval=std_range[1]))
    noise = _t(jax.random.normal(kn2, (b, th, tw, 3)))
    apply, gumbel = _jax_masking_draws(km, b)
    return PT.SegDraws(offsets, flip, factors, std, noise, _t(apply < masking_p), _t(gumbel))


@pytest.mark.parametrize("p, keep, ids", [(1.0, 1, (0, 1, 2, 8, 10, 13, 255)), (1.0, 2, (0, 1, 2, 8, 10, 13, 255)),
                                          (0.5, 1, (0, 2, 6, 255)), (1.0, 1, (1, 3, 4, 255)),
                                          (1.0, 3, (1, 0))])
def test_class_wise_masking_matches_jax(p, keep, ids):
    """Bit-equal images and labels: masking on some examples, the fallback
    pool (no allowed class present: 1, 3, 4 are not), a label with fewer
    classes than `num_classes_to_keep`, and the 255 fill."""
    b, key = 6, jax.random.PRNGKey(int(p * 10) + keep)
    x = np.random.default_rng(1).uniform(0, 1, (b, 12, 10, 3)).astype(np.float32)
    y = _labels(b, 12, 10, 2, ids)
    ref_x, ref_y = JT.class_wise_masking(key, jnp.asarray(x), jnp.asarray(y), p, keep)
    apply, gumbel = _jax_masking_draws(key, b)
    got_x, got_y = PT.class_wise_masking(_t(x), _t(y), p, keep, apply=_t(apply < p), gumbel=_t(gumbel))
    assert got_y.dtype == torch.uint8 and np.array_equal(got_y.numpy(), np.asarray(ref_y))
    assert np.array_equal(got_x.numpy(), np.asarray(ref_x))
    if p == 1.0 and keep < len(ids) - 1:
        assert (got_y == 255).sum() > (_t(y) == 255).sum()  # something was blanked, to 255 and never to 0


def test_color_jitter_and_gaussian_noise_match_jax():
    key, b = jax.random.PRNGKey(3), 4
    x = np.random.default_rng(3).uniform(0, 1, (b, 9, 11, 3)).astype(np.float32)
    ref = JT.color_jitter(key, jnp.asarray(x), 0.3, 0.2, 0.4)
    factors = [_t(jax.random.uniform(k, (b, 1, 1, 1), minval=1.0 - a, maxval=1.0 + a))
               for k, a in zip(jax.random.split(key, 3), (0.3, 0.2, 0.4))]
    np.testing.assert_allclose(PT.color_jitter(_t(x), 0.3, 0.2, 0.4, factors=factors).numpy(), np.asarray(ref),
                               rtol=0, atol=1e-6)
    only_brightness = JT.color_jitter(key, jnp.asarray(x), 0.3, 0.0, 0.0)  # a zero amplitude skips its leg
    np.testing.assert_allclose(PT.color_jitter(_t(x), 0.3, 0.0, 0.0, factors=factors).numpy(),
                               np.asarray(only_brightness), rtol=0, atol=1e-6)
    ref = JT.add_gaussian_noise(key, jnp.asarray(x), 0.1, (0.0, 0.05))
    ks, kn = jax.random.split(key)
    std = _t(jax.random.uniform(ks, (b, 1, 1, 1), minval=0.0, maxval=0.05))
    got = PT.add_gaussian_noise(_t(x), 0.1, (0.0, 0.05), std=std, noise=_t(jax.random.normal(kn, x.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["random_crop", "random_hflip", "random_vflip"])
def test_paired_geometry_matches_jax(name):
    key, b = jax.random.PRNGKey(4), 5
    x, y = _images(b, 14, 18, 4), _labels(b, 14, 18, 5)
    if name == "random_crop":
        ref = JT.random_crop(key, jnp.asarray(x), (8, 9), labels=jnp.asarray(y))
        ky, kx = jax.random.split(key)
        offsets = (_t(jax.random.randint(ky, (b,), 0, 7)), _t(jax.random.randint(kx, (b,), 0, 10)))
        got = PT.random_crop(_t(x), (8, 9), offsets=offsets, labels=_t(y))
    else:
        ref = getattr(JT, name)(key, jnp.asarray(x), 0.5, labels=jnp.asarray(y))
        got = getattr(PT, name)(_t(x), 0.5, flip=_t(jax.random.uniform(key, (b,)) < 0.5), labels=_t(y))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("masking_p", [0.1, 1.0])
def test_seg_train_augment_replays_jax(masking_p):
    """The shipped chain (crop 16x16 of 20x30, hflip 0.5, jitter 0.2, noise
    0.1 + U[0, 0.05) std, masking) on JAX's draws: labels equal, images to
    1e-6 after the ImageNet normalization (a division by 0.225 scales the
    jitter's 1-ulp differences up to ~5e-7)."""
    key, b = jax.random.PRNGKey(7), 6
    x, y = _images(b, 20, 30, 7), _labels(b, 20, 30, 8)
    ref_x, ref_y = JT.seg_train_augment(key, jnp.asarray(x), jnp.asarray(y), crop=(16, 16), masking_p=masking_p)
    draws = _jax_seg_draws(key, b, (20, 30), (16, 16), masking_p=masking_p)
    got_x, got_y = PT.seg_train_augment(_t(x), _t(y), crop=(16, 16), masking_p=masking_p, draws=draws)
    assert got_x.dtype == torch.float32 and got_x.shape == (b, 16, 16, 3)
    assert np.array_equal(got_y.numpy(), np.asarray(ref_y))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0, atol=1e-6)


def test_seg_train_augment_draws_from_its_generator():
    """Without draws: a generator's stream, the same for the same seed, labels from the input's ids or 255."""
    x, y = _t(_images(4, 20, 30, 9)), _t(_labels(4, 20, 30, 10))
    a = PT.seg_train_augment(x, y, torch.Generator().manual_seed(0), crop=(16, 16), masking_p=0.5)
    b = PT.seg_train_augment(x, y, torch.Generator().manual_seed(0), crop=(16, 16), masking_p=0.5)
    c = PT.seg_train_augment(x, y, torch.Generator().manual_seed(1), crop=(16, 16), masking_p=0.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and not torch.equal(a[0], c[0])
    assert set(a[1].unique().tolist()) <= set(y.unique().tolist()) | {255}


@pytest.mark.parametrize("leg", [dict(scale_range=(0.5, 2.0)), dict(rotation_degrees=10.0), dict(hue=0.1)])
def test_seg_train_augment_refuses_the_geometric_legs_by_name(leg):
    """The geometric legs were refused by name until they were ported; each
    now runs (tests/test_torch_seg_geometric.py holds them against JAX) and
    changes the chain's output, and a leg the chain does not know is still
    refused by name."""
    x, y = _t(_images(2, 20, 30, 1)), _t(_labels(2, 20, 30, 1))
    plain = PT.seg_train_augment(x, y, torch.Generator().manual_seed(0), crop=(16, 16))
    got = PT.seg_train_augment(x, y, torch.Generator().manual_seed(0), crop=(16, 16), **leg)
    assert got[0].shape == plain[0].shape and not torch.equal(got[0], plain[0])
    assert set(got[1].unique().tolist()) <= set(y.unique().tolist()) | {255}
    with pytest.raises(TypeError, match="shear"):
        PT.seg_train_augment(x, y, crop=(16, 16), shear=5.0, **leg)


def test_seg_eval_preprocess_matches_jax():
    x, y = _images(3, 21, 30, 11), _labels(3, 21, 30, 12)
    ref_x, ref_y = JT.seg_eval_preprocess(jnp.asarray(x), jnp.asarray(y), crop=(16, 16))
    got_x, got_y = PT.seg_eval_preprocess(_t(x), _t(y), crop=(16, 16))
    assert np.array_equal(got_y.numpy(), np.asarray(ref_y))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(PT.seg_eval_preprocess(_t(x), crop=(16, 16)).numpy(), np.asarray(ref_x),
                               rtol=0, atol=1e-6)


def _acdc_tree(root, n_train=3, n_val=2, size=(37, 23)):
    rng = np.random.default_rng(13)
    for cond in ("fog", "rain", "snow"):
        for split, n in (("train", n_train), ("val", n_val)):
            for i in range(n):
                for top, kind in (("rgb_anon", "rgb_anon"), ("gt", "gt_labelIds")):
                    d = os.path.join(root, top, cond, split, f"GOPR{i % 2}")
                    os.makedirs(d, exist_ok=True)
                    arr = (rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8) if top == "rgb_anon"
                           else rng.choice(RAW_IDS, (size[1], size[0])))
                    Image.fromarray(arr).save(os.path.join(d, f"GOPR{i}_frame_{i:06d}_{kind}.png"))
    # an image without its label is skipped
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(os.path.join(root, "rgb_anon", "fog", "train", "GOPR0",
                                                                     "lonely_rgb_anon.png"))
    return root


@pytest.mark.parametrize("weather", [["fog", "rain"], "snow"])
def test_seg_paired_dataset_matches_jax(tmp_path, monkeypatch, weather):
    """The same pairs in the same order, and the same arrays: both datasets
    on their PIL path bit for bit, and the port's native decode (its first
    choice, as JAX's) within one level of it; labels always go through PIL."""
    from weatherconverter_tpu.data import native
    from weatherconverter_tpu_torch.data import native as port_native

    root = _acdc_tree(str(tmp_path))
    native_images = {}
    for split in ("train", "val"):
        got = PD.SegPairedDataset(root, split=split, weather=weather, resize_hw=(20, 28))
        native_images[split] = [got[i] for i in range(len(got))]
    monkeypatch.setattr(native, "decode_exact", lambda *a, **k: None)
    monkeypatch.setattr(port_native, "decode_exact", lambda *a, **k: None)
    for split in ("train", "val"):
        ref = JD.SegPairedDataset(root, split=split, weather=weather, resize_hw=(20, 28))
        got = PD.SegPairedDataset(root, split=split, weather=weather, resize_hw=(20, 28))
        assert len(got) == len(ref) > 0 and got.image_paths == ref.image_paths and got.label_paths == ref.label_paths
        for i in range(len(got)):
            (gi, gl), (ri, rl) = got[i], ref[i]
            assert gi.dtype == np.uint8 and gi.shape == (20, 28, 3) and gl.dtype == np.uint8 and gl.shape == (20, 28)
            assert np.array_equal(gi, ri) and np.array_equal(gl, rl)
            assert set(np.unique(gl)) <= {0, 1, 2, 3, 4, 255}
            ni, nl = native_images[split][i]
            assert np.abs(ni.astype(np.int16) - gi.astype(np.int16)).max() <= 1 and np.array_equal(nl, gl)
    path = str(got.image_paths[0])
    assert np.array_equal(PD.load_image_exact(path, (9, 13)), JD.load_image_exact(path, (9, 13)))


@pytest.mark.parametrize("path", [None, "configs/segmentation.yaml"])
def test_load_seg_config_matches_jax(path):
    path = path and os.path.join(REPO, path)
    ref, port = j_load_seg_config(path), load_seg_config(path)
    assert port.model_dump() == ref.model_dump()
    over = dict(training={"epochs": 3}, data={"root_dir": "x"})
    assert load_seg_config(path, **over).model_dump() == j_load_seg_config(path, **over).model_dump()


# --- the CLI: infer-seg against JAX's, train-seg on the CPU ---

SEG_YAML = """
training: {random_seed: 0, epochs: 1, batch_size: 2, num_workers: 0, log_interval: 1}
data:
  transform: {resize_resolution: [23, 37], target_resolution: [16, 16]}
model: {name: deeplabv3plus_resnet18, num_classes: 5, output_stride: 16}
"""


def test_cli_infer_seg_matches_jax(tmp_path):
    """One .npz of JAX weights through both CLIs: pred.png, gradient_magnitude.png
    and panels.png. The prediction may differ where two logits tie to f32
    rounding (>= 0.99 of pixels equal); the gradient magnitude, min-max
    normalized and truncated to uint8, within one level; the other panels
    (the image, the denormalized input, the train-id plane and the colorized
    ground truth) equal."""
    (tmp_path / "s.yaml").write_text(SEG_YAML)
    _, variables, _ = seg_pair_from_shapes("deeplabv3plus_resnet18", 16, 5, seed=3)
    save_pytree_npz(str(tmp_path / "seg.npz"), variables)
    rng = np.random.default_rng(14)
    Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(tmp_path / "img.png")
    Image.fromarray(rng.choice(RAW_IDS, (40, 56))).save(tmp_path / "lbl.png")
    common = ["--config", str(tmp_path / "s.yaml"), "--checkpoint", str(tmp_path / "seg.npz"), "--image",
              str(tmp_path / "img.png"), "--label", str(tmp_path / "lbl.png")]
    assert PM.main(["infer-seg", *common, "--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    args = argparse.Namespace(config=common[1], checkpoint=common[3], image=common[5], label=common[7],
                              out=str(tmp_path / "jax"))
    assert JC.run_infer_seg(args) == 0
    png = lambda side, name: np.asarray(Image.open(tmp_path / side / f"{name}.png")).astype(int)  # noqa: E731
    assert (png("port", "pred") == png("jax", "pred")).all(-1).mean() >= 0.99
    assert np.abs(png("port", "gradient_magnitude") - png("jax", "gradient_magnitude")).max() <= 1
    got, ref = png("port", "panels"), png("jax", "panels")
    assert got.shape == ref.shape == (16, 96, 3)
    for k in (0, 1, 4, 5):
        assert np.array_equal(got[:, 16 * k:16 * (k + 1)], ref[:, 16 * k:16 * (k + 1)]), k


def test_cli_train_seg_then_infer_seg_on_its_best_step(tmp_path):
    (tmp_path / "s.yaml").write_text(SEG_YAML)
    root = _acdc_tree(str(tmp_path / "acdc"))
    out = tmp_path / "out"
    assert PM.main(["train-seg", "--config", str(tmp_path / "s.yaml"), "--max-steps", "2", "--device", "cpu",
                    "--set", f"data.root_dir={root}", f"folders.output={out}"]) == 0
    ck = out / "0" / "checkpoints"
    assert (ck / "best.json").is_file() and (out / "0" / "metrics.jsonl").is_file()
    assert PM.main(["infer-seg", "--config", str(tmp_path / "s.yaml"), "--checkpoint", str(ck), "--image",
                    os.path.join(root, "rgb_anon", "fog", "val", "GOPR0", "GOPR0_frame_000000_rgb_anon.png"),
                    "--out", str(tmp_path / "inf"), "--device", "cpu"]) == 0
    assert np.asarray(Image.open(tmp_path / "inf" / "pred.png")).shape == (16, 16, 3)
    assert not (tmp_path / "inf" / "panels.png").exists()  # no --label, no gradient probe
