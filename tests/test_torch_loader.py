"""The port's host feed against the JAX package's, on the CPU:
data/loader.py (JAX's index order, the prefetching producer, its error and
shutdown paths), data/native.py (the batch decoder built from
native/wcdecode.cpp into the port's _build directory) and core/rng.py's
epoch_keys and key_stream."""

import hashlib
import itertools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from weatherconverter_tpu.data.loader import DataLoader as JDataLoader
from weatherconverter_tpu_torch.core import rng
from weatherconverter_tpu_torch.data import datasets as PDS
from weatherconverter_tpu_torch.data import native
from weatherconverter_tpu_torch.data.loader import DataLoader, infinite_batches
from weatherconverter_tpu_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Indexed:
    """Item i is a (2, 2, 3) uint8 image holding i, so a batch reads back its indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, dtype=np.uint8)


class _Mesh:
    """The two methods parallel.sharding reads of a ("data",) DeviceMesh, for rank `rank` of `width`."""

    def __init__(self, width, rank):
        self.width, self.rank = width, rank

    def size(self):
        return self.width

    def get_local_rank(self):
        return self.rank


def _order(loader):
    return [b[:, 0, 0, 0].tolist() for b in loader]


@pytest.mark.parametrize("accum", [1, 2])
def test_order_matches_jax_for_three_epochs(accum):
    """Epochs 0-2 of the port's loader (parallel.sharding.loader, as the
    training loops build it) are JAX's `_index_batches` for the same seed:
    with no mesh, and each rank's rows at width 2 (`local_rows`)."""
    n, batch, seed = 21, 4, 7
    ref = JDataLoader(Indexed(n), batch, shuffle=True, seed=seed)
    single = sharding.loader(Indexed(n), batch, None, shuffle=True, seed=seed, accum_steps=accum)
    ranks = [sharding.loader(Indexed(n), batch, _Mesh(2, r), shuffle=True, seed=seed, accum_steps=accum)
             for r in range(2)]
    assert len(single) == len(ref) == n // batch
    for epoch in range(3):
        want = [b.tolist() for b in ref._index_batches()]
        ref.epoch += 1
        assert _order(single) == want, epoch
        rows = [sharding.local_rows(batch, _Mesh(2, r), accum) for r in range(2)]
        for r, loader in enumerate(ranks):
            assert _order(loader) == [[b[i] for i in rows[r]] for b in want], (epoch, r)
    assert sorted(rows[0] + rows[1]) == list(range(batch))


def test_infinite_batches_reshuffles():
    n, batch = 12, 4
    stream = infinite_batches(DataLoader(Indexed(n), batch, seed=3))
    got = [next(stream)[:, 0, 0, 0].tolist() for _ in range(2 * n // batch)]
    ref = JDataLoader(Indexed(n), batch, seed=3)
    want = [b.tolist() for b in ref._index_batches()]
    ref.epoch += 1
    want += [b.tolist() for b in ref._index_batches()]
    assert got == want and got[:3] != got[3:]
    assert sorted(sum(got[:3], [])) == sorted(sum(got[3:], [])) == list(range(n))


def test_batches_are_tensors_and_ragged_batches_pad():
    """uint8 tensors, tuples of them for pairs; drop_last=False keeps a ragged
    last batch, and `pad_ragged` pads it to the global size with (index,
    is_pad) keys."""

    class Pairs(Indexed):
        def __getitem__(self, key):
            i, pad = key if isinstance(key, tuple) else (key, False)
            return np.full((2, 2, 3), i, np.uint8), np.full((2, 2), 255 if pad else i, np.uint8)

    batches = list(DataLoader(Pairs(5), 2, shuffle=False, drop_last=False))
    assert [tuple(b[0].shape) for b in batches] == [(2, 2, 2, 3), (2, 2, 2, 3), (1, 2, 2, 3)]
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.uint8 for b in batches for t in b)
    padded = list(DataLoader(Pairs(5), 2, shuffle=False, drop_last=False, pad_ragged=True, rows=[1]))
    assert [b[0][:, 0, 0, 0].tolist() for b in padded] == [[1], [3], [4]]
    assert [b[1][:, 0, 0].tolist() for b in padded] == [[1], [3], [255]]
    with pytest.raises(ValueError, match="needs pad_ragged"):
        list(DataLoader(Pairs(5), 2, shuffle=False, drop_last=False, rows=[1]))


def test_producer_error_reaches_the_consumer():
    class Bad(Indexed):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("truncated image")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="truncated image"):
        for _ in DataLoader(Bad(8), 4, shuffle=False, num_workers=2):
            pass


def test_break_mid_epoch_leaves_no_live_thread():
    """The consumer stops with the prefetch queue full: the producer and its
    pool exit."""
    before = set(threading.enumerate())
    loader = DataLoader(Indexed(64), 4, shuffle=False, num_workers=2, prefetch=2)
    for _ in loader:
        time.sleep(0.2)  # the queue fills
        break
    deadline = time.time() + 5.0
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.02)
    assert not set(threading.enumerate()) - before, "producer thread leaked"


def test_get_batch_is_the_fast_path_and_none_falls_back_to_the_pool():
    class Batched(Indexed):
        def __init__(self, n, answer):
            super().__init__(n)
            self.answer, self.calls, self.items = answer, [], 0

        def get_batch(self, indices):
            self.calls.append(list(indices))
            return np.stack([np.full((2, 2, 3), 100 + i, np.uint8) for i in indices]) if self.answer else None

        def __getitem__(self, i):
            self.items += 1
            return super().__getitem__(i)

    fast = Batched(8, True)
    assert _order(DataLoader(fast, 4, shuffle=False)) == [[100, 101, 102, 103], [104, 105, 106, 107]]
    assert fast.calls == [[0, 1, 2, 3], [4, 5, 6, 7]] and fast.items == 0
    slow = Batched(8, False)
    assert _order(DataLoader(slow, 4, shuffle=False)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert len(slow.calls) == 2 and slow.items == 8


def test_training_loops_build_no_torch_dataloader():
    for name in ("loop_diffusion", "loop_segmentation", "loop_srgan"):
        with open(os.path.join(REPO, "weatherconverter_tpu_torch", "training", f"{name}.py")) as f:
            assert "torch.utils.data" not in f.read(), name


# ---------------------------------------------------------------------------
# the native decoder
# ---------------------------------------------------------------------------


@pytest.fixture()
def images(tmp_path):
    rs = np.random.RandomState(0)
    paths = []
    for i, size in enumerate([(40, 64), (64, 40), (33, 57)]):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(rs.randint(0, 255, size + (3,), dtype=np.uint8)).save(p)
        paths.append(p)
    jp = str(tmp_path / "img.jpg")
    Image.fromarray(rs.randint(0, 255, (48, 80, 3), dtype=np.uint8)).save(jp, quality=95)
    return paths + [jp]


def test_native_builds_into_the_port_and_leaves_native_alone():
    """The port compiles native/wcdecode.cpp with g++ into its own _build
    directory, stamped with the source's hash; the tracked
    native/libwcdecode.so keeps its bytes and `git status native/` stays clean."""
    so = os.path.join(REPO, "native", "libwcdecode.so")

    def digest():
        with open(so, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    def status():
        return subprocess.run(["git", "status", "--porcelain", "native/"], cwd=REPO, capture_output=True,
                              text=True).stdout

    before, st = digest(), status()
    assert not native.missing_headers()
    path = native.build(force=True)
    assert path == native.LIBRARY and path.startswith(os.path.join(REPO, "weatherconverter_tpu_torch", "_build"))
    with open(path + ".srchash") as f:
        assert f.read().strip() == hashlib.sha256(open(native.SOURCE, "rb").read()).hexdigest()
    assert native.available() and native.unavailable_reason() is None
    assert native.describe().startswith("decoder: native")
    assert digest() == before and status() == st


def test_concurrent_first_builds_all_load(tmp_path):
    """Three processes reaching their first decode together in a fresh
    build directory (data-parallel ranks, test workers): one compiles, the
    others wait on the lock and find its stamp; every one loads the library."""
    lib = str(tmp_path / "_build" / "libwcdecode.so")
    code = ("import sys; from weatherconverter_tpu_torch.data import native; native.LIBRARY = sys.argv[1]; "
            "native.build(); print(native.available(), native.unavailable_reason())")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WCTPU_NO_NATIVE", None)
    env.pop("WCTPU_NATIVE_REBUILD", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, lib], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=native.BUILD_TIMEOUT_S) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == ["True None"] * 3
    with open(lib + ".srchash") as f:
        assert f.read().strip() == hashlib.sha256(open(native.SOURCE, "rb").read()).hexdigest()
    assert sorted(os.listdir(tmp_path / "_build")) == ["libwcdecode.so", "libwcdecode.so.lock",
                                                        "libwcdecode.so.srchash"]


def test_decode_box_within_one_level_of_pil(images):
    for p in images:
        ours = native.decode_box(p, 32, (32, 57))
        ref = PDS.load_image_resized(p, 32, (32, 57))
        assert ours is not None and ours.shape == ref.shape == (32, 57, 3)
        assert np.abs(ours.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    exact = native.decode_exact(images[0], (20, 30))
    assert np.abs(exact.astype(np.int32) - PDS.load_image_exact(images[0], (20, 30)).astype(np.int32)).max() <= 1


def test_batch_equals_singles_and_missing_files(images, tmp_path):
    out = native.decode_box_batch(images, 32, (32, 57))
    assert out is not None and out.shape == (len(images), 32, 57, 3)
    for i, p in enumerate(images):
        np.testing.assert_array_equal(out[i], native.decode_box(p, 32, (32, 57)))
    exact = native.decode_exact_batch(images, (20, 30))
    for i, p in enumerate(images):
        np.testing.assert_array_equal(exact[i], native.decode_exact(p, (20, 30)))
    missing = str(tmp_path / "nope.png")
    assert native.decode_box(missing, 32, (32, 32)) is None
    assert native.decode_box_batch([images[0], missing], 32, (32, 32)) is None


def test_fast_is_bit_equal_on_png(images):
    """fast=True (JPEG DCT pre-scaling) changes nothing on PNG; on JPEG it
    decodes, and a batch equals its singles."""
    for p in images[:3]:
        np.testing.assert_array_equal(native.decode_box(p, 32, (32, 57), fast=True), native.decode_box(p, 32, (32, 57)))
    jpg = native.decode_box(images[3], 16, (16, 28), fast=True)
    assert jpg is not None and jpg.shape == (16, 28, 3)
    np.testing.assert_array_equal(native.decode_box_batch([images[3]] * 2, 16, (16, 28), fast=True)[1], jpg)


def _tree(tmp_path, images):
    root = tmp_path / "tree"
    for i, p in enumerate(images):
        dst = root / "rain" / "train" / f"{i}.png"
        dst.parent.mkdir(parents=True, exist_ok=True)
        Image.open(p).convert("RGB").save(dst)
    return str(root)


def test_dataset_batches_through_the_loader(images, tmp_path):
    """DiffusionImageDataset's get_batch is the native batch decode, and the
    loader ships it as is."""
    ds = PDS.DiffusionImageDataset(_tree(tmp_path, images), ("rain",), resize_to=32)
    batches = list(DataLoader(ds, 2, shuffle=False))
    assert len(batches) == 2 and tuple(batches[0].shape) == (2, 32, 57, 3)
    want = native.decode_box_batch(ds.img_paths[:2], 32, ds.out_wh)
    np.testing.assert_array_equal(batches[0].numpy(), want)
    np.testing.assert_array_equal(ds[1], want[1])


def test_without_native_the_datasets_decode_with_pil(images, tmp_path, monkeypatch):
    """WCTPU_NO_NATIVE=1: every function returns None, the reason says why,
    and the dataset's images are PIL's, bit for bit (get_batch None: the
    loader's pool decodes)."""
    monkeypatch.setenv("WCTPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_STATE", native._Native())
    assert not native.available() and native.unavailable_reason() == "WCTPU_NO_NATIVE=1"
    assert native.describe() == "decoder: PIL (native decoder unavailable: WCTPU_NO_NATIVE=1)"
    assert native.decode_box(images[0], 32, (32, 57)) is None and native.decode_exact_batch(images, (8, 8)) is None
    ds = PDS.DiffusionImageDataset(_tree(tmp_path, images), ("rain",), resize_to=32)
    assert ds.get_batch([0, 1]) is None
    batch = next(iter(DataLoader(ds, 2, shuffle=False)))
    np.testing.assert_array_equal(batch[1].numpy(), PDS.load_image_resized(ds.img_paths[1], 32, ds.out_wh))


def test_a_missing_compiler_is_a_reason(monkeypatch):
    monkeypatch.setattr(native, "_STATE", native._Native())
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    monkeypatch.setenv("WCTPU_NATIVE_REBUILD", "1")
    assert native.missing_headers() == list(native.HEADERS)
    assert not native.available() and "no C++ compiler" in native.unavailable_reason()


# ---------------------------------------------------------------------------
# rng
# ---------------------------------------------------------------------------


def test_epoch_keys_and_key_stream_are_stable_and_distinct():
    keys = rng.epoch_keys(rng.run_key(3), 4)
    stream = list(itertools.islice(rng.key_stream(rng.run_key(3)), 4))
    assert keys == rng.epoch_keys(3, 4) and stream == list(itertools.islice(rng.key_stream(3), 4))
    named = [g.initial_seed() for g in rng.split_named(3, "a", "b", "c", "d").values()]
    assert len(set(keys + stream + named)) == 12
    assert all(isinstance(k, int) and 0 <= k < 2 ** 63 for k in keys + stream)
    assert rng.epoch_keys(4, 4) != keys and rng.epoch_keys(3, 2) == keys[:2]


def test_host_feed_probe_times_each_decoder_path(tmp_path):
    """probes/host_feed.py at a tiny size: every epoch sees the whole dataset
    by each path and format, and native stays within one level of PIL."""
    from weatherconverter_tpu_torch.probes import host_feed

    r = host_feed.measure(str(tmp_path), files=8, size=(96, 54), epochs=2, workers=2)
    assert sorted(r["rates"]) == sorted(f"{path}, {fmt}" for path in ("native batch decode (get_batch)",
                                                                        "PIL on the loader's 2 threads")
                                        for fmt in ("PNG", "JPG"))
    assert all(len(v) == 2 and min(v) > 0 for v in r["rates"].values())
    assert r["images_an_epoch"] == 8 and r["native_vs_pil_levels"] <= 1
    assert r["decoder"].startswith("decoder: native")
