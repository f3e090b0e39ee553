"""The port's `visualize` and `translate --debug-dir` on the CPU with the tiny
configs of tests/test_torch_cli.py.

visualize writes JAX's four PNGs, each a strip of its frames. translate
--debug-dir writes JAX's file set (cli/commands.py:187-257) and an output
equal, byte for byte, to the plain translate's with the same seed: its
chain runs in segments through sample_with_sgg's xt_init / t_offset.
"""

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_cli import DIFFUSION_YAML, TINY_YAML

from weatherconverter_tpu_torch.cli import main as PM


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for the tiny models, as tests/test_torch_cli.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_debug")
    (d / "t.yaml").write_text(TINY_YAML)
    (d / "d.yaml").write_text(DIFFUSION_YAML)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(d / "img.png")
    Image.fromarray(rng.integers(0, 34, (40, 40), dtype=np.uint8)).save(d / "lbl.png")
    return d


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def test_cli_visualize_writes_its_four_strips(tiny, tmp_path):
    """The tiny schedule has T = 20: --every 5 gives frames at t = 0, 5, 10,
    15 forward and after steps 0, 5, 10, 15 backward; each gallery has the
    original and four variants; 16 px frames side by side."""
    out = tmp_path / "strips"
    assert PM.main(["visualize", "--config", str(tiny / "d.yaml"), "--image", str(tiny / "img.png"), "--out",
                    str(out), "--every", "5", "--device", "cpu"]) == 0
    shapes = {name: _png(out / f"{name}.png").shape
              for name in ("forward", "backward", "aug_photometric", "aug_geometric")}
    assert shapes == {"forward": (16, 64, 3), "backward": (16, 64, 3), "aug_photometric": (16, 80, 3),
                      "aug_geometric": (16, 80, 3)}
    forward = _png(out / "forward.png")
    assert not np.array_equal(forward[:, :16], forward[:, 48:])  # the noise grows along the strip


def test_cli_translate_debug_dir_writes_jax_files_and_the_plain_output(tiny, tmp_path):
    common = ["translate", "--config", str(tiny / "t.yaml"), "--image", str(tiny / "img.png"), "--label",
              str(tiny / "lbl.png"), "--steps", "3", "--seed", "4", "--device", "cpu"]
    assert PM.main(common + ["--out", str(tmp_path / "plain.png")]) == 0
    dbg = tmp_path / "dbg"
    assert PM.main(common + ["--out", str(tmp_path / "traced.png"), "--debug-dir", str(dbg), "--debug-every",
                             "2"]) == 0
    # JAX's names at --steps 3 --debug-every 2: segments end after steps 2 and 0
    assert sorted(p.name for p in dbg.iterdir()) == sorted(
        ["input.png", "gt.png", "xt_3_noised.png", "xt_2.png", "xt_0.png", "sr_x0.png", "sr_x0_pred.png"])
    assert (tmp_path / "traced.png").read_bytes() == (tmp_path / "plain.png").read_bytes()
    # debug_tensor's grids: one image in a 2 px border; the 32 px SR output and label maps colorized
    assert _png(dbg / "input.png").shape == _png(dbg / "xt_0.png").shape == (20, 20, 3)
    assert _png(dbg / "gt.png").shape == _png(dbg / "sr_x0_pred.png").shape == (36, 36, 3)
    assert np.array_equal(_png(dbg / "sr_x0.png"), _png(tmp_path / "plain.png"))
