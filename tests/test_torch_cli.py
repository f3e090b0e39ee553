"""The port's CLI (weatherconverter_tpu_torch/cli) and the helpers it
brought over (data/labels.py, utils/images.py) against the JAX package, on
the CPU with tiny models.

Equal bit for bit to JAX's own: the label lookups, the image loader, the
uint8 conversion and the PNG bytes of a saved grid, the --lcg-present-k
resolution, and the parser's subcommands, dests, defaults and choices (the
port adds `--device` and nothing else). A JAX .npz and a reference-layout
torch file load into the port with strict=True and give the weights they
hold exactly. The commands run end to end with `--device cpu`; without it,
on a machine without a card, they stop with a message.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import perturb

from weatherconverter_tpu.cli import commands as JC
from weatherconverter_tpu.cli import main as JM
from weatherconverter_tpu.core.checkpoint import save_pytree_npz
from weatherconverter_tpu.data import labels as JL
from weatherconverter_tpu.utils import images as JI
from weatherconverter_tpu_torch.cli import commands as PC
from weatherconverter_tpu_torch.cli import main as PM
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core.config import UnetModelConfig, load_translation_config
from weatherconverter_tpu_torch.data import labels as PL
from weatherconverter_tpu_torch.utils import images as PI

# the JAX serving tests' tiny translation config, on the port's seg model (DeepLabV3+) with the 19 train classes
# the labels hold
TINY_YAML = """
diffusion:
  model:
    im_size: 16
    down_channels: [8, 16, 24]
    mid_channels: [24, 24, 16]
    down_sample: [true, false]
    time_emb_dim: 16
    num_down_layers: 1
    num_mid_layers: 1
    num_up_layers: 1
    num_heads: 2
    attn_resolutions: [8]
  diffusion:
    num_timesteps: 20
seg:
  model: {name: deeplabv3plus_resnet18, num_classes: 19, output_stride: 16}
srgan: {in_channels: 3, num_channels: 8, num_blocks: 1, upscale_factor: 2}
guidance: {lambda: 10.0, num_steps: 3, mode: fixed}
"""
# the same UNet and schedule as a diffusion config (sample, train-ddpm)
DIFFUSION_YAML = """
model: {im_size: 16, down_channels: [8, 16, 24], mid_channels: [24, 24, 16], down_sample: [true, false],
        time_emb_dim: 16, num_down_layers: 1, num_mid_layers: 1, num_up_layers: 1, num_heads: 2,
        attn_resolutions: [8]}
diffusion: {num_timesteps: 20}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: more buy nothing here,
    and beside the suite's other parallel workers they oversubscribe the cores
    (a 2 s test of this file took 280 s that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    (d / "t.yaml").write_text(TINY_YAML)
    (d / "d.yaml").write_text(DIFFUSION_YAML)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(d / "img.png")
    Image.fromarray(rng.integers(0, 34, (40, 40), dtype=np.uint8)).save(d / "lbl.png")
    return d


# --- the helpers, bit for bit ---

def test_label_tables_and_lookups_equal_jax():
    assert PL.LABELS == JL.LABELS and PL.get_train_ids() == JL.get_train_ids()
    assert np.array_equal(PL.ID_TO_TRAIN_ID, JL.ID_TO_TRAIN_ID)
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    enc = PL.encode_target(ids)
    assert enc.dtype == np.uint8 and np.array_equal(enc, JL.encode_target(ids))
    assert set(np.unique(enc)) == set(range(19)) | {255}  # ignored ids fill with 255, never 0
    assert np.array_equal(PL.decode_target(enc), JL.decode_target(enc))


def test_load_image_equals_jax(tiny):
    for size in (16, 33):
        got = PC._load_image(str(tiny / "img.png"), size)
        assert got.dtype == np.float32 and np.array_equal(got, JC._load_image(str(tiny / "img.png"), size))


@pytest.mark.parametrize("from_range", ["pm1", "unit"])
def test_uint8_image_and_saved_png_bytes_equal_jax(tmp_path, from_range):
    x = np.random.default_rng(1).uniform(-1.3, 1.3, (5, 6, 7, 3)).astype(np.float32)
    x[0, 0, 0] = [0.5 / 255, 1.0, -1.0]  # truncation, the two rails
    want = JI.to_uint8_image(jnp.asarray(x), from_range)
    assert np.array_equal(PI.to_uint8_image(torch.from_numpy(x), from_range), want)
    assert np.array_equal(PI.to_uint8_image(x, from_range), want)
    assert np.array_equal(PI.make_grid(want, nrow=2), JI.make_grid(want, nrow=2))
    ours, theirs = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    PI.save_images(torch.from_numpy(x), ours, nrow=3, from_range=from_range)
    JI.save_images(jnp.asarray(x), theirs, nrow=3, from_range=from_range)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_resolve_lcg_present_k_equals_jax():
    gt = np.full((8, 8), 255, np.uint8)
    gt[:2], gt[2:4, :3], gt[5] = 3, 7, 11
    for spec in (None, "off", "auto", "1", "5", "19"):
        assert PC._resolve_lcg_present_k(spec, gt, 19) == JC._resolve_lcg_present_k(spec, gt, 19)
    assert PC._resolve_lcg_present_k("auto", np.full((4, 4), 255), 19) == 1
    for bad in ("x", "0", "20"):
        with pytest.raises(SystemExit):
            PC._resolve_lcg_present_k(bad, gt, 19)


# --- the parser ---

def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _flags(sub):
    return {a.dest: (a.default, tuple(a.choices) if a.choices else None, a.required, tuple(a.option_strings))
            for a in sub._actions if not isinstance(a, argparse._HelpAction)}


# the defaults that must differ, by name: export-hlo writes a torch.export archive, not StableHLO text
DIFFERING_DEFAULTS = {("export-hlo", "out"): ("outputs/translate.stablehlo.mlir", "outputs/translate.pt2")}


def test_parser_has_jax_subcommands_dests_defaults_and_choices():
    ours, theirs = _subparsers(PM.build_parser()), _subparsers(JM.build_parser())
    assert list(ours) == list(theirs)
    for name in theirs:
        mine, jax_flags = _flags(ours[name]), _flags(theirs[name])
        assert mine.pop("device") == ("cuda", ("cuda", "cpu"), False, ("--device",)), name
        for (command, dest), (jax_default, port_default) in DIFFERING_DEFAULTS.items():
            if command == name:
                assert (jax_flags[dest][0], mine[dest][0]) == (jax_default, port_default)
                mine[dest] = jax_flags[dest]
        assert mine == jax_flags, name
    assert PM.parse_overrides(["a.b=1", "a.c=[1, 2]", "d=x"]) == JM.parse_overrides(["a.b=1", "a.c=[1, 2]", "d=x"])


@pytest.mark.parametrize("command, item", [("train-srgan", "item 15"), ("quality", "item 15"),
                                           ("export-hlo", "item 10"), ("visualize", "item 19")])
def test_unported_subcommands_exit_nonzero_naming_their_item(command, item, capsys):
    """train-srgan and quality (item 15), visualize (item 19) and export-hlo
    (item 10) are ported: like every ported command they run on the card by
    default and, without one, exit non-zero saying so (their CPU runs:
    tests/test_torch_srgan_training.py, test_cli_quality_on_the_cpu below,
    tests/test_torch_cli_debug.py and tests/test_torch_export.py). No
    subcommand is refused any more: the CLI's table of refusals is gone."""
    argv = [command] + (["--image", "x.png"] if command == "visualize" else [])
    assert not hasattr(PM, "NOT_PORTED")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            PM.main(argv)


# a tiny seg config: ResNet-18 at 16 px crops of 24 x 40 images, the 19 train classes the labels hold
SEG_YAML = """
training: {random_seed: 0, epochs: 1, batch_size: 2, num_workers: 0, log_interval: 1}
data:
  weather: [fog]
  transform: {resize_resolution: [24, 40], target_resolution: [16, 16]}
model: {name: deeplabv3plus_resnet18, num_classes: 19, output_stride: 16}
"""


@pytest.mark.parametrize("command", ["train-seg", "infer-seg"])
def test_seg_subcommands_run_on_the_cpu(command, tiny, tmp_path):
    """The two subcommands the seg slice freed from the table above: each
    runs to exit 0 with --device cpu and writes what it should."""
    (tmp_path / "s.yaml").write_text(SEG_YAML)
    if command == "train-seg":
        for split in ("train", "val"):
            for kind, src in (("rgb_anon", "img.png"), ("gt", "lbl.png")):
                d = tmp_path / "acdc" / kind / "fog" / split
                os.makedirs(d, exist_ok=True)
                for i in range(2):
                    suffix = "rgb_anon" if kind == "rgb_anon" else "gt_labelIds"
                    (d / f"f{i}_{suffix}.png").write_bytes((tiny / src).read_bytes())
        assert PM.main(["train-seg", "--config", str(tmp_path / "s.yaml"), "--max-steps", "1", "--device", "cpu",
                        "--set", f"data.root_dir={tmp_path / 'acdc'}", f"folders.output={tmp_path / 'out'}"]) == 0
        assert (tmp_path / "out" / "0" / "checkpoints" / "best.json").is_file()
    else:
        assert PM.main(["infer-seg", "--config", str(tmp_path / "s.yaml"), "--image", str(tiny / "img.png"),
                        "--label", str(tiny / "lbl.png"), "--out", str(tmp_path / "seg"), "--device", "cpu"]) == 0
        assert _png(tmp_path / "seg" / "panels.png").shape == (16, 96, 3)
        assert _png(tmp_path / "seg" / "gradient_magnitude.png").shape == (16, 16)


def test_commands_need_a_card_unless_device_cpu(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["sample", "--config", str(tiny / "d.yaml")],
                 ["translate", "--config", str(tiny / "t.yaml"), "--image", "i", "--label", "l"],
                 ["super-resolve", "--image", "i"], ["train-ddpm"], ["serve"], ["train-seg"],
                 ["infer-seg", "--image", "i"], ["sample", "--sampler", "legacy", "--config", str(tiny / "d.yaml")],
                 ["quality", "--config", str(tiny / "t.yaml")], ["visualize", "--image", "i"],
                 ["export-hlo", "--config", str(tiny / "t.yaml")]):
        with pytest.raises(SystemExit, match="--device cpu"):
            PM.main(argv)


# --- checkpoints ---

# the tiny configs' UNet
SMALL_UNET = dict(im_size=16, down_channels=[8, 16, 24], mid_channels=[24, 24, 16], down_sample=[True, False],
                  time_emb_dim=16, num_down_layers=1, num_mid_layers=1, num_up_layers=1, num_heads=2,
                  attn_resolutions=[8])


def _jax_unet_params(cfg):
    from weatherconverter_tpu.core.config import UnetModelConfig as JCfg
    from weatherconverter_tpu.models.unet import Unet as JUnet

    junet = JUnet(config=JCfg(**cfg), fused=True)
    size = cfg["im_size"]
    init = jax.jit(junet.init)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jnp.zeros((1,), jnp.int32))["params"]
    return perturb(params, 2)


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_jax_npz_and_reference_torch_files_load_strict(tmp_path):
    cfg = UnetModelConfig(**SMALL_UNET)
    params = _jax_unet_params(SMALL_UNET)
    want = from_jax.unet_state_dict(params, cfg)
    save_pytree_npz(str(tmp_path / "unet.npz"), params)
    assert _equal(PC.load_unet(cfg, str(tmp_path / "unet.npz"), seed=9).state_dict(), want)
    for wrapper in ("model_state_dict", "state_dict", "model", None):
        path = str(tmp_path / f"unet_{wrapper}.pth")
        torch.save(want if wrapper is None else {wrapper: want, "epoch": 3}, path)
        assert _equal(PC.load_unet(cfg, path, seed=9).state_dict(), want)
    bad = dict(want)
    bad.pop(next(iter(bad)))
    torch.save(bad, tmp_path / "short.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        PC.load_unet(cfg, str(tmp_path / "short.pt"), seed=9)


def test_seg_and_srgan_npz_load_strict(tmp_path):
    from torch_parity import generator_pair, seg_pair

    cfg = load_translation_config(None, seg=dict(model=dict(name="deeplabv3plus_resnet18")),
                                  srgan=dict(num_blocks=2, upscale_factor=2))
    _, seg_vars, port_seg = seg_pair("deeplabv3plus_resnet18", 32)
    save_pytree_npz(str(tmp_path / "seg.npz"), seg_vars)
    assert _equal(PC.load_seg_model(cfg.seg, str(tmp_path / "seg.npz"), seed=1).state_dict(), port_seg.state_dict())
    _, gen_vars, port_gen = generator_pair(2)
    save_pytree_npz(str(tmp_path / "gen.npz"), gen_vars)
    assert _equal(PC.load_srgan(cfg.srgan, str(tmp_path / "gen.npz"), seed=1).state_dict(), port_gen.state_dict())
    torch.save({"model": port_gen.state_dict()}, tmp_path / "gen.pth.tar")  # the reference's SRGAN file
    assert _equal(PC.load_srgan(cfg.srgan, str(tmp_path / "gen.pth.tar"), seed=1).state_dict(), port_gen.state_dict())


def test_training_run_directory_prefers_the_ema_and_orbax_is_refused(tmp_path):
    from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager
    from weatherconverter_tpu_torch.models.unet import Unet
    from weatherconverter_tpu_torch.training.diffusion import create_ddpm_state

    cfg = UnetModelConfig(**SMALL_UNET)
    state = create_ddpm_state(Unet(cfg), ema_decay=0.9)
    for p in state.ema.params.values():
        p.add_(1.0)
    CheckpointManager(str(tmp_path / "run")).save(4, state)
    got = PC.load_unet(cfg, str(tmp_path / "run"), seed=5).state_dict()
    assert _equal({k: got[k] for k in state.ema.params}, state.ema.params)
    os.makedirs(tmp_path / "orbax" / "7")
    (tmp_path / "orbax" / "7" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(SystemExit, match="Orbax"):
        PC.load_unet(cfg, str(tmp_path / "orbax"), seed=5)


# --- the commands, end to end on the CPU ---

def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm"])
def test_cli_translate_on_the_cpu(tiny, tmp_path, sampler):
    out = tmp_path / "t.png"
    argv = ["translate", "--config", str(tiny / "t.yaml"), "--image", str(tiny / "img.png"), "--label",
            str(tiny / "lbl.png"), "--out", str(out), "--sampler", sampler, "--steps", "3", "--device", "cpu"]
    assert PM.main(argv) == 0
    first = _png(out)
    assert first.shape == (36, 36, 3)  # the 16 px latent through the 2x SRGAN, in a grid's 2 px border
    assert PM.main(argv) == 0 and np.array_equal(_png(out), first)  # one seed, one image
    if sampler != "ddpm":
        with pytest.raises(SystemExit, match="reference"):
            PM.main(argv + ["--mode", "reference"])


def test_cli_translate_refuses_debug_dir_and_legacy_by_name(tiny, tmp_path):
    """--debug-dir traces the DDPM chain (item 19; its run:
    tests/test_torch_cli_debug.py): with the few-step samplers it is
    refused, as JAX refuses it. The legacy sampler (item 15) refuses, by
    name, a checkpoint that is not a reference torch file, where JAX would
    go on with random weights."""
    for sampler in ("ddim", "dpm"):
        with pytest.raises(SystemExit, match="use --sampler ddpm"):
            PM.main(["translate", "--config", str(tiny / "t.yaml"), "--image", "i", "--label", "l", "--debug-dir",
                     str(tmp_path), "--sampler", sampler, "--device", "cpu"])
    with pytest.raises(SystemExit, match="legacy UNet loads a reference torch file"):
        PM.main(["sample", "--sampler", "legacy", "--config", str(tiny / "d.yaml"), "--checkpoint",
                 str(tmp_path / "w.npz"), "--device", "cpu"])


@pytest.mark.parametrize("sampler", ["ddpm", "dpm"])
def test_cli_sample_and_super_resolve_on_the_cpu(tiny, tmp_path, sampler):
    out = tmp_path / "s.png"
    assert PM.main(["sample", "--config", str(tiny / "d.yaml"), "--sampler", sampler, "--steps", "2", "--batch",
                    "3", "--out", str(out), "--device", "cpu"]) == 0
    assert _png(out).shape == (2 + 16 + 2, 4 * 18 + 2, 3)  # one row of a 4-wide grid, 2 px borders
    sr = tmp_path / "sr.png"
    assert PM.main(["super-resolve", "--config", str(tiny / "t.yaml"), "--image", str(tiny / "img.png"), "--out",
                    str(sr), "--device", "cpu"]) == 0
    assert _png(sr).shape == (80, 104, 3)


def test_cli_sample_legacy_on_the_cpu(tiny, tmp_path):
    """`sample --sampler legacy`: the legacy UNet at the config's im_size (16),
    seeded weights or a reference-layout torch file (with the reference's
    dead `res.weight` keys, which the loader drops), 2 strided steps; one
    seed, one image."""
    from weatherconverter_tpu_torch.models.unet_legacy import LegacyUNet

    out = tmp_path / "legacy.png"
    argv = ["sample", "--config", str(tiny / "d.yaml"), "--sampler", "legacy", "--steps", "2", "--batch", "2",
            "--out", str(out), "--device", "cpu"]
    assert PM.main(argv) == 0
    first = _png(out)
    assert first.shape == (2 + 16 + 2, 4 * 18 + 2, 3)
    assert PM.main(argv) == 0 and np.array_equal(_png(out), first)
    torch.manual_seed(5)
    sd = LegacyUNet(16).state_dict()
    for key in from_jax.dead_legacy_keys():
        sd[key] = torch.zeros(1)  # present in the reference's file, never applied
    torch.save({"model_state_dict": sd}, tmp_path / "old.ckpt")
    assert PM.main(argv + ["--checkpoint", str(tmp_path / "old.ckpt")]) == 0
    assert not np.array_equal(_png(out), first)


@pytest.mark.parametrize("fid", ["backbone", "inception"])
def test_cli_quality_on_the_cpu(tiny, tmp_path, fid):
    """`quality --synthetic 4 --batch 2 --steps 2`: the report's keys are the
    JAX command's, its numbers finite; the FID on the seg backbone's pooled
    features, or on InceptionV3 pool3 from a seeded torchvision-layout .pth
    (AuxLogits included: the loader drops them, and fc)."""
    import json

    from weatherconverter_tpu_torch.models.inception import InceptionV3

    argv = ["quality", "--config", str(tiny / "t.yaml"), "--synthetic", "4", "--batch", "2", "--steps", "2",
            "--out", str(tmp_path / "q.json"), "--device", "cpu"]
    if fid == "inception":
        torch.manual_seed(6)
        sd = InceptionV3(classify=True).state_dict()
        sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
        torch.save(sd, tmp_path / "inception.pth")
        argv += ["--inception-checkpoint", str(tmp_path / "inception.pth")]
    assert PM.main(argv) == 0
    report = json.loads((tmp_path / "q.json").read_text())
    assert list(report) == ["data", "weights", "guidance", "steps", "fid_kind", "fid_original_vs_translated",
                            "miou_original", "miou_translated", "miou_consistency_gap"]
    assert report["fid_kind"] == ("inception_v3_pool3" if fid == "inception"
                                  else "seg_backbone_pooled (relative tracking only)")
    assert report["data"] == "synthetic (seeded random, n=4)" and report["steps"] == 2
    numbers = [report[k] for k in ("fid_original_vs_translated", "miou_original", "miou_translated")]
    # finite; not necessarily >= 0: 4 samples give rank-3 covariances in 2048 dims, where the clamped square
    # roots' rounding can put a distance of two near sets slightly below 0 (JAX's form does the same)
    assert all(np.isfinite(v) for v in numbers)
    assert report["miou_consistency_gap"] == pytest.approx(report["miou_original"] - report["miou_translated"],
                                                           abs=2e-4)


def test_quality_pairs_by_stem_and_refuses_sorted_order(tmp_path):
    """--images' two layouts as JAX pairs them; equal counts with unmatched
    stems are refused rather than paired by sorted order."""
    acdc = tmp_path / "acdc" / "rgb_anon" / "fog"
    os.makedirs(acdc)
    os.makedirs(tmp_path / "acdc" / "gt" / "fog")
    for i in range(2):
        (acdc / f"a{i}_rgb_anon.png").write_bytes(b"")
        (tmp_path / "acdc" / "gt" / "fog" / f"a{i}_gt_labelIds.png").write_bytes(b"")
    root = str(tmp_path / "acdc")
    assert PC._discover_image_label_pairs(root) == JC._discover_image_label_pairs(root)
    assert len(PC._discover_image_label_pairs(root)) == 2
    flat = tmp_path / "flat"
    for d, names in (("rgb", ["x.png", "y.png"]), ("gt", ["x.png", "z.png"])):
        os.makedirs(flat / d)
        for n in names:
            (flat / d / n).write_bytes(b"")
    with pytest.raises(SystemExit, match="refusing to pair by sorted order"):
        PC._discover_image_label_pairs(str(flat))
    (flat / "gt" / "y.png").write_bytes(b"")
    assert PC._discover_image_label_pairs(str(flat)) == JC._discover_image_label_pairs(str(flat))


def test_cli_train_ddpm_on_the_cpu(tiny, tmp_path):
    root = tmp_path / "data" / "rgb_anon" / "fog" / "train"
    os.makedirs(root)
    rng = np.random.default_rng(2)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (20, 36, 3), dtype=np.uint8)).save(root / f"{i}.png")
    assert PM.main(["train-ddpm", "--config", str(tiny / "d.yaml"), "--max-steps", "2", "--device", "cpu", "--set",
                    f"data.root_dir={tmp_path / 'data'}", "data.acdc_images=rgb_anon", 'data.weather=["fog"]',
                    "training.batch_size=2", f"folders.output={tmp_path / 'out'}"]) == 0
    assert os.path.isfile(tmp_path / "out" / "0" / "metrics.jsonl")


def test_console_script_names_the_port_main():
    text = open(os.path.join(os.path.dirname(__file__), "..", "pyproject.toml")).read()
    assert 'weatherconverter-tpu-torch = "weatherconverter_tpu_torch.cli.main:main"' in text
    assert callable(PM.main)
