"""The plain reference against the port at tiny sizes on the CPU (where the
port runs its kernels' plain versions): one state dict loads into both, and
each piece the cells compare gives the same numbers. The reference imports
nothing of the port."""

from __future__ import annotations

import ast
import glob
import os

import pytest
import torch

from wcbench import weights
from wcbench.compare import kept_leaves, worst_leaf_gap
from wcbench.harness import BENCH_DIR
from wcbench.reference import diffusion as rdiff
from wcbench.reference import guidance as rguide
from wcbench.reference import seg as rseg
from wcbench.reference import train as rtrain
from wcbench.reference import unet as runet
from wcbench.tests.tiny import TINY_UNET

FULL_UNET = {"im_channels": 3, "im_size": 128, "down_channels": [64, 128, 256, 512, 768],
             "mid_channels": [768, 768, 512], "down_sample": [True, True, True, False], "time_emb_dim": 128,
             "num_down_layers": 2, "num_mid_layers": 2, "num_up_layers": 2, "num_heads": 4,
             "attn_resolutions": [8, 16, 32, 64]}


def _port_unet(cfg, qk_int8):
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.models.unet import Unet

    return Unet(UnetModelConfig(**cfg), qk_int8=qk_int8)


def _port_seg():
    from weatherconverter_tpu_torch.models.factory import make_seg_model

    return make_seg_model("deeplabv3plus_resnet101", 19, 16)


def _port_sr(blocks=16):
    from weatherconverter_tpu_torch.models.srgan import Generator

    return Generator(3, 64, blocks, 4)


def _pair(ref_factory, port_factory, seed=3):
    with torch.device("meta"):
        spec = ref_factory()
    w = weights.make_weights(spec, seed, "cpu")
    return weights.build(ref_factory, w, "cpu").eval(), weights.build(port_factory, w, "cpu").eval()


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "weatherconverter_tpu",
                                               "weatherconverter_tpu_torch"), (path, n)


@pytest.mark.parametrize("which", ["unet", "seg", "srgan"])
def test_state_dicts_match_the_port_at_the_published_widths(which):
    ref, port = {"unet": (lambda: runet.Unet(FULL_UNET, True), lambda: _port_unet(FULL_UNET, True)),
                 "seg": (rseg.DeepLabV3Plus, _port_seg), "srgan": (rseg.SRGenerator, _port_sr)}[which]
    with torch.device("meta"):
        a, b = ref().state_dict(), port().state_dict()
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in b.items()}


def test_unet_parameter_count_is_the_published_one():
    with torch.device("meta"):
        assert runet.param_count(runet.Unet(FULL_UNET)) == 110_638_339
        assert runet.param_count(rseg.DeepLabV3Plus()) == 58_753_459


@pytest.mark.parametrize("qk_int8", [False, True])
def test_unet_forward_matches_the_port(qk_int8):
    ref, port = _pair(lambda: runet.Unet(TINY_UNET, qk_int8), lambda: _port_unet(TINY_UNET, qk_int8))
    x, t = torch.randn(2, 3, 32, 32), torch.tensor([3, 700])
    with torch.no_grad():
        assert torch.equal(ref(x, t), port(x, t))
    assert [s[2:] for s in runet.flash_layers(TINY_UNET, 2)] == [(1024, 32), (1024, 16)]


def test_seg_and_srgan_forward_and_guidance_match_the_port():
    from weatherconverter_tpu_torch.guidance import sgg

    seg, pseg = _pair(rseg.DeepLabV3Plus, _port_seg)
    sr, psr = _pair(lambda: rseg.SRGenerator(num_blocks=2), lambda: _port_sr(2))
    pseg.requires_grad_(False)
    x = torch.randn(2, 3, 16, 16)
    with torch.no_grad():
        assert torch.equal(sr(x), psr(x))
        y = sr(x)
    gt = torch.randint(0, 4, (2, 64, 64))
    gt[:, :8] = 255
    mu, z, sigma = torch.randn(2, 3, 16, 16), torch.randn(2, 3, 16, 16), torch.tensor(0.1)
    ids = rguide.present_class_ids(gt, 3, 19)
    assert torch.equal(ids, sgg.present_class_ids(gt, 3, 19).long())
    assert torch.equal(rguide.gsg(seg, mu, sigma, y, gt, 60.0, z), sgg.apply_gsg(pseg, mu, sigma, y, gt, 60.0, z))
    assert torch.equal(rguide.lcg(seg, mu, sigma, y, gt, 60.0, z, ids, 2),
                       sgg.apply_lcg(pseg, mu, sigma, y, gt, 60.0, 19, z, "fixed", 2, None, ids.int()))


def test_dpm_sampler_matches_the_port():
    from weatherconverter_tpu_torch.diffusion.sampling import dpm_solver_pp_2m_sample, strided_taus
    from weatherconverter_tpu_torch.diffusion.schedule import make_schedule

    ref, port = _pair(lambda: runet.Unet(TINY_UNET, True), lambda: _port_unet(TINY_UNET, True))
    s, ps = rdiff.Schedule(1000, 1e-4, 0.02, "cpu"), make_schedule("linear", 1000, 1e-4, 0.02)
    assert rdiff.strided_taus(1000, 20) == strided_taus(1000, 20) and rdiff.strided_taus(333, 25) == strided_taus(333, 25)
    x = torch.randn(2, 32, 32, 3)
    out = dpm_solver_pp_2m_sample(port, ps, x.shape, None, 5, noise=x)
    assert torch.equal(rdiff.dpm_sample(ref, s, x.permute(0, 3, 1, 2), 5), out.permute(0, 3, 1, 2))


def test_train_steps_match_the_port():
    from weatherconverter_tpu_torch.diffusion.schedule import make_schedule
    from weatherconverter_tpu_torch.training.diffusion import create_ddpm_state
    from weatherconverter_tpu_torch.training.loop_diffusion import make_augmented_train_step

    ref, port = _pair(lambda: runet.Unet(TINY_UNET, False), lambda: _port_unet(TINY_UNET, False))
    ref.train(), port.train()
    p0 = {n: v.detach().clone() for n, v in port.named_parameters()}
    state = create_ddpm_state(port, lr=1e-4, ema_decay=0.999)
    step = make_augmented_train_step(make_schedule("linear", 1000, 1e-4, 0.02), 32)
    batches = [torch.randint(0, 256, (2, 32, 57, 3), dtype=torch.uint8) for _ in range(3)]
    g = torch.Generator().manual_seed(11)
    losses = [float(step(state, raw, g)[1]) for raw in batches]
    g = torch.Generator().manual_seed(11)
    r_losses, g1, ema = rtrain.train_steps(ref, rdiff.Schedule(1000, 1e-4, 0.02, "cpu"), batches, g, 32, 1e-4, 0.999)
    assert [float(v) for v in r_losses] == pytest.approx(losses, rel=1e-5)
    # by the check's own measure: a key's bias under softmax moves by round-off, which Adam scales up
    keep = kept_leaves(g1)
    p, q = dict(port.named_parameters()), dict(ref.named_parameters())
    moved = {n: p[n].detach() - p0[n] for n in keep}, {n: q[n].detach() - p0[n] for n in keep}
    assert worst_leaf_gap(*moved, keep) < 1e-4
    ema_moved = {n: state.ema.params[n] - p0[n] for n in keep}, {n: ema[n] - p0[n] for n in keep}
    assert worst_leaf_gap(*ema_moved, keep) < 1e-4
