"""The port's inference in f32, as the JAX package's: the slice against JAX,
and the precision rule of every inference command.

1. The slice as a whole: the port's `make_translate_fn(dtype=None)` over an
   f32 `Unet(qk_int8=True)` (on the CPU K2's plain version; on the card
   K2-f32) against JAX's `make_translate_fn` under WCTPU_ATTN_QK_INT8=1 (its
   int8 kernel in interpret mode), with the tiny UNet (its 32 x 32 layers
   attend at N = 1024, D = 16 through the flash path), DeepLabV3+/ResNet-18
   and a 2x SRGAN, over 2 steps of GSG in latent space. JAX's draws are
   replayed through `noise=`. The exact chain (K1) stands farther from
   JAX's int8 chain than the tolerance.
2. The precision rule, table-driven: each inference command of the CLI run
   on the CPU as if on the card (the modules see the device type "cuda"
   through the names `f32_arithmetic` and `use_qk_int8` they import, as
   tests/test_torch_precision.py shows its entries "cuda"), with a spy on
   the UNets' forward: every forward computes in f32 with no autocast, TF32
   off for cuDNN and the matmuls at "highest", and takes int8 where JAX's
   command enables its int8 kernel (sample, the legacy sampler, translate,
   serve), not where it does not (quality, visualize), and never under
   --no-int8-attn.
3. The rule across threads: two `f32_arithmetic("cuda")` blocks open at
   once on two threads, as the server's translate and sample workers run
   them, keep TF32 off until the second closes, and then restore both
   settings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import TINY_UNET, generator_pair, load_strict, seg_pair_from_shapes, tiny_unet_pair

from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu_torch.cli import commands as PC
from weatherconverter_tpu_torch.cli import main as PM
from weatherconverter_tpu_torch.core import precision
from weatherconverter_tpu_torch.core.config import UnetModelConfig
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.guidance import translate as PT
from weatherconverter_tpu_torch.models.layers import SelfAttention2D
from weatherconverter_tpu_torch.models.unet import Unet
from weatherconverter_tpu_torch.models.unet_legacy import LegacyUNet
from weatherconverter_tpu_torch.serving import server as PServer

B, LATENT, HR, STEPS = 1, 32, 64, 2
SCHED_ARGS = (STEPS, 1e-3, 0.2)
CHAIN = dict(lam=1.0, num_steps=STEPS, mode="fixed", start_t=STEPS - 1, guidance_style="gsg", guidance_every=1,
             guidance_space="latent")
# The port's int8 chain against JAX's: max |difference| of the (B, HR, HR, 3) images in [0, 1]. Both quantize the
# same f32 q and k; where an f32 last-bit difference upstream (sums in another order than XLA's) puts a q or k
# value at a .5 boundary of its int8 rounding, one int8 value flips, which moves that layer's output by ~1e-3
# (tests/test_torch_int8_dims.py's UNet tolerance) and the chain carries it on. Read on the CPU: 4.9e-5 at these 2
# steps; 7.7e-4 over 3 steps, where one value flipped. The exact chain (K1) stands 5.6e-3 from JAX's int8 one (6.4e-3
# over 3 steps): the limit admits a flip and not the other kernel
INT8_CHAIN_ATOL = 2e-3


def _jax_noise(key):
    """The draws JAX's sample_with_sgg makes from `key`, in its split order (tests/test_torch_translate.py)."""
    shape = (B, LATENT, LATENT, 3)
    key, _tkey, nkey = jax.random.split(key, 3)
    noise0 = jax.random.normal(nkey, shape)
    zs = []
    for _ in range(STEPS):
        key, zkey = jax.random.split(key)
        zs.append(jax.random.normal(zkey, shape))
    return torch.from_numpy(np.array(noise0)), torch.from_numpy(np.stack([np.asarray(z) for z in zs]))


def test_f32_int8_translation_matches_jax_int8(monkeypatch):
    junet, uparams, port_int8 = tiny_unet_pair(qk_int8=True)
    exact = load_strict(Unet(UnetModelConfig(**TINY_UNET)), port_int8.state_dict())
    flash = [(n, d, kind) for n, d, kind in port_int8.attention_kernels(LATENT) if n >= 1024]
    assert flash == [(1024, 16, "K2")] * 2
    jseg, seg_vars, port_seg = seg_pair_from_shapes("deeplabv3plus_resnet18", HR, 19)
    jgen, gen_vars, port_gen = generator_pair(2, hw=LATENT)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((B, LATENT, LATENT, 3)) * 0.2).astype(np.float32)
    gt = rng.integers(0, 19, (B, HR, HR)).astype(np.int32)
    key = jax.random.PRNGKey(7)

    monkeypatch.setenv("WCTPU_ATTN_QK_INT8", "1")
    j_translate = JT.make_translate_fn(junet, uparams, JS.linear_schedule(*SCHED_ARGS), jseg, seg_vars, jgen,
                                       gen_vars, **CHAIN)
    ref = np.asarray(j_translate(jnp.asarray(x), jnp.asarray(gt), key))
    noise = _jax_noise(key)
    outs = {}
    for name, unet in (("int8", port_int8), ("exact", exact)):
        translate = PT.make_translate_fn(unet, PS.linear_schedule(*SCHED_ARGS), port_seg, port_gen, **CHAIN)
        outs[name] = translate(torch.from_numpy(x), torch.from_numpy(gt).long(), noise=noise)
    out = outs["int8"]
    assert out.shape == (B, HR, HR, 3) and out.dtype == torch.float32 and torch.isfinite(out).all()
    err, exact_err = (float(np.abs(o.numpy() - ref).max()) for o in (out, outs["exact"]))
    assert err <= INT8_CHAIN_ATOL, err
    assert exact_err > INT8_CHAIN_ATOL, exact_err  # the kernel choice shows at this tolerance


# a UNet whose every attention layer is at D = 16 (32 channels over 2 heads), a head dim K2 has
TINY_YAML = """
diffusion:
  model:
    im_size: 16
    down_channels: [32, 32, 32]
    mid_channels: [32, 32, 32]
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
DIFFUSION_YAML = """
model: {im_size: 16, down_channels: [32, 32, 32], mid_channels: [32, 32, 32], down_sample: [true, false],
        time_emb_dim: 16, num_down_layers: 1, num_mid_layers: 1, num_up_layers: 1, num_heads: 2,
        attn_resolutions: [8]}
diffusion: {num_timesteps: 20}
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("f32_cli")
    (d / "t.yaml").write_text(TINY_YAML)
    (d / "d.yaml").write_text(DIFFUSION_YAML)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(d / "img.png")
    Image.fromarray(rng.integers(0, 34, (40, 40), dtype=np.uint8)).save(d / "lbl.png")
    return d


@pytest.fixture
def as_if_on_cuda(monkeypatch):
    """The CLI's modules decide as on the card; every UNet forward records
    (model, int8 taken, autocast on, cuDNN TF32, matmul precision, input
    dtype). Returns that list."""
    n, tf32 = torch.get_num_threads(), torch.backends.cudnn.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = True  # torch's default, which the rule must turn off
    real_f32, real_int8 = precision.f32_arithmetic, PC.use_qk_int8
    for module in (PC, PT, PServer):
        monkeypatch.setattr(module, "f32_arithmetic", lambda device: real_f32("cuda"))
    monkeypatch.setattr(PC, "use_qk_int8", lambda args, device: real_int8(args, torch.device("cuda")))
    seen = []
    for cls in (Unet, LegacyUNet):
        def spy(self, x, t, _real=cls.forward):
            seen.append((type(self).__name__, any(m.qk_int8 for m in self.modules() if isinstance(m, SelfAttention2D)),
                         torch.is_autocast_enabled("cpu") or torch.is_autocast_enabled("cuda"),
                         torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision(), x.dtype))
            return _real(self, x, t)
        monkeypatch.setattr(cls, "forward", spy)

    def serve(service, port):  # `serve` answers one translation and one sample, then returns
        service.translate_rows(np.zeros((1, service.size, service.size, 3), np.float32),
                               np.zeros((1, service.hr, service.hr), np.int64), [0], steps=2)
        service.sample_rows([0], 2)

    monkeypatch.setattr(PServer, "serve", serve)
    yield seen
    torch.set_num_threads(n)
    torch.backends.cudnn.allow_tf32 = tf32


# (command line after the config, the UNet it builds, int8 as JAX's command has it on its accelerator)
COMMANDS = [
    (["sample", "--config", "d.yaml", "--sampler", "dpm", "--steps", "2", "--batch", "1"], "Unet", True),
    (["sample", "--config", "d.yaml", "--sampler", "dpm", "--steps", "2", "--batch", "1", "--no-int8-attn"], "Unet",
     False),
    (["sample", "--config", "d.yaml", "--sampler", "legacy", "--steps", "2", "--batch", "1"], "LegacyUNet", True),
    (["sample", "--config", "d.yaml", "--sampler", "legacy", "--steps", "2", "--batch", "1", "--no-int8-attn"],
     "LegacyUNet", False),
    (["translate", "--config", "t.yaml", "--image", "img.png", "--label", "lbl.png", "--steps", "2"], "Unet", True),
    (["translate", "--config", "t.yaml", "--image", "img.png", "--label", "lbl.png", "--sampler", "dpm", "--steps",
      "2"], "Unet", True),
    (["translate", "--config", "t.yaml", "--image", "img.png", "--label", "lbl.png", "--sampler", "dpm", "--steps",
      "2", "--no-int8-attn"], "Unet", False),
    (["serve", "--config", "t.yaml", "--batch", "1", "--sampler", "dpm"], "Unet", True),
    (["serve", "--config", "t.yaml", "--batch", "1", "--sampler", "dpm", "--no-int8-attn"], "Unet", False),
    (["quality", "--config", "t.yaml", "--synthetic", "1", "--batch", "1", "--steps", "2"], "Unet", False),
    (["visualize", "--config", "d.yaml", "--image", "img.png", "--every", "10"], "Unet", False),
]


@pytest.mark.parametrize("argv, model, int8", COMMANDS, ids=[" ".join(a[:1] + a[3:]) for a, _, _ in COMMANDS])
def test_inference_command_computes_in_f32_with_jax_int8_choice(tiny, tmp_path, as_if_on_cuda, argv, model, int8):
    argv = [str(tiny / a) if a.endswith((".yaml", ".png")) else a for a in argv]
    out = [] if argv[0] == "serve" else ["--out", str(tmp_path / ("out" if argv[0] == "visualize" else "out.png"))]
    assert PM.main(argv + out + ["--device", "cpu"]) == 0
    assert as_if_on_cuda, "no UNet forward ran"
    assert {s[0] for s in as_if_on_cuda} == {model}
    # f32 without autocast, TF32 off for cuDNN and the matmuls at "highest", in every forward
    assert {s[2:] for s in as_if_on_cuda} == {(False, False, "highest", torch.float32)}
    assert {s[1] for s in as_if_on_cuda} == {int8}
    assert torch.backends.cudnn.allow_tf32  # the rule ends with the command


def test_f32_arithmetic_holds_until_the_last_of_two_threads_closes():
    """Block A opens on one thread, block B on another; A closes while B is
    open (the settings must stay f32), then B closes (they come back)."""
    import threading

    def settings():
        return torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32

    before = settings()
    a_open, b_open, a_closed, b_may_close = (threading.Event() for _ in range(4))
    seen, errors = {}, []

    def block_a():
        try:
            with precision.f32_arithmetic("cuda"):
                seen["a_open"] = settings()
                a_open.set()
                b_open.wait(10)
                seen["both_open"] = settings()
        except BaseException as e:  # noqa: BLE001 - reported on the main thread
            errors.append(e)
        finally:
            a_open.set()
            a_closed.set()

    def block_b():
        try:
            a_open.wait(10)
            with precision.f32_arithmetic(torch.device("cuda")):
                b_open.set()
                a_closed.wait(10)
                seen["a_closed"] = settings()
                b_may_close.wait(10)
        except BaseException as e:  # noqa: BLE001 - reported on the main thread
            errors.append(e)
        finally:
            b_open.set()

    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        threads = [threading.Thread(target=block_a), threading.Thread(target=block_b)]
        for t in threads:
            t.start()
        a_closed.wait(10)
        seen["main_while_b_open"] = settings()
        b_may_close.set()
        for t in threads:
            t.join(10)
        after = settings()
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]
    assert not errors and not any(t.is_alive() for t in threads)
    f32 = ("highest", False)
    assert seen == dict(a_open=f32, both_open=f32, a_closed=f32, main_while_b_open=f32)
    assert after == ("high", True) and precision._open == 0
    with precision.f32_arithmetic("cpu"):  # the CPU's settings stay as they are
        assert settings() == before
