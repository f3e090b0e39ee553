"""Where the PyTorch port refuses a dtype or admits a shape before any kernel
runs: on CUDA a UNet with a flash-length attention layer runs in bf16/f16,
or in f32 where the f32 kernels (K1-f32 forward, K3-f32 backward) take each
such layer's head dim and no layer takes K2; anything else is refused at the
three entry points a user picks the dtype at (`Unet.forward`,
`make_translate_fn`, `training/loop_diffusion.train`). The attention shapes
of the supported UNets are ones the flash kernels take.

There is no card here, so the entry points are shown the device type "cuda"
through the name `check_flash_precision` each of them imports; everything
else about the call is real. This file imports no JAX.
"""

import pytest
import torch

from weatherconverter_tpu_torch.core.config import DiffusionConfig, UnetModelConfig
from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
from weatherconverter_tpu_torch.guidance import translate as PT
from weatherconverter_tpu_torch.models import layers, unet as unet_module
from weatherconverter_tpu_torch.models.unet import Unet, unet_attention_shapes
from weatherconverter_tpu_torch.ops import attention as A
from weatherconverter_tpu_torch.training import loop_diffusion

# attends at 32 x 32 (N = 1024, flash length) and, in the mid block, at 16 x 16
FLASH_UNET = dict(im_size=32, down_channels=[32, 32, 48], mid_channels=[48, 48, 32], down_sample=[True, False],
                  time_emb_dim=16, num_down_layers=1, num_mid_layers=1, num_up_layers=1, num_heads=2,
                  attn_resolutions=[32])
# the same ladder attending at 16 x 16 only: no flash-length layer
SHORT_UNET = dict(FLASH_UNET, attn_resolutions=[16])
# flash-length layers at head dims the f32 kernels lack: D = 48 (neither), D = 24 (the forward only)
FLASH_UNET_D48 = dict(FLASH_UNET, down_channels=[96, 96, 48], mid_channels=[48, 48, 96])
FLASH_UNET_D24 = dict(FLASH_UNET, down_channels=[48, 48, 64], mid_channels=[64, 64, 48])


def _as_if_on_cuda(monkeypatch, module):
    """`module`'s precision check sees device type "cuda"; returns the calls it got."""
    calls = []

    def check(device_type, dtype, shapes, where, **kw):
        calls.append((device_type, dtype, list(shapes), where))
        A.check_flash_precision("cuda", dtype, shapes, where, **kw)

    monkeypatch.setattr(module, "check_flash_precision", check)
    return calls


@pytest.mark.parametrize("device_type, dtype, shapes, refused", [
    ("cuda", torch.float32, [(256, 64), (1024, 48)], True),  # D = 48: no f32 kernel has it
    ("cuda", torch.float64, [(4096, 64)], True),
    ("cuda", torch.bfloat16, [(1024, 16)], False),
    ("cuda", torch.float16, [(16384, 64)], False),
    ("cpu", torch.float32, [(1024, 16)], False),
    ("cuda", torch.float32, [(256, 64), (64, 128)], False),  # plain softmax attention only
    ("cuda", torch.float32, [(1088, 32)], False),  # N % 128 != 0: plain softmax attention
    ("cuda", torch.float32, [], False),
    ("cuda", torch.float32, [(256, 64), (1024, 16)], False),  # K1-f32 and K3-f32
    ("cuda", torch.float32, [(4096, 64), (1024, 128), (1024, 32), (4096, 16)], False),  # the default UNet
    ("cuda", torch.float32, [(1024, 192)], False),
    ("cuda", torch.float32, [(1024, 16), (1024, 24)], True),  # D = 24: K3-f32 lacks it
    ("cuda", torch.float64, [(1024, 16)], True),
])
def test_check_flash_precision(device_type, dtype, shapes, refused):
    if not refused:
        A.check_flash_precision(device_type, dtype, shapes, "here")
        return
    with pytest.raises(ValueError) as err:
        A.check_flash_precision(device_type, dtype, shapes, "here")
    msg = str(err.value)
    assert msg.startswith("here:") and str(dtype) in msg
    assert "dtype=torch.bfloat16" in msg and 'training.dtype="bfloat16"' in msg  # the remedy, by name
    assert all(str(s) in msg for s in shapes if A.is_flash_length(s[0]))


@pytest.mark.parametrize("forward_only, qk_int8, shapes, refused", [
    (True, False, [(1024, 16), (1024, 24)], False),  # the legacy UNet samples in f32: K1-f32 alone
    (True, False, [(1024, 48)], True),
    (False, True, [(1024, 16)], True),  # K2 takes 16-bit V
    (True, True, [(1024, 16), (1024, 24)], True),
    (False, True, [(256, 16)], False),  # no flash-length layer: plain softmax attention
])
def test_check_flash_precision_f32_rules(forward_only, qk_int8, shapes, refused):
    """f32 on CUDA: a forward-only model needs K1-f32's head dims, a model
    that trains K3-f32's as well, and no K2; a refusal names the kernel and
    the head dims it has."""
    args = ("cuda", torch.float32, [(n, d, "K2" if qk_int8 else "K1") for n, d in shapes], "here", forward_only)
    if not refused:
        A.check_flash_precision(*args)
        return
    with pytest.raises(ValueError) as err:
        A.check_flash_precision(*args)
    msg = str(err.value)
    assert msg.startswith("here:") and 'training.dtype="bfloat16"' in msg
    assert ("K2" in msg and "qk_int8=False" in msg) if qk_int8 else ("K1-f32" in msg and str(A.F32_HEAD_DIMS) in msg)


def test_unet_forward_refuses_f32_on_cuda_by_name(monkeypatch):
    calls = _as_if_on_cuda(monkeypatch, unet_module)
    torch.manual_seed(0)
    x = torch.zeros(1, 3, 32, 32)
    model = Unet(UnetModelConfig(**FLASH_UNET_D48)).eval()
    with pytest.raises(ValueError, match=r"Unet.forward: .*\(1024, 48\).*torch.float32.*K1-f32.*K3-f32"):
        model(x, 3)
    assert calls[-1][:2] == ("cpu", torch.float32)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):  # the remedy: it runs
        assert model(x, 3).shape == x.shape
    assert calls[-1][1] == torch.bfloat16
    with pytest.raises(ValueError, match=r"Unet.forward: .*\(1024, 24\).*K3-f32"):  # a model that trains
        Unet(UnetModelConfig(**FLASH_UNET_D24)).eval()(x, 3)
    with pytest.raises(ValueError, match=r"Unet.forward: .*qk_int8.*K2"):
        Unet(UnetModelConfig(**FLASH_UNET), qk_int8=True).eval()(x, 3)
    with torch.no_grad():
        # D = 16: the f32 kernels take it, forward and backward
        assert Unet(UnetModelConfig(**FLASH_UNET)).eval()(x, 3).dtype == torch.float32
        # no flash-length layer: f32 stays allowed on CUDA (plain softmax attention)
        assert Unet(UnetModelConfig(**SHORT_UNET)).eval()(x, 3).dtype == torch.float32


def test_unet_forward_runs_f32_on_the_cpu():
    torch.manual_seed(0)
    with torch.no_grad():
        out = Unet(UnetModelConfig(**FLASH_UNET)).eval()(torch.zeros(1, 3, 32, 32), 3)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_make_translate_fn_refuses_f32_on_cuda_by_name(monkeypatch):
    _as_if_on_cuda(monkeypatch, PT)
    models = (Unet(UnetModelConfig(**FLASH_UNET_D48)), linear_schedule(4), torch.nn.Identity(), torch.nn.Identity())
    with pytest.raises(ValueError, match=r"make_translate_fn: .*K1-f32.*dtype=torch.bfloat16"):
        PT.make_translate_fn(*models)
    assert callable(PT.make_translate_fn(*models, dtype=torch.bfloat16))
    assert callable(PT.make_translate_fn(Unet(UnetModelConfig(**SHORT_UNET)), *models[1:]))
    assert callable(PT.make_translate_fn(Unet(UnetModelConfig(**FLASH_UNET)), *models[1:]))  # K1-f32 at D = 16
    with pytest.raises(ValueError, match=r"make_translate_fn: .*K2"):
        PT.make_translate_fn(Unet(UnetModelConfig(**FLASH_UNET), qk_int8=True), *models[1:])
    monkeypatch.undo()
    assert callable(PT.make_translate_fn(*models))  # on the CPU f32 is fine


class _Checked(Exception):
    pass


@pytest.mark.parametrize("dtype, model, refused", [("float32", FLASH_UNET_D24, True), ("bfloat16", FLASH_UNET, False),
                                                   ("float32", SHORT_UNET, False), ("float32", FLASH_UNET, False)])
def test_train_refuses_f32_on_cuda_by_name(monkeypatch, tmp_path, dtype, model, refused):
    """`train` checks right after it resolved the device, before anything
    touches it; a configuration that passes goes on (stopped here)."""
    monkeypatch.setattr(loop_diffusion, "_device", lambda name: torch.device("cuda"))

    def check(*args):
        A.check_flash_precision(*args)
        raise _Checked

    monkeypatch.setattr(loop_diffusion, "check_flash_precision", check)
    cfg = DiffusionConfig(model=model, training=dict(dtype=dtype, device="auto"), folders=dict(output=str(tmp_path)))
    with pytest.raises(ValueError if refused else _Checked) as err:
        loop_diffusion.train(cfg, dataset=[0])
    if refused:
        assert f"train (training.dtype={dtype!r})" in str(err.value) and 'training.dtype="bfloat16"' in str(err.value)


def test_train_checks_nothing_away_on_the_cpu(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(loop_diffusion, "check_flash_precision",
                        lambda *args: (seen.append(args[:2]), A.check_flash_precision(*args), (_ for _ in ()).throw(_Checked)))
    cfg = DiffusionConfig(model=FLASH_UNET, training=dict(dtype="float32", device="cpu"),
                          folders=dict(output=str(tmp_path)))
    with pytest.raises(_Checked):
        loop_diffusion.train(cfg, dataset=[0])
    assert seen == [("cpu", torch.float32)]


@pytest.mark.parametrize("config, size", [(FLASH_UNET, (32, 32)), (SHORT_UNET, (32, 32)), (FLASH_UNET, (32, 64)),
                                          (dict(FLASH_UNET, attn_resolutions=[16, 32], num_up_layers=2), (64, 32))])
def test_unet_attention_shapes_are_what_the_forward_attends_at(monkeypatch, config, size):
    seen = []
    real = layers.multi_head_attention
    monkeypatch.setattr(layers, "multi_head_attention",
                        lambda q, k, v, **kw: (seen.append((q.shape[2], q.shape[3])), real(q, k, v, **kw))[1])
    torch.manual_seed(0)
    model = Unet(UnetModelConfig(**config)).eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, *size), 0)
    assert seen == model.attention_shapes(*size) == unet_attention_shapes(model.config, *size)


def test_production_unet_attends_at_the_four_path_shapes():
    flash = [s for s in unet_attention_shapes(UnetModelConfig(), 128) if A.is_flash_length(s[0])]
    assert flash == [(4096, 64)] * 2 + [(1024, 128)] * 2 + [(1024, 32)] * 2 + [(4096, 16)] * 2


@pytest.mark.parametrize("im_size", [128, 256])
def test_default_ladder_attention_shapes_are_admitted_by_the_kernels(im_size):
    """Every flash-length (N, D) of the default ladder at 128 and 256 px is one
    K1 and K3 take (at batch 8, 4 heads). At 256 px the last down block and
    the first mid block attend at N = 1024 on 768 channels: D = 192."""
    cfg = UnetModelConfig(im_size=im_size)
    flash = sorted({s for s in unet_attention_shapes(cfg, im_size) if A.is_flash_length(s[0])})
    assert flash
    if im_size == 256:
        assert flash == [(1024, 64), (1024, 128), (1024, 192), (4096, 32), (4096, 128)]
    for n, d in flash:
        A.check_kernel_shape("flash_attention", 8, cfg.num_heads, n, d)
    with pytest.raises(ValueError, match="head dim 48"):
        A.check_kernel_shape("flash_attention", 8, 4, 1024, 48)


def test_qk_int8_unet_takes_k2_only_where_k2_has_the_head_dim():
    """What the CLI builds on the card: a 256 px UNet with qk_int8, one layer
    deep at the default ladder's widths. Each flash-length layer takes K2,
    D = 192 included, as JAX's int8 kernel does; without qk_int8 every one
    takes K1."""
    cfg = UnetModelConfig(im_size=256, num_down_layers=1, num_mid_layers=1, num_up_layers=1)
    with torch.device("meta"):
        int8, plain = Unet(cfg, qk_int8=True), Unet(cfg)
    assert int8.attention_kernels(256) == [(4096, 128, "K2"), (1024, 192, "K2"), (1024, 192, "K2"),
                                           (1024, 128, "K2"), (1024, 64, "K2"), (4096, 32, "K2")]
    assert [k for _, _, k in plain.attention_kernels(256)] == ["K1"] * 6
    assert [(n, d) for n, d, _ in int8.attention_kernels(256)] == int8.attention_shapes(256)
    assert [k for _, _, k in int8.attention_kernels(64)] == ["softmax"] * 6


def test_qk_i8_refuses_head_dim_192_by_naming_k1():
    """K2 takes D = 192 and every head dim K1 takes; another (48) raises
    instead of falling back, naming K1 (the rule is checked before any
    kernel is built, so it shows without a card)."""
    with pytest.raises(ValueError, match=r"head dim 48 .*use flash_attention \(qk_int8=False\)"):
        A._check_qk_i8_head_dim(48)
    for d in A.KERNEL_HEAD_DIMS:
        A._check_qk_i8_head_dim(d)
    assert 192 in A.KERNEL_HEAD_DIMS and A.QK_I8_HEAD_DIMS == A.KERNEL_HEAD_DIMS
