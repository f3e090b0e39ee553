"""The legacy diffusion UNet, NCHW (port of
weatherconverter_tpu/models/unet_legacy.py): the architecture of the
reference's shipped 1000-epoch checkpoint (its `old_modules.UNet`).

The model is conditioned on a scalar per example, 1 - alpha_bar[t], embedded
with 32 log-spaced sin/cos frequencies, broadcast over the image plane and
concatenated with the stem's 32 channels. A fixed ladder 32/64/96/128 with a
256-channel bottleneck; LayerNorm attention on the 32, 16 and 8 px maps at
128 px (4 heads): `attn_down3` at (N, D) = (1024, 16) and `attn_up2` at
(1024, 24) reach the flash kernels, the other three run plain softmax.

Module and parameter names are the reference's, the ones
weatherconverter_tpu/compat/torch_export.export_legacy_unet writes:
`pre_conv`, `down{n}.residual_blocks.{i}.double_conv.{0,1,3}` (BatchNorm,
conv, conv; index 2 is the SiLU), `.res` (only on residual blocks: the
reference's dead `res.weight` of the others is dropped by its loader,
compat/from_jax.load_legacy_reference), `attn_*.ln`,
`attn_*.mha.{in_proj_weight,in_proj_bias,out_proj}`,
`attn_*.ff_self.{0,1,3}`, `bottleneck{1,2}`, `up{n}...` and `output`. The
`mha` parameters keep nn.MultiheadAttention's names, but the forward runs
the port's `multi_head_attention` (the clamped softmax of the flash
kernels), never nn.MultiheadAttention.forward.

BatchNorm runs in eval mode (running statistics), the model's one use being
sampling. LayerNorm's eps is 1e-6, flax's default, which the JAX model
inherits; the reference's torch LayerNorm had 1e-5 (ROADMAP Queue 2). GELU
is the exact erf form. `qk_int8` takes K2 in both flash-length layers
(`attn_down3`, D = 16, and `attn_up2`, D = 24).

On the card the model runs in bf16 (under autocast: K1 and K2) or in f32
(K1-f32 at both flash-length layers, forward only), the latter inside
`full_f32()`, which keeps cuDNN's convolutions and the matmuls out of TF32
as the CPU's f32 is.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from weatherconverter_tpu_torch.models.layers import SelfAttention2D, attention_kernels
from weatherconverter_tpu_torch.models.norm import BatchNorm2d
from weatherconverter_tpu_torch.ops.attention import check_flash_precision
from weatherconverter_tpu_torch.ops.image import avg_pool, resize_bilinear
from weatherconverter_tpu_torch.ops.time_embed import alpha_plane_embedding

LN_EPS = 1e-6  # flax's LayerNorm default (the reference's torch LayerNorm: 1e-5)
NUM_HEADS = 4


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and matmuls without TF32 inside the block, whatever
    the caller set (torch's default runs cuDNN's f32 convolutions in TF32)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


class LegacySelfAttention(nn.Module):
    """LN -> MHA -> + x -> (LN -> Linear -> GELU -> Linear) + over the
    flattened tokens of an NCHW map."""

    def __init__(self, channels: int, num_heads: int = NUM_HEADS, qk_int8: bool = False):
        super().__init__()
        self.ln = nn.LayerNorm(channels, eps=LN_EPS)
        self.mha = SelfAttention2D(channels, num_heads, qk_int8)
        self.ff_self = nn.Sequential(nn.LayerNorm(channels, eps=LN_EPS), nn.Linear(channels, channels), nn.GELU(),
                                     nn.Linear(channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)  # (B, N, C)
        attn = self.mha.attend_tokens(self.ln(tokens)) + tokens
        out = self.ff_self(attn) + attn
        return out.transpose(1, 2).reshape(b, c, h, w)


class LegacyResidualBlock(nn.Module):
    """BN -> Conv3x3 -> SiLU -> Conv3x3, plus a 1x1 conv of the input when
    `residual`, else the input itself."""

    def __init__(self, cin: int, cout: int, residual: bool = False):
        super().__init__()
        self.double_conv = nn.Sequential(BatchNorm2d(cin), nn.Conv2d(cin, cout, 3, padding=1, bias=False), nn.SiLU(),
                                         nn.Conv2d(cout, cout, 3, padding=1, bias=False))
        self.res = nn.Conv2d(cin, cout, 1, bias=False) if residual else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x) + (x if self.res is None else self.res(x))


class LegacyDownBlock(nn.Module):
    """`block_depth` residual blocks (the first with a 1x1 residual conv),
    each output a skip, then a 2x2 average pool."""

    def __init__(self, cin: int, cout: int, block_depth: int = 3):
        super().__init__()
        self.residual_blocks = nn.ModuleList(
            LegacyResidualBlock(cin if i == 0 else cout, cout, residual=i == 0) for i in range(block_depth))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        skips = []
        for block in self.residual_blocks:
            x = block(x)
            skips.append(x)
        return avg_pool(x, 2), skips


class LegacyUpBlock(nn.Module):
    """Bilinear 2x upsample, then `block_depth` x (concatenate the last skip
    -> residual block with a 1x1 residual conv). `skip_channels` are the
    skips' channels, popped last first."""

    def __init__(self, cin: int, cout: int, skip_channels: int, block_depth: int = 3):
        super().__init__()
        self.residual_blocks = nn.ModuleList(
            LegacyResidualBlock((cin if i == 0 else cout) + skip_channels, cout, residual=True)
            for i in range(block_depth))

    def forward(self, x: torch.Tensor, skips: list[torch.Tensor]) -> torch.Tensor:
        x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
        skips = list(skips)
        for block in self.residual_blocks:
            x = block(torch.cat([x, skips.pop()], dim=1))
        return x


class LegacyUNet(nn.Module):
    """The reference's `old_modules.UNet`. `forward(x, t)`: x (B, c_in, S, S)
    with S = image_size, t the scalar 1 - alpha_bar[t] per example ((B,),
    (B, 1, 1, 1) or a number) -> eps (B, c_out, S, S) f32. Built in eval
    mode (BatchNorm on its running statistics), as the JAX model's default
    `train=False`: the JAX package only samples with it."""

    def __init__(self, image_size: int = 128, c_in: int = 3, c_out: int = 3, block_depth: int = 3,
                 qk_int8: bool = False):
        super().__init__()
        self.image_size = image_size
        self.pre_conv = nn.Conv2d(c_in, 32, 3, padding=1, bias=False)
        ladder = [(64, 32), (32, 64), (64, 96), (96, 128)]  # (in, out) of down1-4; in 64 = stem + embedding
        for n, (cin, cout) in enumerate(ladder, start=1):
            setattr(self, f"down{n}", LegacyDownBlock(cin, cout, block_depth))
        self.attn_down3 = LegacySelfAttention(64, qk_int8=qk_int8)
        self.attn_down4 = LegacySelfAttention(96, qk_int8=qk_int8)
        self.bottleneck1 = LegacyResidualBlock(128, 256, residual=True)
        self.attn_bottleneck = LegacySelfAttention(256, qk_int8=qk_int8)
        self.bottleneck2 = LegacyResidualBlock(256, 256, residual=True)
        # up{n}: (x channels in, out, the skips' channels: down{5 - n}'s out)
        for n, (cin, cout, skip) in enumerate([(256, 128, 128), (128, 96, 96), (96, 64, 64), (64, 32, 32)], start=1):
            setattr(self, f"up{n}", LegacyUpBlock(cin, cout, skip, block_depth))
        self.attn_up1 = LegacySelfAttention(128, qk_int8=qk_int8)
        self.attn_up2 = LegacySelfAttention(96, qk_int8=qk_int8)
        self.output = nn.Conv2d(32, c_out, 3, padding=1, bias=False)
        self.eval()

    def attention_shapes(self, height: int, width: int | None = None) -> list[tuple[int, int]]:
        """(N, D) of the five attention layers in forward order, for an input
        of (height, width) pixels (down3 on the 1/4 map, down4 on 1/8, the
        bottleneck on 1/16, up1 on 1/8, up2 on 1/4)."""
        width = height if width is None else width
        tokens = {k: (height // k) * (width // k) for k in (4, 8, 16)}
        return [(tokens[4], 64 // NUM_HEADS), (tokens[8], 96 // NUM_HEADS), (tokens[16], 256 // NUM_HEADS),
                (tokens[8], 128 // NUM_HEADS), (tokens[4], 96 // NUM_HEADS)]

    def attention_kernels(self, height: int, width: int | None = None) -> list[tuple[int, int, str]]:
        """(N, D, what runs it: "K1", "K2" or "softmax") of the five layers."""
        return attention_kernels(self, self.attention_shapes(height, width))

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else self.pre_conv.weight.dtype
        check_flash_precision(dev, dtype, self.attention_kernels(*x.shape[2:]), "LegacyUNet.forward", forward_only=True)
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(x.shape[0])
        temb = alpha_plane_embedding(t, self.image_size, 32).permute(0, 3, 1, 2)
        h = self.pre_conv(x)
        x = torch.cat([h, temb.to(h.dtype)], dim=1)
        x, skip1 = self.down1(x)
        x, skip2 = self.down2(x)
        x = self.attn_down3(x)
        x, skip3 = self.down3(x)
        x = self.attn_down4(x)
        x, skip4 = self.down4(x)
        x = self.bottleneck2(self.attn_bottleneck(self.bottleneck1(x)))
        x = self.attn_up1(self.up1(x, skip4))
        x = self.attn_up2(self.up2(x, skip3))
        x = self.up4(self.up3(x, skip2), skip1)
        return self.output(x).float()
