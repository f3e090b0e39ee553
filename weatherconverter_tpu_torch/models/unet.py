"""DDPM eps-prediction UNet, NCHW (port of weatherconverter_tpu/models/unet.py).

conv_in -> DownBlocks -> MidBlocks -> UpBlocks (skip stack) -> GN+SiLU ->
conv_out, attention where `config.im_size // 2**i` is in `attn_resolutions`.
Parameter names are those of compat/torch_export.export_unet, e.g.
`downs.{i}.resnet_conv_first.{j}.0` and `mids.{i}.attentions.{j}.in_proj_weight`.
`qk_int8` routes the flash-length attention layers through the int8-QK^T
kernel K2 (K2-f32 in f32; forward only; `attention_kernels` lists the choice per layer); `qk_int8_per_item` gives
K2 one scale a batch row. `fused=False` is JAX's portable form: plain
softmax attention at every length, no kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from weatherconverter_tpu_torch.core.config import UnetModelConfig
from weatherconverter_tpu_torch.models.layers import GroupNormSiLU, ResnetTimeBlock, attention_kernels
from weatherconverter_tpu_torch.ops.attention import check_flash_precision
from weatherconverter_tpu_torch.ops.time_embed import timestep_embedding


def unet_attention_shapes(config: UnetModelConfig, height: int, width: int | None = None) -> list[tuple[int, int]]:
    """(N, D) of every self-attention layer of the UNet that `config`
    describes, for an input of (height, width) pixels, in forward order: N
    tokens of head dim D = channels / num_heads. A level attends by the
    config's rule (`im_size // 2**i` in `attn_resolutions`), at the size the
    input really has there."""
    cfg, heads = config, config.num_heads
    dc, mc, ds = list(cfg.down_channels), list(cfg.mid_channels), list(cfg.down_sample)
    size = (height, height if width is None else width)
    sizes, shapes = [], []
    for i in range(len(dc) - 1):
        sizes.append(size)
        if (cfg.im_size // 2**i) in cfg.attn_resolutions:
            shapes += [(size[0] * size[1], dc[i + 1] // heads)] * cfg.num_down_layers
        if ds[i]:
            size = (size[0] // 2, size[1] // 2)
    for i in range(len(mc) - 1):
        shapes += [(size[0] * size[1], mc[i + 1] // heads)] * cfg.num_mid_layers
    for i in reversed(range(len(dc) - 1)):
        if (cfg.im_size // 2**i) in cfg.attn_resolutions:
            shapes += [(sizes[i][0] * sizes[i][1], (dc[i - 1] if i else dc[0]) // heads)] * cfg.num_up_layers
    return shapes


class DownBlock(ResnetTimeBlock):
    """num_layers x [resnet(+t), attn?] then a 4x4/s2 downsample conv."""

    def __init__(self, cin, cout, t_dim, num_layers, num_heads, use_attn, down_sample, attn=None):
        super().__init__([(cin if j == 0 else cout, cout) for j in range(num_layers)], t_dim,
                         num_layers if use_attn else 0, cout, num_heads, attn)
        self.num_layers, self.use_attn = num_layers, use_attn
        self.down_sample_conv = nn.Conv2d(cout, cout, 4, 2, 1) if down_sample else None

    def forward(self, x, t_emb):
        for j in range(self.num_layers):
            x = self.resnet(j, x, t_emb)
            if self.use_attn:
                x = self.attend(j, x)
        return x if self.down_sample_conv is None else self.down_sample_conv(x)


class MidBlock(ResnetTimeBlock):
    """resnet, then num_layers x [attn, resnet]."""

    def __init__(self, cin, cout, t_dim, num_layers, num_heads, attn=None):
        super().__init__([(cin, cout)] + [(cout, cout)] * num_layers, t_dim,
                         num_layers, cout, num_heads, attn)
        self.num_layers = num_layers

    def forward(self, x, t_emb):
        x = self.resnet(0, x, t_emb)
        for j in range(self.num_layers):
            x = self.resnet(j + 1, self.attend(j, x), t_emb)
        return x


class UpBlock(ResnetTimeBlock):
    """ConvTranspose(4, 2, 1) upsample -> concat skip -> num_layers x [resnet(+t), attn?]."""

    def __init__(self, x_ch, cin, cout, t_dim, num_layers, num_heads, use_attn, up_sample, attn=None):
        super().__init__([(cin if j == 0 else cout, cout) for j in range(num_layers)], t_dim,
                         num_layers if use_attn else 0, cout, num_heads, attn)
        self.num_layers, self.use_attn = num_layers, use_attn
        self.up_sample_conv = nn.ConvTranspose2d(x_ch, x_ch, 4, 2, 1) if up_sample else None

    def forward(self, x, skip, t_emb):
        if self.up_sample_conv is not None:
            x = self.up_sample_conv(x)
        x = torch.cat([x, skip], dim=1)
        for j in range(self.num_layers):
            x = self.resnet(j, x, t_emb)
            if self.use_attn:
                x = self.attend(j, x)
        return x


class Unet(nn.Module):
    def __init__(self, config: UnetModelConfig, qk_int8: bool = False, fused: bool = True,
                 qk_int8_per_item: bool = False):
        super().__init__()
        cfg = self.config = config
        self.fused = fused
        attn = dict(qk_int8=qk_int8, per_item=qk_int8_per_item, fused=fused)
        dc, mc, ds = list(cfg.down_channels), list(cfg.mid_channels), list(cfg.down_sample)
        if mc[0] != dc[-1] or mc[-1] != dc[-2] or len(ds) != len(dc) - 1:
            raise ValueError("inconsistent UNet channel ladder")
        t_dim, heads = cfg.time_emb_dim, cfg.num_heads
        n_down = len(dc) - 1

        def attends(i):
            return (cfg.im_size // 2**i) in cfg.attn_resolutions

        self.t_proj = nn.Sequential(nn.Linear(t_dim, t_dim), nn.SiLU(), nn.Linear(t_dim, t_dim))
        self.conv_in = nn.Conv2d(cfg.im_channels, dc[0], 3, padding=1)
        self.downs = nn.ModuleList(
            DownBlock(dc[i], dc[i + 1], t_dim, cfg.num_down_layers, heads, attends(i), ds[i], attn)
            for i in range(n_down)
        )
        self.mids = nn.ModuleList(
            MidBlock(mc[i], mc[i + 1], t_dim, cfg.num_mid_layers, heads, attn)
            for i in range(len(mc) - 1)
        )
        # up block for level i: x arrives with dc[i] channels, the skip adds dc[i]
        self.ups = nn.ModuleList(
            UpBlock(dc[i], 2 * dc[i], dc[i - 1] if i != 0 else dc[0], t_dim, cfg.num_up_layers, heads,
                    attends(i), ds[i], attn)
            for i in reversed(range(n_down))
        )
        self.norm_out = GroupNormSiLU(dc[0])
        self.conv_out = nn.Conv2d(dc[0], cfg.im_channels, 3, padding=1)

    def attention_shapes(self, height: int, width: int | None = None) -> list[tuple[int, int]]:
        return unet_attention_shapes(self.config, height, width)

    def attention_kernels(self, height: int, width: int | None = None) -> list[tuple[int, int, str]]:
        """(N, D, what runs it: "K1", "K2" or "softmax") of every attention
        layer, in forward order, for an input of (height, width) pixels."""
        return attention_kernels(self, self.attention_shapes(height, width))

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        """x (B, C, H, W), t (B,) or scalar int timesteps -> eps (B, C, H, W) f32.
        On CUDA a fused model with a flash-length attention layer computes in
        bf16/f16 (autocast, or 16-bit parameters), or in f32 where the f32
        kernels take each such layer's head dim (K1-f32 forward and K3-f32
        backward; K2-f32 at a qk_int8 layer, forward only): another dtype or
        head dim is refused here by name."""
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else self.conv_in.weight.dtype
        if self.fused:
            check_flash_precision(dev, dtype, self.attention_kernels(*x.shape[2:]), "Unet.forward")
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(x.shape[0])
        # f32, or f64 in a model run in f64 (as the JAX Dense casts it to the module's dtype)
        t_emb = self.t_proj(timestep_embedding(t, self.config.time_emb_dim).to(self.conv_in.weight.dtype))
        out = self.conv_in(x)
        skips = []
        for down in self.downs:
            skips.append(out)
            out = down(out, t_emb)
        for mid in self.mids:
            out = mid(out, t_emb)
        for up in self.ups:
            out = up(out, skips.pop(), t_emb)
        return self.conv_out(self.norm_out(out)).float()
