"""The DDPM eps-prediction UNet in plain f32 PyTorch, NCHW.

A frozen, self-contained copy of the algorithm the port runs
(`weatherconverter_tpu_torch/models/unet.py` and `models/layers.py`), with
the same parameter names, so that one state dict loads into both. Nothing
of the port is imported. The attention is written out by hand:

- below 1024 tokens, or at a length that is not a multiple of 128: softmax
  with a row max (the short-sequence path);
- at flash length: the clamped softmax exp(clip(s, -60, 60)) with no row
  max, normalised after P V, in f32; with `qk_int8` the scores come from
  Q and K rounded to int8 at one scale each for the whole batch
  (scale = max(max|x|, 1e-6) / 127, round half to even), multiplied
  exactly and scaled by qs * ks / sqrt(D): the port's K2-f32 and its
  quantizer, and JAX's int8 kernel before them.

GroupNorm takes single-pass statistics (sum and sum of squares, variance
clamped at 0), as the port and the JAX package define it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

CLAMP = 60.0
FLASH_MIN_SEQ = 1024
GN_GROUPS = 8


def is_flash_length(n: int) -> bool:
    return n >= FLASH_MIN_SEQ and n % 128 == 0


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x rounded to int8 values (kept in f32) and its scale, one for the tensor."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-6) / xf.new_full((), 127.0)
    return torch.round(xf / scale), scale


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qk_int8: bool) -> torch.Tensor:
    """(B, H, N, D) f32 -> (B, H, N, D) f32, by the rules of the module docstring."""
    d = q.shape[-1]
    if not is_flash_length(q.shape[2]):
        s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / d**0.5)
        return torch.matmul(torch.softmax(s, dim=-1), v)
    if qk_int8:
        q8, qs = quantize(q)
        k8, ks = quantize(k)
        s = torch.matmul(q8, k8.transpose(-1, -2)) * (qs * ks / qs.new_full((), d**0.5))
    else:
        s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / d**0.5)
    p = torch.exp(s.clamp(-CLAMP, CLAMP))
    return torch.matmul(p, v) / p.sum(dim=-1, keepdim=True)


def group_norm(x, weight, bias, groups: int = GN_GROUPS, eps: float = 1e-5, silu: bool = False):
    n, c, h, w = x.shape
    xf = x.reshape(n, groups, c // groups, h * w)
    count = (c // groups) * h * w
    mean = xf.sum(dim=(2, 3), keepdim=True) / count
    var = ((xf * xf).sum(dim=(2, 3), keepdim=True) / count - mean * mean).clamp_min(0.0)
    scale = torch.rsqrt(var + eps) * weight.reshape(1, groups, c // groups, 1)
    out = (xf * scale + (bias.reshape(1, groups, c // groups, 1) - mean * scale)).reshape(n, c, h, w)
    return F.silu(out) if silu else out


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    factor = 10000.0 ** (torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] / factor[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class GroupNormSiLU(nn.Module):
    def __init__(self, channels: int, silu: bool = True):
        super().__init__()
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, silu=self.silu)


def _norm_conv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(GroupNormSiLU(cin), nn.Identity(), nn.Conv2d(cin, cout, 3, padding=1))


class SelfAttention2D(nn.Module):
    def __init__(self, channels: int, num_heads: int, qk_int8: bool):
        super().__init__()
        self.num_heads, self.head_dim, self.qk_int8 = num_heads, channels // num_heads, qk_int8
        self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        self.out_proj = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        tokens = x.flatten(2).transpose(1, 2)
        q, k, v = F.linear(tokens, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)

        def heads(t):
            return t.reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2)

        out = attention(heads(q), heads(k), heads(v), self.qk_int8)
        out = self.out_proj(out.transpose(1, 2).reshape(b, n, c))
        return out.transpose(1, 2).reshape(b, c, h, w)


class ResnetTimeBlock(nn.Module):
    def __init__(self, channels, t_dim, num_attn, attn_channels, num_heads, qk_int8):
        super().__init__()
        self.resnet_conv_first = nn.ModuleList(_norm_conv(ci, co) for ci, co in channels)
        self.t_emb_layers = nn.ModuleList(nn.Sequential(nn.SiLU(), nn.Linear(t_dim, co)) for _, co in channels)
        self.resnet_conv_second = nn.ModuleList(_norm_conv(co, co) for _, co in channels)
        self.residual_input_conv = nn.ModuleList(nn.Conv2d(ci, co, 1) for ci, co in channels)
        if num_attn:
            self.attention_norms = nn.ModuleList(GroupNormSiLU(attn_channels, silu=False) for _ in range(num_attn))
            self.attentions = nn.ModuleList(SelfAttention2D(attn_channels, num_heads, qk_int8)
                                            for _ in range(num_attn))

    def resnet(self, j, x, t_emb):
        h = self.resnet_conv_first[j](x) + self.t_emb_layers[j](t_emb)[:, :, None, None]
        return self.resnet_conv_second[j](h) + self.residual_input_conv[j](x)

    def attend(self, j, x):
        return x + self.attentions[j](self.attention_norms[j](x))


class DownBlock(ResnetTimeBlock):
    def __init__(self, cin, cout, t_dim, num_layers, heads, use_attn, down_sample, qk_int8):
        super().__init__([(cin if j == 0 else cout, cout) for j in range(num_layers)], t_dim,
                         num_layers if use_attn else 0, cout, heads, qk_int8)
        self.num_layers, self.use_attn = num_layers, use_attn
        self.down_sample_conv = nn.Conv2d(cout, cout, 4, 2, 1) if down_sample else None

    def forward(self, x, t_emb):
        for j in range(self.num_layers):
            x = self.resnet(j, x, t_emb)
            if self.use_attn:
                x = self.attend(j, x)
        return x if self.down_sample_conv is None else self.down_sample_conv(x)


class MidBlock(ResnetTimeBlock):
    def __init__(self, cin, cout, t_dim, num_layers, heads, qk_int8):
        super().__init__([(cin, cout)] + [(cout, cout)] * num_layers, t_dim, num_layers, cout, heads, qk_int8)
        self.num_layers = num_layers

    def forward(self, x, t_emb):
        x = self.resnet(0, x, t_emb)
        for j in range(self.num_layers):
            x = self.resnet(j + 1, self.attend(j, x), t_emb)
        return x


class UpBlock(ResnetTimeBlock):
    def __init__(self, x_ch, cin, cout, t_dim, num_layers, heads, use_attn, up_sample, qk_int8):
        super().__init__([(cin if j == 0 else cout, cout) for j in range(num_layers)], t_dim,
                         num_layers if use_attn else 0, cout, heads, qk_int8)
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
    """`cfg` holds the YAML's model keys: im_channels, im_size, down_channels,
    mid_channels, down_sample, time_emb_dim, num_down_layers, num_mid_layers,
    num_up_layers, num_heads, attn_resolutions."""

    def __init__(self, cfg: dict, qk_int8: bool = False):
        super().__init__()
        self.cfg = cfg
        dc, mc, ds = list(cfg["down_channels"]), list(cfg["mid_channels"]), list(cfg["down_sample"])
        t_dim, heads, n_down = cfg["time_emb_dim"], cfg["num_heads"], len(dc) - 1

        def attends(i):
            return (cfg["im_size"] // 2**i) in cfg["attn_resolutions"]

        self.t_proj = nn.Sequential(nn.Linear(t_dim, t_dim), nn.SiLU(), nn.Linear(t_dim, t_dim))
        self.conv_in = nn.Conv2d(cfg["im_channels"], dc[0], 3, padding=1)
        self.downs = nn.ModuleList(DownBlock(dc[i], dc[i + 1], t_dim, cfg["num_down_layers"], heads, attends(i),
                                             ds[i], qk_int8) for i in range(n_down))
        self.mids = nn.ModuleList(MidBlock(mc[i], mc[i + 1], t_dim, cfg["num_mid_layers"], heads, qk_int8)
                                  for i in range(len(mc) - 1))
        self.ups = nn.ModuleList(UpBlock(dc[i], 2 * dc[i], dc[i - 1] if i != 0 else dc[0], t_dim,
                                         cfg["num_up_layers"], heads, attends(i), ds[i], qk_int8)
                                 for i in reversed(range(n_down)))
        self.norm_out = GroupNormSiLU(dc[0])
        self.conv_out = nn.Conv2d(dc[0], cfg["im_channels"], 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(x.shape[0])
        t_emb = self.t_proj(timestep_embedding(t, self.cfg["time_emb_dim"]))
        out = self.conv_in(x)
        skips = []
        for down in self.downs:
            skips.append(out)
            out = down(out, t_emb)
        for mid in self.mids:
            out = mid(out, t_emb)
        for up in self.ups:
            out = up(out, skips.pop(), t_emb)
        return self.conv_out(self.norm_out(out))


def attention_layers(cfg: dict, batch: int) -> list[tuple[int, int, int, int]]:
    """(B, H, N, D) of every attention layer of the UNet at its own size, in
    forward order."""
    dc, mc, ds, heads = list(cfg["down_channels"]), list(cfg["mid_channels"]), list(cfg["down_sample"]), \
        cfg["num_heads"]
    size, sizes, shapes = cfg["im_size"], [], []
    for i in range(len(dc) - 1):
        sizes.append(size)
        if (cfg["im_size"] // 2**i) in cfg["attn_resolutions"]:
            shapes += [(size * size, dc[i + 1] // heads)] * cfg["num_down_layers"]
        if ds[i]:
            size //= 2
    shapes += [(size * size, mc[i + 1] // heads) for i in range(len(mc) - 1) for _ in range(cfg["num_mid_layers"])]
    for i in reversed(range(len(dc) - 1)):
        if (cfg["im_size"] // 2**i) in cfg["attn_resolutions"]:
            shapes += [(sizes[i] ** 2, (dc[i - 1] if i else dc[0]) // heads)] * cfg["num_up_layers"]
    return [(batch, heads, n, d) for n, d in shapes]


def flash_layers(cfg: dict, batch: int) -> list[tuple[int, int, int, int]]:
    return [s for s in attention_layers(cfg, batch) if is_flash_length(s[2])]


def param_count(model: nn.Module) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())
