"""UNet building blocks, NCHW (port of weatherconverter_tpu/models/layers.py).

Parameter names follow the torch layout that
weatherconverter_tpu/compat/torch_export.export_unet writes, so JAX-trained
weights load with `load_state_dict(strict=True)`: a block holds its layers
in ModuleLists named `resnet_conv_first`, `t_emb_layers`,
`resnet_conv_second`, `residual_input_conv`, `attention_norms` and
`attentions`, all owned by `ResnetTimeBlock`, the base class of the
Down/Mid/Up blocks. The 2x upsampler is plain nn.ConvTranspose2d(k=4, s=2,
p=1), the operation the JAX package emulates (layers.py:124-163).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from weatherconverter_tpu_torch.ops.attention import layer_kernel, multi_head_attention, qk_int8_takes
from weatherconverter_tpu_torch.ops.groupnorm import group_norm_reference

GN_GROUPS = 8


class GroupNormSiLU(nn.Module):
    """GroupNorm(8) with an optional SiLU, parameters named like nn.GroupNorm's."""

    def __init__(self, channels: int, num_groups: int = GN_GROUPS, silu: bool = True, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.silu, self.eps = num_groups, silu, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_reference(x, self.weight, self.bias, self.num_groups, self.eps, self.silu)


def _norm_conv(cin: int, cout: int) -> nn.Sequential:
    """GN+SiLU -> Conv3x3. Index 1 stands for the SiLU, which the norm applies,
    so the conv keeps the torch layout's index 2."""
    return nn.Sequential(GroupNormSiLU(cin), nn.Identity(), nn.Conv2d(cin, cout, 3, padding=1))


class SelfAttention2D(nn.Module):
    """Multi-head self-attention over the h*w tokens (row-major) of an NCHW map.

    Owns `in_proj_weight` (3C, C), `in_proj_bias` and `out_proj` under
    nn.MultiheadAttention's names; the split order is q, k, v and each head
    takes a contiguous channel slice. Its forward calls the port's
    `multi_head_attention` (the flash kernels at N >= 1024), not MHA's fused
    path. The pre-norm and the residual add belong to the block.
    `qk_int8` takes K2 where K2 has this layer's head dim, which is every
    head dim of the repo's models (`ops/attention.qk_int8_takes`).
    `per_item` gives K2 one int8 scale a batch row (the server's requests),
    not one for the batch. Not `fused` (JAX's fused=False), it attends by
    plain softmax at every length, with no kernel.
    """

    def __init__(self, channels: int, num_heads: int, qk_int8: bool = False, per_item: bool = False,
                 fused: bool = True):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, channels // num_heads
        self.qk_int8 = qk_int8_takes(self.head_dim, qk_int8)
        self.per_item, self.fused = per_item, fused
        self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        self.out_proj = nn.Linear(channels, channels)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        out = self.attend_tokens(x.flatten(2).transpose(1, 2))
        return out.transpose(1, 2).reshape(b, c, h, w)

    def attend_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, N, C) tokens -> (B, N, C): the projections and the attention."""
        b, n, c = tokens.shape
        q, k, v = F.linear(tokens, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)

        def heads(t):  # (B, N, C) -> (B, H, N, D)
            return t.reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2)

        out = multi_head_attention(heads(q), heads(k), heads(v), qk_int8=self.qk_int8, per_item=self.per_item,
                                   fused=self.fused)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


def attention_kernels(model: nn.Module, shapes: list[tuple[int, int]]) -> list[tuple[int, int, str]]:
    """(N, D, what runs it: "K1", "K2" or "softmax") of each attention layer
    of `model`, whose (N, D) in forward order are `shapes`: its
    SelfAttention2D modules, in registration order, are that order."""
    layers = [m for m in model.modules() if isinstance(m, SelfAttention2D)]
    return [(n, d, layer_kernel(n, d, m.qk_int8, m.fused)) for (n, d), m in zip(shapes, layers, strict=True)]


class ResnetTimeBlock(nn.Module):
    """The layers of one UNet block: residual layers j (`channels[j]` is their
    (in, out)), each GN+SiLU -> Conv3x3 -> (+ time proj) -> GN+SiLU -> Conv3x3
    -> + 1x1(x), and, where the block attends, pre-normed residual
    self-attention layers on `attn_channels` (`attn` holds their
    SelfAttention2D options: qk_int8, per_item, fused). Down/Mid/UpBlock
    subclass it and differ only in the order of the layers and in
    resampling."""

    def __init__(
        self,
        channels: list[tuple[int, int]],
        t_emb_dim: int,
        num_attn: int = 0,
        attn_channels: int = 0,
        num_heads: int = 1,
        attn: dict | None = None,
    ):
        super().__init__()
        self.resnet_conv_first = nn.ModuleList(_norm_conv(ci, co) for ci, co in channels)
        self.t_emb_layers = nn.ModuleList(
            nn.Sequential(nn.SiLU(), nn.Linear(t_emb_dim, co)) for _, co in channels
        )
        self.resnet_conv_second = nn.ModuleList(_norm_conv(co, co) for _, co in channels)
        self.residual_input_conv = nn.ModuleList(nn.Conv2d(ci, co, 1) for ci, co in channels)
        if num_attn:
            self.attention_norms = nn.ModuleList(
                GroupNormSiLU(attn_channels, silu=False) for _ in range(num_attn)
            )
            self.attentions = nn.ModuleList(
                SelfAttention2D(attn_channels, num_heads, **(attn or {})) for _ in range(num_attn)
            )

    def resnet(self, j: int, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.resnet_conv_first[j](x)
        h = h + self.t_emb_layers[j](t_emb)[:, :, None, None]
        h = self.resnet_conv_second[j](h)
        return h + self.residual_input_conv[j](x)

    def attend(self, j: int, x: torch.Tensor) -> torch.Tensor:
        return x + self.attentions[j](self.attention_norms[j](x))

