"""Random weights from the seed, made on the device in one draw.

Every tensor of a model's state dict gets PyTorch's default initial values
by kind: a weight of two or more dimensions U(-b, b) with b = 1 / sqrt(fan
in) (fan in = the product of its dimensions after the first, as PyTorch
counts it for linear, convolution and transposed convolution); a bias beside
such a weight the same; a one-dimensional scale 1 (0.25 for a PReLU slope);
any other bias 0; BatchNorm's running mean 0 and variance 1. All the uniform
values come from one `torch.rand` call on the device, cut into the tensors,
so a model of 10^8 parameters is made in milliseconds. The same seed gives
the same tensors, which the program and the reference both load.
"""

from __future__ import annotations

import hashlib
import math

import torch
from torch import nn


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream `tag` of the run seeded by `seed` (any integer)."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:8], "little") >> 1


def _kinds(module: nn.Module) -> dict[str, tuple[str, float]]:
    """name -> (kind, bound) of every tensor of module.state_dict()."""
    dims = {n: tuple(t.shape) for n, t in module.state_dict().items()}
    out = {}
    for prefix, mod in module.named_modules():
        base = f"{prefix}." if prefix else ""
        for name, t in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            full = base + name
            if t.dim() >= 2:
                out[full] = ("uniform", 1.0 / math.sqrt(math.prod(t.shape[1:])))
            elif name == "running_var":
                out[full] = ("fill", 1.0)
            elif name in ("running_mean", "num_batches_tracked"):
                out[full] = ("fill", 0.0)
            elif name.endswith("bias"):
                sibling = dims.get(base + name[: -len("bias")] + "weight")
                if sibling is not None and len(sibling) >= 2:
                    out[full] = ("uniform", 1.0 / math.sqrt(math.prod(sibling[1:])))
                else:
                    out[full] = ("fill", 0.0)
            else:
                out[full] = ("fill", 0.25 if type(mod).__name__ == "PReLU" else 1.0)
    return out


def make_weights(module: nn.Module, seed: int, device, tag: str = "weights") -> dict[str, torch.Tensor]:
    """The state dict of `module` (which may live on the meta device) filled
    from `seed`, on `device`, in f32 (integer buffers in their own dtype)."""
    spec = module.state_dict()
    kinds = _kinds(module)
    numels = {n: t.numel() for n, t in spec.items() if kinds[n][0] == "uniform"}
    gen = torch.Generator(device=device).manual_seed(derive(seed, tag))
    flat = torch.rand(sum(numels.values()), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, t in spec.items():
        kind, value = kinds[name]
        if kind == "uniform":
            n = numels[name]
            out[name] = (flat[at:at + n] * value).reshape(t.shape)
            at += n
        else:
            out[name] = torch.full(t.shape, value, dtype=t.dtype if not t.dtype.is_floating_point else torch.float32,
                                   device=device)
    return out


def build(factory, weights: dict[str, torch.Tensor], device) -> nn.Module:
    """factory() built on the meta device, moved to `device` uninitialised and
    loaded with `weights` (strict)."""
    with torch.device("meta"):
        model = factory()
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model
