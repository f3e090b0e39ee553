"""Optimizers and learning-rate schedules (port of
weatherconverter_tpu/training/optim.py).

`adam` is the reference's Adam(lr) for DDPM training. torch.optim.Adam with
betas (0.9, 0.999) and eps 1e-8 is optax.adam's update: eps is added outside
the square root of the bias-corrected second moment in both.

Segmentation trains with SGD in two parameter groups, the backbone at its
own learning rate and everything else at the head's, each under a schedule
stepped once a batch. torch.optim.SGD's weight decay is coupled (the
gradient gains wd * param before the momentum trace), which is what the
JAX chain add_decayed_weights -> sgd(momentum) computes, and its first
momentum buffer is the gradient itself, as optax's trace from zeros is.
A schedule maps the update index t (from 0) to a learning rate; the train
step writes it into the group before each update.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn

Schedule = Callable[[int], float]


def adam(params: Iterable[torch.nn.Parameter], lr: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def poly_lr(base_lr: float, max_iters: int, power: float = 0.9, min_lr: float = 1e-6) -> Schedule:
    """PolyLR: max(base * (1 - min(t, T) / T)^power, min_lr)."""
    return lambda t: max(base_lr * (1.0 - min(t, max_iters) / max_iters) ** power, min_lr)


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """StepLR: base * gamma^(t // step_size)."""
    return lambda t: base_lr * gamma ** (t // step_size)


def make_schedule(sched_type: str, base_lr: float, max_iters: int, params: dict | None = None) -> Schedule:
    params = dict(params or {})
    if sched_type == "PolyLR":
        return poly_lr(base_lr, max_iters, params.get("power", 0.9), params.get("min_lr", 1e-6))
    if sched_type == "StepLR":
        return step_lr(base_lr, params.get("step_size", 10), params.get("gamma", 0.1))
    if sched_type in ("constant", "none"):
        return lambda t: base_lr
    raise ValueError(f"unknown scheduler type {sched_type!r}")


def make_seg_optimizer(
    model: nn.Module,
    opt_cfg,
    max_iters: int,
    sched_type: str = "PolyLR",
    sched_params: dict | None = None,
) -> tuple[torch.optim.SGD, list[Schedule]]:
    """SGD over two groups, `backbone.*` and the rest (the head), with their
    schedules in the same order. The rates are `layerwise_lr`'s "backbone"
    and "classifier" (the head's falls back to params.lr, the backbone's to a
    tenth of the head's)."""
    p = dict(opt_cfg.params)
    lw = dict(opt_cfg.layerwise_lr)
    head_lr = lw.get("classifier", p.get("lr", 1e-4))
    backbone_lr = lw.get("backbone", head_lr * 0.1)
    named = list(model.named_parameters())
    groups = [{"params": [q for n, q in named if n.startswith("backbone.")], "lr": backbone_lr},
              {"params": [q for n, q in named if not n.startswith("backbone.")], "lr": head_lr}]
    opt = torch.optim.SGD(groups, lr=head_lr, momentum=p.get("momentum", 0.9),
                          weight_decay=p.get("weight_decay", 1e-4))
    return opt, [make_schedule(sched_type, g["lr"], max_iters, sched_params) for g in groups]
