"""Losses: the eps-MSE of DDPM training, cross-entropy and focal loss with an
ignore index for segmentation, and the SRGAN's adversarial BCE (port of
weatherconverter_tpu/training/losses.py). Logits are (B, C, ...), torch's
class-second convention; labels (B, ...) integer train-ids.

Under data parallelism (`group=`, a process group) CE and focal divide this
rank's sum by the valid-pixel count of the whole group's batch, all-reduced,
as JAX's loss over a mesh counts the global batch: each rank's loss is then
its share of the global mean, the train steps sum the gradients across
ranks, and the loss they report is the all-reduced sum of the shares."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

IGNORE_INDEX = 255


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error, computed in f32 whatever the inputs' dtype."""
    return torch.mean(torch.square(pred.float() - target.float()))


def _per_pixel_ce(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel CE in f32 (0 at ignored pixels) and the validity mask."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = F.log_softmax(logits.float(), dim=1)
    ce = -logz.gather(1, safe.unsqueeze(1)).squeeze(1)
    return torch.where(valid, ce, torch.zeros_like(ce)), valid


def _valid_count(valid: torch.Tensor, group=None) -> torch.Tensor:
    """The valid pixels, over the group's whole batch when a group is given
    (at least 1, so an all-ignored batch gives a loss of 0)."""
    count = valid.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    return count.clamp_min(1)


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = IGNORE_INDEX,
    reduction: str = "mean",
    group=None,
) -> torch.Tensor:
    """nn.CrossEntropyLoss(ignore_index) semantics: 'mean' is over the
    non-ignored pixels (0 when every pixel is ignored), of the group's whole
    batch under `group` (module docstring)."""
    ce, valid = _per_pixel_ce(logits, labels, ignore_index)
    if reduction == "none":
        return ce
    if reduction == "sum":
        return ce.sum()
    return ce.sum() / _valid_count(valid, group)


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    alpha: float = 1.0,
    gamma: float = 2.0,
    ignore_index: int = IGNORE_INDEX,
    group=None,
) -> torch.Tensor:
    """alpha * (1 - exp(-ce))^gamma * ce per pixel, averaged over the
    non-ignored pixels (the JAX package's normalization; the reference
    divides by every pixel), of the group's whole batch under `group`."""
    ce, valid = _per_pixel_ce(logits, labels, ignore_index)
    focal = alpha * (1.0 - torch.exp(-ce)) ** gamma * ce
    return torch.where(valid, focal, torch.zeros_like(focal)).sum() / _valid_count(valid, group)


def make_seg_loss(loss_type: str, params: dict | None = None):
    """The config's loss section (`training.loss_function`) as
    loss(logits, labels, group=None)."""
    params = dict(params or {})
    ignore = params.get("ignore_index", IGNORE_INDEX)
    if loss_type in ("CrossEntropyLoss", "ce", "cross_entropy"):
        reduction = params.get("reduction", "mean")
        return lambda logits, labels, group=None: cross_entropy_loss(logits, labels, ignore, reduction, group)
    if loss_type in ("FocalLoss", "focal"):
        alpha, gamma = params.get("alpha", 1.0), params.get("gamma", 2.0)
        return lambda logits, labels, group=None: focal_loss(logits, labels, alpha, gamma, ignore, group)
    raise ValueError(f"unknown loss type {loss_type!r}")


def bce_logits(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on PROBABILITIES (the discriminator ends in a
    sigmoid), despite the JAX name: pred clipped to [1e-7, 1 - 1e-7], then
    -mean(t log p + (1 - t) log(1 - p)), in f32."""
    pred = pred.float().clamp(1e-7, 1 - 1e-7)
    return -torch.mean(target * torch.log(pred) + (1 - target) * torch.log(1 - pred))
