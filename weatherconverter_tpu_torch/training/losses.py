"""Losses: the eps-MSE of DDPM training and cross-entropy with an ignore
index (port of weatherconverter_tpu/training/losses.py; focal loss waits for
the segmentation-training slice). Logits are (B, C, ...), torch's
class-second convention; labels (B, ...) integer train-ids."""

from __future__ import annotations

import torch
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


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = IGNORE_INDEX,
    reduction: str = "mean",
) -> torch.Tensor:
    """nn.CrossEntropyLoss(ignore_index) semantics: 'mean' is over the
    non-ignored pixels (0 when every pixel is ignored)."""
    ce, valid = _per_pixel_ce(logits, labels, ignore_index)
    if reduction == "none":
        return ce
    if reduction == "sum":
        return ce.sum()
    return ce.sum() / valid.sum().clamp_min(1)
