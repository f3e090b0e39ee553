"""Translation quality gates: mIoU-consistency (port of
weatherconverter_tpu/metrics/quality.py); FID is metrics/fid.py.

mIoU-consistency runs the frozen seg model on translated images and scores
it against the original ground truth with the streaming confusion matrix
(metrics/stream.py): a translation that keeps the layout keeps
seg(translated) as close to the labels as seg(original). The report carries
both numbers and their gap. The confusion matrix accumulates on the device;
one (C, C) read-back a pass.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from weatherconverter_tpu_torch.metrics.stream import compute_metrics, confusion_update, init_confusion


def miou_consistency(seg_fn: Callable[[torch.Tensor], torch.Tensor],
                     batches: Iterable[tuple[torch.Tensor, torch.Tensor]], num_classes: int = 19) -> dict:
    """seg(images) against gt over (images, gt) batches: `seg_fn` maps images
    (in the layout it takes) to (B, C, H, W) logits, gt is (B, H, W) train ids
    (255 ignored). Returns the reference-keyed metrics dict ('Mean IoU',
    'Overall Acc', ...)."""
    conf = None
    with torch.no_grad():
        for images, gt in batches:
            pred = seg_fn(images).argmax(dim=1)
            if conf is None:
                conf = init_confusion(num_classes, pred.device)
            conf = confusion_update(conf, pred, gt.to(pred.device), num_classes)
    if conf is None:
        raise ValueError("miou_consistency: no batches")
    return compute_metrics(conf.cpu().numpy())


def consistency_gap(seg_fn: Callable[[torch.Tensor], torch.Tensor], original_batches: list,
                    translated_batches: list, num_classes: int = 19) -> dict:
    """mIoU of seg(original) and of seg(translated) against the same gt, and
    their gap, with both passes' metric dicts."""
    orig = miou_consistency(seg_fn, original_batches, num_classes)
    trans = miou_consistency(seg_fn, translated_batches, num_classes)
    return {
        "original_miou": orig["Mean IoU"],
        "translated_miou": trans["Mean IoU"],
        "miou_consistency_gap": orig["Mean IoU"] - trans["Mean IoU"],
        "original": orig,
        "translated": trans,
    }
