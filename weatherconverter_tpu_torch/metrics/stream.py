"""Streaming segmentation metrics (port of weatherconverter_tpu/metrics/stream.py).

The confusion-matrix update (`confusion_update`) runs on the device inside
the eval step, so only the (C, C) matrix crosses to the host, once a
validation pass. Rows are the ground truth, columns the prediction; labels
>= C (255, ignore) are dropped. Counts are int64 integers, never floats:
f32 counts stop adding 1 past 2^24 pixels in one cell. The derived metrics
(Overall/Mean/FreqW Acc, Mean IoU, per-class IoU) are computed on the host
in float64, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

IGNORE_INDEX = 255


def confusion_update(conf: torch.Tensor, pred: torch.Tensor, label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """conf + the (C, C) histogram of (label, pred) pairs of one batch."""
    label = label.reshape(-1).long()
    pred = pred.reshape(-1).long()
    mask = (label >= 0) & (label < num_classes)
    idx = torch.where(mask, num_classes * label + pred, num_classes * num_classes)
    hist = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return conf + hist[:-1].reshape(num_classes, num_classes).to(conf.dtype)


def init_confusion(num_classes: int, device=None) -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)


def compute_metrics(conf) -> dict:
    """The metric dict of a confusion matrix; keys as the reference's `get_results`."""
    conf = np.asarray(conf, dtype=np.float64)
    eps = 1e-12
    gt_sum = conf.sum(axis=1)
    pred_sum = conf.sum(axis=0)
    diag = np.diag(conf)
    total = conf.sum()

    acc = diag.sum() / max(total, eps)
    acc_cls_per = diag / np.maximum(gt_sum, eps)
    present = gt_sum > 0
    acc_cls = np.nanmean(np.where(present, acc_cls_per, np.nan))
    union = gt_sum + pred_sum - diag
    iu = diag / np.maximum(union, eps)
    mean_iu = np.nanmean(np.where(present | (pred_sum > 0), iu, np.nan))
    freq = gt_sum / max(total, eps)
    fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return {
        "Overall Acc": float(acc),
        "Mean Acc": float(acc_cls),
        "FreqW Acc": float(fwavacc),
        "Mean IoU": float(mean_iu),
        "Class IoU": {int(i): float(iu[i]) for i in range(conf.shape[0])},
    }


class StreamSegMetrics:
    """Host-side accumulation with the reference's interface (update /
    get_results / reset / to_str), int64 counts."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def update(self, label_trues, label_preds) -> None:
        batch = confusion_update(init_confusion(self.num_classes), torch.as_tensor(np.asarray(label_preds)),
                                 torch.as_tensor(np.asarray(label_trues)), self.num_classes)
        self._conf = self._conf + batch.numpy()

    def update_confusion(self, conf) -> None:
        """Merge a (C, C) matrix accumulated elsewhere (the eval step's, on the device)."""
        if isinstance(conf, torch.Tensor):
            conf = conf.cpu().numpy()
        self._conf = self._conf + np.asarray(conf, dtype=np.int64)

    def get_results(self) -> dict:
        return compute_metrics(self._conf)

    def reset(self) -> None:
        self._conf = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    @staticmethod
    def to_str(results: dict) -> str:
        s = "\n"
        for k, v in results.items():
            if k != "Class IoU":
                s += f"{k}: {v:.6f}\n"
        return s


class AverageMeter:
    """Running averages by id."""

    def __init__(self):
        self.book = {}

    def reset_all(self):
        self.book.clear()

    def reset(self, id: str):
        item = self.book.get(id)
        if item is not None:
            item[0] = 0.0
            item[1] = 0

    def update(self, id: str, val: float):
        record = self.book.get(id)
        if record is None:
            self.book[id] = [float(val), 1]
        else:
            record[0] += float(val)
            record[1] += 1

    def get_results(self, id: str) -> float:
        record = self.book.get(id)
        if record is None:
            raise KeyError(id)
        return record[0] / record[1]
