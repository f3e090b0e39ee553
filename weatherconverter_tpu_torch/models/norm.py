"""BatchNorm that trains as flax's does (the port's counterpart of
weatherconverter_tpu/models/norm.py, which holds the JAX package's
momentum knob).

In train mode both frameworks normalize with the batch's biased variance,
but they update the running variance differently: flax with the biased
batch variance, `torch.nn.BatchNorm2d` with the unbiased one (n / (n - 1)
times it; at a 1 x 1 map, n is the batch). `BatchNorm2d` here keeps
cuDNN's fused train-mode kernel and then replaces torch's batch term in the
running variance by the biased one, in place on the C-length buffer, with
no further pass over the input. Where a channel sees one value (n = 1, the
ASPP pooling branch at batch 1), torch raises; flax normalizes to the bias
and updates with variance 0, and so does this module.

Data parallelism: inside `synced_batchnorm(model, group)` (the train steps
enter it under a mesh) a train-mode forward takes its statistics (mean,
biased variance, count) over the whole group, as JAX's step over a mesh
computes them over the global batch: sums all-reduced through
`torch.distributed.nn.functional.all_reduce`, which is differentiable, so the
backward (and the seg step's input gradient) sees the global statistics as
GSPMD's does. The running statistics then move by the global batch's, the
running variance by the biased one (flax's). Without a group of more than
one rank the path is the one above, bit for bit.

Momentum is torch's convention (new = (1 - m) * old + m * batch), so
`model.bn_momentum` of the YAML files applies as it is; flax's is 1 - m.
The JAX package scopes the configured momentum to the backbone and leaves
the head at 0.1 (models/deeplab.DeepLabV3); `set_bn_momentum` does that
here on a module tree.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance takes the biased
    batch variance (flax's update); eval mode is nn.BatchNorm2d's.
    `sync_group` (set by `synced_batchnorm`) takes train-mode statistics
    over that process group."""

    sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.sync_group is not None and dist.get_world_size(self.sync_group) > 1:
            return self._synced_forward(x, self.sync_group)
        n = x.numel() // x.shape[1]
        m = self.momentum
        if n == 1:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            scale = torch.rsqrt(var + self.eps) * self.weight
            out = (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        else:
            # autograd keeps the running-variance argument for the backward, so
            # torch's update goes to a copy, which is never written again
            torched = self.running_var.clone()
            out = F.batch_norm(x, self.running_mean, torched, self.weight, self.bias, True, m, self.eps)
        with torch.no_grad():
            if n == 1:
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), m)
                self.running_var.mul_(1.0 - m)  # the batch variance is 0
            else:
                # torch wrote (1 - m) old + m v n/(n-1); flax's (1 - m) old + m v is
                # that times (1 - 1/n) plus (1 - m) old / n
                self.running_var.mul_((1.0 - m) / n).add_(torched, alpha=1.0 - 1.0 / n)
            self.num_batches_tracked.add_(1)
        return out

    def _synced_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        """Train mode over the group's whole batch: the channel sums and the
        count, then the centred sums of squares, each all-reduced, in f32 (f64
        for f64 inputs)."""
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.new_full((1,), x.numel() // c)
        stats = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)), count]), group=group)
        n = stats[c]
        mean = stats[:c] / n
        centred = xf - mean[:, None, None]
        var = all_reduce((centred * centred).sum(dim=(0, 2, 3)), group=group) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = centred * scale[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), m)
            self.running_var.lerp_(var.to(self.running_var.dtype), m)  # the biased batch variance, flax's
            self.num_batches_tracked.add_(1)
        return out.to(x.dtype)


@contextmanager
def synced_batchnorm(module: nn.Module, group):
    """Every BatchNorm2d of this module under `module` takes its train-mode
    statistics over `group` inside the block (no-op for None)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)] if group is not None else []
    for m in bns:
        m.sync_group = group
    try:
        yield
    finally:
        for m in bns:
            m.sync_group = None


def set_bn_momentum(module: nn.Module, momentum: float) -> None:
    """Every BatchNorm under `module` at torch-convention `momentum`."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = momentum
