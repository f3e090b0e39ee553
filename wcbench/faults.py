"""Faults planted in the program under test, to show that the check catches
them: `with plant(kind, fault): ...` runs the timed path broken underneath.
A fault patches a function of the port where the harness's drivers reach it
through a module attribute, so it must be planted before the driver's Cell
is built. `kind` is the driver's ("translate", "train", "sample"); the
faults are

- "unchanged": a step returns its state unchanged;
- "half_batch": half of the batch left out, the mean taken over the rest;
- "altered": an answer altered where it is produced.

(The exchange between chips has no fault here: every cell runs on one card.)
"""

from __future__ import annotations

import contextlib
import importlib

FAULTS = ("unchanged", "half_batch", "altered")


def _targets(kind: str, fault: str):
    """(module, attribute, replacement factory taking the original)."""
    translate = "weatherconverter_tpu_torch.guidance.translate"
    sgg = "weatherconverter_tpu_torch.guidance.sgg"
    sampling = "weatherconverter_tpu_torch.diffusion.sampling"
    training = "weatherconverter_tpu_torch.training.diffusion"

    def bump(x):
        x = x.clone()
        x[(0,) * x.dim()] += 0.5 * x.abs().max()
        return x

    if kind == "translate":
        if fault == "unchanged":
            return translate, "sample_with_sgg", lambda f: lambda *a, xt_init=None, **k: (
                xt_init if xt_init is not None else f(*a, **k))
        if fault == "half_batch":
            def half(f):
                def ce(seg_fn, x, gt):
                    import torch

                    b = x.shape[0]
                    return f(seg_fn, x[: max(1, b // 2)], gt[: max(1, b // 2)]) + 0.0 * torch.sum(x[b // 2:])
                return ce
            return sgg, "seg_ce_per_image", half
        if fault == "altered":
            return translate, "sample_with_sgg", lambda f: lambda *a, **k: bump(f(*a, **k))
    if kind == "sample":
        if fault == "unchanged":
            return sampling, "dpm_2m_update", lambda f: lambda s, xt, x0, x0p, hp, *a: (xt, f(s, xt, x0, x0p, hp, *a)[1])
        if fault == "half_batch":
            def half(f):
                def update(s, xt, *a):
                    import torch

                    new, h = f(s, xt, *a)
                    b = xt.shape[0] // 2
                    return torch.cat([new[:max(1, b)], xt[max(1, b):]]), h
                return update
            return sampling, "dpm_2m_update", half
        if fault == "altered":
            return sampling, "dpm_solver_pp_2m_sample", lambda f: lambda *a, **k: bump(f(*a, **k))
    if kind == "train":
        if fault == "unchanged":
            return training, "train_step", lambda f: lambda state, images, *a, **k: (state, images.new_zeros(()).float())
        if fault == "half_batch":
            def half(f):
                def mse(pred, target):
                    b = pred.shape[0]
                    return f(pred[: max(1, b // 2)], target[: max(1, b // 2)])
                return mse
            return training, "mse_loss", half
        if fault == "altered":
            def alter(f):
                def sync(params, mesh):
                    params = list(params)
                    f(params, mesh)
                    params[0].grad.mul_(2.0)
                return sync
            return training, "sync_grads", alter
    return None


@contextlib.contextmanager
def plant(kind: str, fault: str):
    target = _targets(kind, fault)
    if target is None:
        raise ValueError(f"no fault {fault!r} for a {kind!r} cell")
    name, attr, make = target
    module = importlib.import_module(name)
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)
