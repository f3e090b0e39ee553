"""ops — see weatherconverter_tpu.ops for the JAX counterpart."""

import torch


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """`t` in f32, or as it is if it is f64: the models' outputs and the
    chains' inputs are f32 (bf16 under autocast comes back up), while a
    model run in f64 (`.double()`, to study rounding) stays in f64."""
    return t if t.dtype == torch.float64 else t.float()
