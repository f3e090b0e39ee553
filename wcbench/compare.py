"""The numbers `correct` is decided by, each a gap between what the program
produced and what the plain reference computes from the same inputs."""

from __future__ import annotations

import torch


def rel_max(out: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor | float | None = None) -> float:
    """max |out - ref| over `scale` (default max |ref|)."""
    d = (out.double() - ref.double()).abs().max()
    s = ref.double().abs().max() if scale is None else torch.as_tensor(scale, dtype=torch.float64)
    return float(d / s.clamp_min(1e-30)) if torch.is_tensor(s) else float(d / max(s, 1e-30))


def _norms(tree: dict[str, torch.Tensor]) -> dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tree.items()}


def kept_leaves(ref_grads: dict[str, torch.Tensor], share: float = 1e-3) -> list[str]:
    """The leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others (a key's bias under softmax) move by round-off."""
    norms = _norms(ref_grads)
    median = sorted(norms.values())[len(norms) // 2]
    return [n for n, v in norms.items() if v >= share * median]


def leaf_gaps(out: dict[str, torch.Tensor], ref: dict[str, torch.Tensor], leaves: list[str]) -> list[float]:
    """For each of `leaves`, | |out_leaf| - |ref_leaf| | / max(|ref_leaf|, the
    median leaf's |ref|): the gap of the norms, not the norm of the gap."""
    ref_n, out_n = _norms({n: ref[n] for n in leaves}), _norms({n: out[n] for n in leaves})
    median = sorted(ref_n.values())[len(ref_n) // 2]
    return [abs(out_n[n] - ref_n[n]) / max(ref_n[n], median, 1e-30) for n in leaves]


def worst_leaf_gap(out, ref, leaves) -> float:
    return max(leaf_gaps(out, ref, leaves))


def median_leaf_gap(out, ref, leaves) -> float:
    gaps = sorted(leaf_gaps(out, ref, leaves))
    return gaps[len(gaps) // 2]
