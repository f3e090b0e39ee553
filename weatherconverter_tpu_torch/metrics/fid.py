"""Frechet Inception Distance (port of weatherconverter_tpu/metrics/fid.py),
the quality gate BASELINE.md names for the translation pipeline.

Feature statistics accumulate on the features' device as f32 sums (a count,
the sum and the sum of outer products), centred at `finalize` with Bessel's
correction. The distance takes the symmetric PSD form

    FID = |mu_a - mu_b|^2 + tr(S_a + S_b - 2 (S_a^1/2 S_b S_a^1/2)^1/2)

with each square root from `torch.linalg.eigh`, eigenvalues clamped at
1e-10: the trace equals that of sqrtm(S_a S_b), with no host round trip.
Only the final scalar is read back. A feature extractor maps an image
batch, in whatever layout it takes, to (B, D): InceptionV3 pool3
(models/inception.py) for FID proper, or an embedding such as the seg
backbone's pooled features for relative tracking only.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import torch


class FeatureStats(NamedTuple):
    """Streaming first and second moments of feature vectors, f32."""

    n: torch.Tensor  # () count
    s1: torch.Tensor  # (D,) sum of features
    s2: torch.Tensor  # (D, D) sum of outer products

    @staticmethod
    def init(dim: int, device=None) -> "FeatureStats":
        f32 = dict(dtype=torch.float32, device=device)
        return FeatureStats(torch.zeros((), **f32), torch.zeros((dim,), **f32), torch.zeros((dim, dim), **f32))

    def update(self, feats: torch.Tensor) -> "FeatureStats":
        """feats (B, D); a new accumulator (the inputs are left as they are)."""
        f = feats.float()
        return FeatureStats(self.n + f.shape[0], self.s1 + f.sum(dim=0), self.s2 + f.T @ f)

    def finalize(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(mu (D,), cov (D, D)), Bessel-corrected as np.cov and the standard FID code."""
        mu = self.s1 / self.n
        cov = (self.s2 - torch.outer(mu, self.s1)) / torch.clamp_min(self.n - 1.0, 1.0)
        return mu, cov


def _psd_sqrt(m: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Square root of a symmetric PSD matrix by eigh, eigenvalues clamped at eps."""
    w, v = torch.linalg.eigh((m + m.T) / 2.0)
    return (v * torch.sqrt(torch.clamp_min(w, eps))[None, :]) @ v.T


def frechet_distance(mu_a: torch.Tensor, cov_a: torch.Tensor, mu_b: torch.Tensor, cov_b: torch.Tensor) -> torch.Tensor:
    """The Frechet distance between two Gaussians, symmetric PSD form (a 0-d tensor)."""
    a_sqrt = _psd_sqrt(cov_a)
    mid = _psd_sqrt(a_sqrt @ cov_b @ a_sqrt)
    diff = mu_a - mu_b
    return diff @ diff + torch.trace(cov_a) + torch.trace(cov_b) - 2.0 * torch.trace(mid)


def compute_fid(feats_a: torch.Tensor, feats_b: torch.Tensor) -> torch.Tensor:
    """FID between two feature sets (N_a, D) and (N_b, D)."""
    sa = FeatureStats.init(feats_a.shape[-1], feats_a.device).update(feats_a)
    sb = FeatureStats.init(feats_b.shape[-1], feats_b.device).update(feats_b)
    return frechet_distance(*sa.finalize(), *sb.finalize())


def _stream(feature_fn: Callable[[torch.Tensor], torch.Tensor], batches: Iterable[torch.Tensor]) -> FeatureStats:
    stats = None
    with torch.no_grad():
        for xb in batches:
            feats = feature_fn(xb)
            if stats is None:
                stats = FeatureStats.init(feats.shape[-1], feats.device)
            stats = stats.update(feats)
    if stats is None:
        raise ValueError("fid_from_batches: no batches")
    return stats


def fid_from_batches(feature_fn: Callable[[torch.Tensor], torch.Tensor], batches_a: Iterable[torch.Tensor],
                     batches_b: Iterable[torch.Tensor]) -> float:
    """Stream two iterables of image batches through `feature_fn` (batch ->
    (B, D)) and return the FID. The statistics stay on the features' device;
    only the final scalar is read back."""
    mu_a, cov_a = _stream(feature_fn, batches_a).finalize()
    mu_b, cov_b = _stream(feature_fn, batches_b).finalize()
    return float(frechet_distance(mu_a, cov_a, mu_b, cov_b))
