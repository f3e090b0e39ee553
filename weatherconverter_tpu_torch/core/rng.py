"""Seeded random streams: named `torch.Generator`s derived from one run seed.

Port of weatherconverter_tpu/core/rng.py. JAX threads `jax.random` keys;
here every stochastic component draws from its own `torch.Generator`, made
from the run seed and the component's position in the list of names, so a
run is reproducible and adding a draw to one component does not shift
another's stream. The two frameworks give different numbers from the same
seed: a test that compares them replays the JAX draws (see the `t=`,
`noise=`, `offsets=` and `flip=` arguments of the training functions).
"""

from __future__ import annotations

import hashlib

import torch


def run_key(seed: int) -> int:
    """The root of a run's streams: the seed itself (a plain int, since a
    torch.Generator cannot be split the way a jax.random key is)."""
    return int(seed)


def _derive_seed(key: int, index: int) -> int:
    """A 63-bit seed for stream `index` of `key`, stable across runs and
    platforms."""
    digest = hashlib.sha256(f"{key}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def split_named(key: int, *names: str, device=None) -> dict[str, torch.Generator]:
    """One generator per name on `device` (the CPU by default); stable: the
    order of the names matters, as in the JAX function."""
    return {name: torch.Generator(device=device).manual_seed(_derive_seed(key, i)) for i, name in enumerate(names)}
