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
import itertools
from typing import Iterator

import torch


def run_key(seed: int) -> int:
    """The root of a run's streams: the seed itself (a plain int, since a
    torch.Generator cannot be split the way a jax.random key is)."""
    return int(seed)


def _derive_seed(key: int, index) -> int:
    """A 63-bit seed for stream `index` (an int, or a tagged string) of
    `key`, stable across runs and platforms."""
    digest = hashlib.sha256(f"{key}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def split_named(key: int, *names: str, device=None) -> dict[str, torch.Generator]:
    """One generator per name on `device` (the CPU by default); stable: the
    order of the names matters, as in the JAX function."""
    return {name: torch.Generator(device=device).manual_seed(_derive_seed(key, i)) for i, name in enumerate(names)}


def epoch_keys(key: int, num_epochs: int) -> list[int]:
    """One derived int key per epoch. Tagged apart from `split_named`'s
    streams, so no epoch key equals a named stream's seed."""
    return [_derive_seed(key, f"epoch/{i}") for i in range(num_epochs)]


def key_stream(key: int) -> Iterator[int]:
    """An endless stream of fresh derived int keys (JAX's split chain),
    tagged apart from `split_named`'s and `epoch_keys`'."""
    for i in itertools.count():
        yield _derive_seed(key, f"stream/{i}")
