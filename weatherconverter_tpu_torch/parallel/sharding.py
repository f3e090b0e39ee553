"""Data parallelism over the processes of a run (port of
weatherconverter_tpu/parallel/sharding.py).

JAX lays a step out over a ('data',) mesh and XLA inserts the collectives:
the step computes what one device would compute at the GLOBAL batch. The
port keeps that meaning with one process per card, each holding its rows of
the global batch, and explicit collectives in the train steps:

  - `make_mesh` is a torch DeviceMesh named ("data",) over the world;
  - `shard_batch` / `local_rows`: rank r's rows of a global batch of B,
    laid out so that its microbatch i (of `accum_steps`) holds its share of
    the global microbatch i, the global rows [i * B/A + r * B/(A W), ...):
    JAX cuts microbatches from the global batch, so a contiguous block a
    rank would give microbatches of other rows;
  - `replicate`: parameters and buffers broadcast from rank 0;
  - `sync_grads`: the SUM over ranks of each gradient (each rank's loss is
    its share of the global mean, so the sum is the global gradient);
  - `global_draws`: the generator a rank's augmentation draws from
    (GlobalDraws): each draw is made at the global batch's shape and this
    rank's rows kept, so its draws are its rows of the global batch's
    draws; the augmentation itself runs on the rank's rows alone;
  - `loader`: data.loader.DataLoader in JAX's index order, each rank
    decoding its rows of every global batch.

The device count is the world size. Without a mesh every function is the
single-process path.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from weatherconverter_tpu_torch.parallel.distributed import process_count

DATA_AXIS = "data"


def make_mesh(data: Optional[int] = None, device_type: Optional[str] = None):
    """The ("data",) DeviceMesh over every process of the run (the process
    group must be up: `maybe_initialize_distributed`). `device_type` is where
    the tensors live ("cuda" under NCCL, "cpu" under gloo by default)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized; run under torchrun "
                           "(cli.main calls maybe_initialize_distributed) or init_process_group first")
    world = dist.get_world_size()
    if data is not None and data != world:
        raise ValueError(f"mesh width {data} != {world} processes: the port runs one process per data rank")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(DATA_AXIS,))


def data_sharding(mesh, ndim: int) -> tuple:
    """The DTensor placements of a batch split on its leading dim over the mesh
    (JAX's NamedSharding(mesh, P("data", None, ...)); `ndim` is not needed)."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated(mesh) -> tuple:
    """The DTensor placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def check_mesh(mesh, where: str) -> None:
    """Refuse, by name, a `mesh=` that is not a ("data",) DeviceMesh."""
    if mesh is None:
        return
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != (DATA_AXIS,):
        raise ValueError(f"{where}: mesh must be a torch DeviceMesh named ({DATA_AXIS!r},) from "
                         f"parallel.make_mesh, got {mesh!r}")


def host_group(mesh):
    """A gloo group over the mesh's ranks, for agreements on the host (the
    preemption flag): the mesh's own group under gloo, a new one under NCCL,
    whose collectives would put the flag on the card and make the host wait
    for the step's device work to read it. None without a mesh. Every rank
    of the mesh calls it, in the same order."""
    if mesh is None:
        return None
    group = mesh.get_group()
    if dist.get_backend(group) == "gloo":
        return group
    return dist.new_group(dist.get_process_group_ranks(group), backend="gloo")


def mesh_width(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def mesh_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank()


def data_group(mesh):
    return None if mesh is None else mesh.get_group()


def local_rows(global_batch: int, mesh, accum_steps: int = 1) -> list[int]:
    """This rank's rows of a global batch, in its local order: microbatch i
    of `accum_steps` holds the rank's share of the global microbatch i."""
    return _rows_of(np.arange(global_batch), mesh_width(mesh), mesh_rank(mesh), accum_steps).tolist()


def _map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple (transforms.SegDraws)
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rows_of(x, width: int, rank: int, accum_steps: int):
    """Rank `rank`'s rows (`local_rows`) of an array whose leading dim is the
    global batch: of each of the `accum_steps` microbatches, its share."""
    if x.shape[0] % (width * accum_steps):
        raise ValueError(f"global batch {x.shape[0]} is not divisible by {width} ranks x {accum_steps} "
                         "microbatches")
    rest = tuple(x.shape[1:])
    return x.reshape((accum_steps, width, -1) + rest)[:, rank].reshape((-1,) + rest)


def shard_batch(mesh, batch, accum_steps: int = 1):
    """This rank's rows (`local_rows`) of every array leaf of a global batch
    (tensors or numpy arrays, leading dim the batch); other leaves (None)
    as they are."""
    if mesh is None:
        return batch
    width, rank = mesh_width(mesh), mesh_rank(mesh)
    return _map(lambda x: _rows_of(x, width, rank, accum_steps) if isinstance(x, (torch.Tensor, np.ndarray))
                else x, batch)


class GlobalDraws:
    """What a rank's augmentation draws from in place of `generator`: each
    draw is made at the global batch's shape (the rank's shape with its
    leading dim times the width) and this rank's rows (`local_rows`) kept.
    The draws are then its rows of the global batch's draws, whatever the
    rank; the augmentation runs on its rows alone, and only the draws are
    made for every row. data/transforms draws through `draw`."""

    def __init__(self, generator: Optional[torch.Generator], mesh, accum_steps: int = 1):
        self.generator, self.accum_steps = generator, accum_steps
        self.width, self.rank = mesh_width(mesh), mesh_rank(mesh)

    def draw(self, fn, shape, device, **kw) -> torch.Tensor:
        """fn(global shape, generator=, device=, **kw), this rank's rows."""
        full = fn((shape[0] * self.width,) + tuple(shape[1:]), generator=self.generator, device=device, **kw)
        return _rows_of(full, self.width, self.rank, self.accum_steps)


def global_draws(mesh, accum_steps: int, generator: Optional[torch.Generator]):
    """The generator a rank's augmentation takes: `generator` itself without
    a mesh, else a GlobalDraws over it."""
    return generator if mesh is None else GlobalDraws(generator, mesh, accum_steps)


def replicate(mesh, tree):
    """Modules' parameters and buffers, and tensors, broadcast in place from
    rank 0 of the mesh; returns `tree`."""
    if mesh is None:
        return tree
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)

    def bcast(x):
        if isinstance(x, torch.nn.Module):
            with torch.no_grad():
                for t in list(x.parameters()) + list(x.buffers()):
                    dist.broadcast(t.data, src, group=group)
        elif isinstance(x, torch.Tensor):
            dist.broadcast(x.data, src, group=group)
        return x

    return _map(bcast, tree)


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` summed over the mesh's ranks, in place (no-op without a mesh)."""
    if mesh is not None:
        dist.all_reduce(t, group=mesh.get_group())
    return t


def sync_grads(params, mesh) -> None:
    """Each gradient summed over the ranks, in one collective per dtype.
    Gradients FSDP already reduced (DTensors) are left to it."""
    if mesh is None:
        return
    from torch.distributed.tensor import DTensor

    grads = [p.grad for p in params if p.grad is not None and not isinstance(p.grad, DTensor)]
    for dtype in dict.fromkeys(g.dtype for g in grads):  # one order on every rank
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=mesh.get_group())
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def pad_to_multiple(batch, multiple: int):
    """The leading dim of every leaf padded to a multiple by repeating its
    last row (numpy arrays or tensors)."""

    def pad(x):
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        if isinstance(x, np.ndarray):
            return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1), mode="edge")
        return torch.cat([x, x[-1:].expand((rem,) + tuple(x.shape[1:]))])

    return _map(pad, batch)


@contextmanager
def maybe_mesh(mesh):
    """JAX enters the mesh's context; a DeviceMesh needs none. Kept so that
    callers read alike."""
    yield mesh


def plan_data_parallel(per_device_batch: int, scale_to_mesh: bool = True,
                       n_devices: Optional[int] = None) -> tuple[int, int]:
    """(dp_width, global_batch): with `scale_to_mesh` the global batch is the
    per-device batch times every process; else the batch is global and dp
    its largest divisor <= the process count."""
    n = n_devices if n_devices is not None else process_count()
    if scale_to_mesh and n > 1:
        return n, per_device_batch * n
    return choose_dp_width(per_device_batch, n), per_device_batch


def choose_dp_width(batch_size: int, n_devices: Optional[int] = None) -> int:
    """Largest divisor of `batch_size` that is <= the process count."""
    n = n_devices if n_devices is not None else process_count()
    for w in range(min(batch_size, n), 0, -1):
        if batch_size % w == 0:
            return w
    return 1


def local_batch_slice(global_batch: int, mesh) -> int:
    """Rows a rank holds of a global batch."""
    n = mesh_width(mesh)
    if global_batch % n:
        raise ValueError(f"batch {global_batch} % data axis {n} != 0")
    return global_batch // n


def loader(ds, global_batch: int, mesh, *, shuffle: bool, seed: int = 0, drop_last: bool = True,
           accum_steps: int = 1, pad_ragged: bool = False, num_workers: int = 8, pin_memory: bool = False):
    """data.loader.DataLoader over this rank's rows (`local_rows`) of each
    global batch: JAX's index order, shared by every rank, of which each
    decodes its rows. `num_workers` 0 means the default 8 decode threads,
    as in the JAX loops."""
    from weatherconverter_tpu_torch.data.loader import DataLoader

    return DataLoader(ds, global_batch, shuffle=shuffle, seed=seed, num_workers=num_workers or 8,
                      drop_last=drop_last, rows=local_rows(global_batch, mesh, accum_steps), pad_ragged=pad_ragged,
                      pin_memory=pin_memory)
