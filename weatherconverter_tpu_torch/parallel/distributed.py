"""Multi-process runs: one process per GPU over torch.distributed (port of
weatherconverter_tpu/parallel/distributed.py).

JAX initializes its distributed runtime once per host and then sees every
device of every host in one program. Here `torchrun --nproc-per-node N`
starts one process per card and sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT; `maybe_initialize_distributed` reads them and
joins the process group: NCCL on the cards (after binding the process to
card LOCAL_RANK), gloo when the run is asked for the CPU. Without those
variables it does nothing, so every entry point calls it unconditionally. A
failed initialization raises: no run drops to one rank.

Where the JAX code reads a global array back, each rank here holds its rows
of the batch and `global_batch_from_local` gathers them.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(device: str = "cuda") -> bool:
    """Join torchrun's process group when its variables are set; True when a
    group is up (also when it already was). `device` is where the run
    computes: "cuda" takes NCCL, with this process bound to card LOCAL_RANK;
    "cpu" takes gloo. Raises on a partial environment, a CUDA run without a
    card, or a failed initialization."""
    if dist.is_initialized():
        return True
    present = [v for v in TORCHRUN_ENV if v in os.environ]
    if not present:
        return False
    if len(present) != len(TORCHRUN_ENV):
        raise RuntimeError(f"torch.distributed: {sorted(set(TORCHRUN_ENV) - set(present))} unset while {present} "
                           "are set; start the run with torchrun")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("torch.distributed: a CUDA run needs a card and found none; pass --device cpu")
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return True


def process_count() -> int:
    """Processes in the run: the world size, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Only the primary process writes run directories, logs and checkpoints."""
    return process_index() == 0


def comm_device(group=None) -> torch.device:
    """Where a small tensor for a collective of `group` lives: the CPU under
    gloo, this process's card under NCCL."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_object(obj, group=None):
    """`obj` as rank 0 of `group` has it, on every rank (no-op without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0) if group is not None else 0, group=group,
                               device=comm_device(group))
    return box[0]


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def global_batch_from_local(mesh, local: torch.Tensor) -> torch.Tensor:
    """The global batch whose rows [r * b, (r + 1) * b) are rank r's `local`
    (b rows on every rank), on every rank: the counterpart of JAX's global
    array made from per-process shards, read back where the JAX code reads
    it. Without a mesh, `local` itself."""
    if mesh is None:
        return local
    group = mesh.get_group()
    dev = comm_device(group)
    parts = [torch.empty_like(local, device=dev) for _ in range(mesh.size())]
    dist.all_gather(parts, local.contiguous().to(dev), group=group)
    return torch.cat(parts).to(local.device)
