"""FSDP / ZeRO-3 sharding of the train state over the ("data",) mesh (port of
weatherconverter_tpu/parallel/fsdp.py).

JAX device-puts each large leaf of the state (parameters, Adam's moments,
the EMA shadow) sharded on one axis and lets XLA all-gather at use and
reduce-scatter the gradients. Here FSDP2's `fully_shard` does that for the
model's parameters, on the axis `fsdp_spec` picks (JAX's rule: the largest
axis that divides the width; a leaf under 16 KiB, or with no divisible
axis, replicated), through `shard_placement_fn`. Replicated leaves stay out
of FSDP (`ignored_params`) and the train steps all-reduce their gradients
(parallel.sharding.sync_grads). FSDP reduces the sharded gradients as a SUM
(divide factor 1), the port's rule for every data-parallel gradient: each
rank's loss is its share of the global mean. The optimizer is rebuilt over
the sharded parameters with its moments cut the same way, and the EMA
shadow likewise (`_rebuild_optimizer`). The model is wrapped at its root: the whole model is
gathered for its forward and backward, and only the persistent state is
sharded.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from weatherconverter_tpu_torch.parallel.sharding import DATA_AXIS, replicate

MIN_SHARD_BYTES = 1 << 14


def fsdp_spec(shape: tuple[int, ...], data_width: int, *, itemsize: int = 4,
              min_shard_bytes: int = MIN_SHARD_BYTES) -> tuple:
    """JAX's PartitionSpec as a tuple: DATA_AXIS at the largest axis that
    divides `data_width` (ties to the leading one), None elsewhere; () to
    replicate (a leaf under `min_shard_bytes`, or no divisible axis)."""
    numel = 1
    for s in shape:
        numel *= s
    if not shape or numel * itemsize < min_shard_bytes:
        return ()
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[ax] % data_width == 0 and shape[ax] >= data_width:
            return tuple(DATA_AXIS if i == ax else None for i in range(len(shape)))
    return ()


def _sharded_axis(spec: tuple) -> Optional[int]:
    return spec.index(DATA_AXIS) if DATA_AXIS in spec else None


def fsdp_shardings(mesh, module: nn.Module, **kw) -> dict[str, tuple]:
    """{parameter name: fsdp_spec} of a module's parameters at the mesh's width."""
    width = mesh.size()
    return {n: fsdp_spec(tuple(p.shape), width, itemsize=p.element_size(), **kw)
            for n, p in module.named_parameters()}


def _shard_like(value: torch.Tensor, param) -> torch.Tensor:
    """`value` (the full tensor of `param`'s shape, equal on every rank) cut
    into this rank's shard as `param` is, as a DTensor."""
    from torch.distributed.tensor import DTensor, Shard

    (placement,) = param.placements
    assert isinstance(placement, Shard)
    mesh = param.device_mesh
    local = value.chunk(mesh.size(), dim=placement.dim)[mesh.get_local_rank()]
    return DTensor.from_local(local.contiguous(), mesh, param.placements, run_check=False)


def _shard_model(mesh, model: nn.Module, **kw) -> dict[str, nn.Parameter]:
    """fully_shard `model` at its root by the fsdp_spec rule; returns the
    parameters before, by name."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    before = dict(model.named_parameters())
    specs = fsdp_shardings(mesh, model, **kw)
    by_param = {id(p): _sharded_axis(specs[n]) for n, p in before.items()}
    replicated = {p for n, p in before.items() if by_param[id(p)] is None}
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: Shard(by_param[id(p)]),
                ignored_params=replicated)
    model.set_gradient_divide_factor(1.0)  # a sum, not a mean (module docstring)
    if hasattr(model, "set_force_sum_reduction_for_comms"):  # gloo has no pre-multiplied sum
        model.set_force_sum_reduction_for_comms(True)
    return before


def _rebuild_optimizer(opt: torch.optim.Optimizer, before: dict[str, nn.Parameter],
                       after: dict[str, nn.Parameter]) -> torch.optim.Optimizer:
    """The same optimizer over the sharded parameters, its per-parameter
    state (moments) cut as each parameter is. A foreach kernel takes
    DTensors or plain tensors, not both in one list, so each group becomes
    two with its hyperparameters, its sharded parameters and its replicated
    ones, each marked with the group's index (`origin`); the optimizer keeps
    its foreach kernels. Its state dict is written in the groups as they
    were, so a checkpoint holds the unsharded optimizer's layout; loading
    one into it is refused (restore into the unsharded state, then shard)."""
    from torch.distributed.tensor import DTensor

    name_of = {id(p): n for n, p in before.items()}
    layout = [[after[name_of[id(p)]] for p in g["params"]] for g in opt.param_groups]
    groups = []
    for i, (g, params) in enumerate(zip(opt.param_groups, layout)):
        hyper = {k: v for k, v in g.items() if k != "params"}
        for sharded in (True, False):
            part = [p for p in params if isinstance(p, DTensor) == sharded]
            if part:
                groups.append({**hyper, "params": part, "origin": i})
    new = type(opt)(groups)
    for old_p, state in opt.state.items():
        p = after[name_of[id(old_p)]]
        new.state[p] = {k: _shard_like(v, p) if isinstance(p, DTensor) and torch.is_tensor(v)
                        and v.shape == old_p.shape else v for k, v in state.items()}

    def unsplit(optimizer, sd):
        index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
        old_index = {index[id(p)]: k for k, p in enumerate(p for params in layout for p in params)}
        merged, start = [], 0
        for i, params in enumerate(layout):
            first = next(g for g in sd["param_groups"] if g["origin"] == i)
            merged.append({**{k: v for k, v in first.items() if k not in ("params", "origin")},
                           "params": list(range(start, start + len(params)))})
            start += len(params)
        return {"state": {old_index[i]: v for i, v in sd["state"].items()}, "param_groups": merged}

    def refuse(optimizer, sd):
        raise RuntimeError("an FSDP-sharded optimizer takes no state dict: restore into the unsharded state, "
                           "then shard it (parallel.fsdp.maybe_shard_state)")

    new.register_state_dict_post_hook(unsplit)
    new.register_load_state_dict_pre_hook(refuse)
    return new


def _modules_of(state) -> list:
    """The (holder, model, optimizer, ema) of a train state: one for the
    DDPM and seg states, two (G, D) for SRGANStates."""
    if hasattr(state, "gen") and hasattr(state, "disc"):
        return [(s, s.model, s.optimizer, None) for s in (state.gen, state.disc)]
    return [(state, state.model, state.optimizer, getattr(state, "ema", None))]


def shard_state_fsdp(mesh, state, **kw):
    """FSDP-shard a train state in place (parameters, the optimizer's
    moments, the EMA shadow) and return it. Call it on an unsharded state,
    after any restore."""
    for holder, model, opt, ema in _modules_of(state):
        before = _shard_model(mesh, model, **kw)
        after = dict(model.named_parameters())
        holder.optimizer = _rebuild_optimizer(opt, before, after)
        if ema is not None:
            from torch.distributed.tensor import DTensor

            ema.params = {n: _shard_like(e, after[n]) if isinstance(after[n], DTensor) else e
                          for n, e in ema.params.items()}
    return state


def _state_tensors(state) -> list[torch.Tensor]:
    out = []
    for _, model, opt, ema in _modules_of(state):
        out += list(model.parameters()) + list(model.buffers())
        out += [v for s in opt.state.values() for v in s.values() if torch.is_tensor(v)]
        if ema is not None:
            out += list(ema.params.values())
    return out


def sharded_fraction(state) -> float:
    """Share of the state's bytes (parameters, buffers, optimizer state, EMA)
    that are sharded across the mesh; 0-d counters (Adam's step, one a
    parameter here, one for the state in optax) are left out on both sides
    of the ratio."""
    from torch.distributed.tensor import DTensor, Shard

    total = sharded = 0
    for t in _state_tensors(state):
        if t.dim() == 0:
            continue
        nbytes = t.numel() * t.element_size()
        total += nbytes
        if isinstance(t, DTensor) and any(isinstance(p, Shard) for p in t.placements):
            sharded += nbytes
    return sharded / total if total else 0.0


def assert_memory_sharded(state, min_fraction: float = 0.9) -> None:
    """Raise unless at least `min_fraction` of the state's bytes are sharded."""
    frac = sharded_fraction(state)
    if frac < min_fraction:
        raise AssertionError(f"only {frac:.1%} of state bytes are sharded (< {min_fraction:.0%})")


def maybe_shard_state(mesh, state: Any, fsdp: bool = False, **kw) -> Any:
    """The loops' one call: FSDP-shard when asked, else replicate from rank 0
    (plain data parallelism); without a mesh, the state as it is."""
    if mesh is None:
        return state
    if fsdp:
        return shard_state_fsdp(mesh, state, **kw)
    for _, model, _, ema in _modules_of(state):
        replicate(mesh, model)
        if ema is not None:
            replicate(mesh, list(ema.params.values()))
    return state


def _gather_full(t) -> torch.Tensor:
    """The full tensor of a DTensor sharded as `_shard_like` cuts it: an
    all-gather of the equal shards through c10d (DTensor.full_tensor's
    functional collectives crashed over gloo on CUDA tensors, torch 2.11),
    on the CPU under gloo."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from weatherconverter_tpu_torch.parallel.distributed import comm_device

    (placement,) = t.placements
    local = t.to_local()
    if not isinstance(placement, Shard):
        return local
    group = t.device_mesh.get_group()
    dev = comm_device(group)
    parts = [torch.empty_like(local, device=dev) for _ in range(t.device_mesh.size())]
    dist.all_gather(parts, local.contiguous().to(dev), group=group)
    return torch.cat(parts, dim=placement.dim).to(local.device)


def full_state(tree):
    """A state_dict tree with every DTensor gathered into its full tensor (a
    collective: every rank calls it), so a checkpoint written under FSDP
    loads into an unsharded state."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return _gather_full(tree)
    if isinstance(tree, dict):
        return {k: full_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_state(v) for v in tree)
    return tree
