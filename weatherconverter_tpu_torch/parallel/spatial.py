"""Spatial parallelism: the high-resolution half of a guided step sharded
along image height (port of weatherconverter_tpu/parallel/spatial.py).

JAX lays the SRGAN output and the seg model's forward and input gradient
over a ('data', 'space') mesh and XLA's SPMD partitioner inserts the halo
exchanges and the cross-shard reductions. Torch has no partitioner, so here
each rank holds its own H rows of every map (an even split: rank r of
`space` holds global rows [r * h, (r + 1) * h)) and `SpatialContext`, a
TorchFunctionMode, makes the seg model's spatial operators exchange what
they need:

  - convolution (F.conv2d: any kernel, stride, dilation, groups) and
    max-pool (F.max_pool2d): each rank fetches the input rows its output
    rows' windows read from the ranks that hold them, and fills rows past
    the image's top and bottom edges with 0 (the conv's H padding) or -inf
    (the pool's); the op then runs with no H padding. The rows a rank needs
    are planned from every rank's windows, so a halo may span several
    ranks and the region past the edge (ASPP's dilation 18 at OS16);
  - `ops.image.resize_bilinear` (align_corners=False): computed in global
    coordinates, with the low-resolution rows it reads fetched as above;
  - `ops.image.global_avg_pool`: the local sums all-reduced over 'space'
    and divided by the global H * W;
  - `ops.image.avg_pool` and `ops.image.resize_nearest`: local, where the
    shard boundaries line up with the factor (else refused);
  - every other op runs as it is: pointwise ops, channel concatenations,
    eval-mode BatchNorm and per-pixel losses are local.

Spatial ops the context does not cover are refused by name (F.interpolate
called directly, F.pad over H, adaptive pools, pixel shuffles, transposed
convs, ...), and so is any op whose global output height does not split
evenly over 'space'. The exchanges are built from all-gathers and
all-reduces (collectives gloo runs on card tensors), and each is
differentiable: a fetched row's gradient goes back to the rank that owns
it and is added there.

When to use: guidance at resolutions whose HR activations crowd one card.
At the 256 px shape one card is compute-bound and spatial sharding only
adds exchanges: data parallelism over images stays the throughput layout.

Axis convention: ('data', 'space'): batch over 'data', image H over 'space'.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from weatherconverter_tpu_torch.ops import image as image_ops
from weatherconverter_tpu_torch.parallel.sharding import DATA_AXIS, _map, _rows_of

SPACE_AXIS = "space"

# spatial ops the context does not cover, refused by name under it
_REFUSED = {
    F.interpolate: "F.interpolate (use ops.image.resize_bilinear / resize_nearest)",
    F.avg_pool2d: "F.avg_pool2d (use ops.image.avg_pool)",
    F.adaptive_avg_pool2d: "F.adaptive_avg_pool2d (use ops.image.global_avg_pool)",
    F.adaptive_max_pool2d: "F.adaptive_max_pool2d",
    F.max_pool2d_with_indices: "F.max_pool2d with return_indices",
    F.conv_transpose2d: "F.conv_transpose2d",
    F.pixel_shuffle: "F.pixel_shuffle",
    F.pixel_unshuffle: "F.pixel_unshuffle",
    F.unfold: "F.unfold",
    F.fold: "F.fold",
    F.grid_sample: "F.grid_sample",
}

_ACTIVE = threading.local()


def make_spatial_mesh(data: int = 1, space: Optional[int] = None):
    """The ('data', 'space') DeviceMesh over the torch.distributed world:
    `data * space` must be the world size; `space` defaults to what `data`
    leaves. The mesh's device type follows the backend: cuda over NCCL,
    cpu over gloo (whose collectives also take card tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_spatial_mesh: torch.distributed is not initialized; run under torchrun or "
                           "init_process_group first")
    n = dist.get_world_size()
    if space is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        space = n // data
    if data * space != n:
        raise ValueError(f"data*space {data * space} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, space), mesh_dim_names=(DATA_AXIS, SPACE_AXIS))


def check_spatial_mesh(mesh, where: str) -> None:
    """Refuse, by name, a mesh that is not make_spatial_mesh's."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != (DATA_AXIS, SPACE_AXIS):
        raise ValueError(f"{where}: spatial_mesh must be a torch DeviceMesh named ({DATA_AXIS!r}, {SPACE_AXIS!r}) "
                         f"from parallel.spatial.make_spatial_mesh, got {mesh!r}")


def axis_width(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def spatial_image_sharding(mesh, batch_sharded: bool = True) -> tuple:
    """The DTensor placements of an NHWC image laid out spatially: H over
    'space', and the batch over 'data' when that axis is wider than 1."""
    from torch.distributed.tensor import Replicate, Shard

    batch = Shard(0) if batch_sharded and axis_width(mesh, DATA_AXIS) > 1 else Replicate()
    return (batch, Shard(1))


def _own(x, mesh, batch_sharded: bool, dim: int):
    """This rank's rows of `x` along `dim` (its 'space' shard), and of the
    batch (its 'data' shard) when `batch_sharded` and 'data' is wider than 1."""
    width, rank = axis_width(mesh, SPACE_AXIS), axis_rank(mesh, SPACE_AXIS)
    if x.shape[dim] % width:
        raise ValueError(f"height {x.shape[dim]} does not split over space={width}")
    h = x.shape[dim] // width
    x = x.narrow(dim, rank * h, h)
    if batch_sharded and axis_width(mesh, DATA_AXIS) > 1:
        x = _rows_of(x, axis_width(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS), 1)
    return x


def shard_spatial(mesh, x, batch_sharded: bool = True):
    """This rank's part of an NHWC tensor (or a tree of them; (B, H, W)
    labels too): its H rows over 'space', and its batch rows over 'data'
    when that axis is wider than 1."""
    return _map(lambda a: _own(a, mesh, batch_sharded, 1) if isinstance(a, (torch.Tensor, np.ndarray)) else a, x)


def constrain_spatial(x, mesh, batch_sharded: bool = True):
    """An intermediate NHWC tensor in the spatial layout (`shard_spatial`);
    `x` itself without a mesh."""
    if mesh is None:
        return x
    return shard_spatial(mesh, x, batch_sharded)


def data_rows(mesh, batch: int) -> slice:
    """This rank's rows of a batch over the mesh's 'data' axis."""
    width = axis_width(mesh, DATA_AXIS)
    if batch % width:
        raise ValueError(f"batch {batch} does not split over data={width}")
    b = batch // width
    return slice(None) if width == 1 else slice(axis_rank(mesh, DATA_AXIS) * b, (axis_rank(mesh, DATA_AXIS) + 1) * b)


def current() -> Optional["SpatialContext"]:
    """The SpatialContext active on this thread, or None."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def _all_gather(x: torch.Tensor, group, width: int) -> list[torch.Tensor]:
    """Every rank's `x` of the group, in rank order: the halo exchange's one
    collective (a seam the planted-fault tests replace)."""
    out = [torch.empty_like(x) for _ in range(width)]
    dist.all_gather(out, x, group=group)
    return out


class _Rows(torch.autograd.Function):
    """The rows [a, b) of a map split over 'space' (global row indices,
    filled with `fill` outside [0, H)), from `_RowPlan`. The backward sends
    the gradient of each fetched row back to its owner."""

    @staticmethod
    def forward(ctx, x, plan, fill):
        ctx.plan = plan
        return plan.forward(x, fill)

    @staticmethod
    def backward(ctx, grad):
        return ctx.plan.backward(grad), None, None


class _RowPlan:
    """Which rows each rank of a `space` group of width S fetches, for the
    windows [(a_q, b_q)] every rank q needs. Rank o sends one payload to all:
    the top `top` and bottom `bottom` rows of its shard of h rows that some
    other rank reads (the whole shard when they overlap), all-gathered."""

    def __init__(self, group, width: int, rank: int, h: int, windows: list[tuple[int, int]]):
        self.group, self.width, self.rank, self.h = group, width, rank, h
        self.a, self.b = windows[rank]
        top = bottom = 0
        for q, (a, b) in enumerate(windows):
            for o in range(width):
                lo, hi = max(a, o * h) - o * h, min(b, (o + 1) * h) - o * h
                if o == q or lo >= hi:
                    continue
                if q < o and lo == 0:
                    top = max(top, hi)
                elif q > o and hi == h:
                    bottom = max(bottom, h - lo)
                else:  # an interior run of rows: send the whole shard
                    top = h
        self.whole = top + bottom >= h
        self.top, self.bottom = (h, 0) if self.whole else (top, bottom)
        self.exchange = top + bottom > 0

    def _payload_row(self, j: int) -> int:
        """Where an owner's row j sits in its payload."""
        return j if j < self.top else self.top + j - (self.h - self.bottom)

    def _pieces(self):
        """(global start, stop, owner) runs of [a, b), owner None past the edges."""
        h, total = self.h, self.h * self.width
        runs, g = [], self.a
        while g < self.b:
            if g < 0:
                stop, owner = min(self.b, 0), None
            elif g >= total:
                stop, owner = self.b, None
            else:
                owner = g // h
                stop = min(self.b, (owner + 1) * h)
            runs.append((g, stop, owner))
            g = stop
        return runs

    def _payload(self, x):
        if self.whole:
            return x
        return torch.cat([x[:, :, :self.top], x[:, :, self.h - self.bottom:]], dim=2)

    def forward(self, x, fill):
        gathered = None
        if self.exchange:
            payload = self._payload(x)
            wire = payload.float() if payload.dtype == torch.bfloat16 else payload
            gathered = [g.to(x.dtype) for g in _all_gather(wire.contiguous(), self.group, self.width)]
        parts = []
        for start, stop, owner in self._pieces():
            n = stop - start
            if owner is None:
                parts.append(x.new_full((x.shape[0], x.shape[1], n, x.shape[3]), fill))
            elif owner == self.rank:
                parts.append(x[:, :, start - owner * self.h:stop - owner * self.h])
            else:
                j = self._payload_row(start - owner * self.h)
                parts.append(gathered[owner][:, :, j:j + n])
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)

    def backward(self, grad):
        b, c, _, w = grad.shape
        gx = grad.new_zeros((b, c, self.h, w))
        sent = None
        if self.exchange:
            rows = self.h if self.whole else self.top + self.bottom
            sent = torch.zeros((self.width, b, c, rows, w), dtype=torch.promote_types(grad.dtype, torch.float32),
                               device=grad.device)
        for start, stop, owner in self._pieces():
            piece = grad[:, :, start - self.a:stop - self.a]
            if owner == self.rank:
                gx[:, :, start - owner * self.h:stop - owner * self.h] += piece
            elif owner is not None:
                j = self._payload_row(start - owner * self.h)
                sent[owner, :, :, j:j + stop - start] += piece
        if sent is not None:
            dist.all_reduce(sent, group=self.group)
            mine = sent[self.rank].to(grad.dtype)
            if self.whole:
                gx += mine
            else:
                gx[:, :, :self.top] += mine[:, :, :self.top]
                gx[:, :, self.h - self.bottom:] += mine[:, :, self.top:]
        return gx


class _AllReduceSum(torch.autograd.Function):
    """A sum over 'space' whose result each rank uses on its own rows (ASPP's
    pooled features): forward and backward an all-reduce, as
    models/norm.synced_batchnorm's statistics."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _ReplicatedSum(torch.autograd.Function):
    """A sum over 'space' whose result every rank then uses alike (the
    per-image CE that each rank differentiates whole): forward an
    all-reduce, backward the gradient as it is (each rank's share enters
    the sum once)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _pair(v) -> tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


class SpatialContext(TorchFunctionMode):
    """Under `with SpatialContext(mesh):` the seg model's spatial operators
    run on maps split along H over the mesh's 'space' axis (see the module
    docstring). Every rank of a 'space' group runs the same code on its own
    rows."""

    def __init__(self, mesh):
        super().__init__()
        check_spatial_mesh(mesh, "SpatialContext")
        self.mesh = mesh
        self.group = mesh.get_group(SPACE_AXIS)
        self.width, self.rank = axis_width(mesh, SPACE_AXIS), axis_rank(mesh, SPACE_AXIS)

    def __enter__(self):
        super().__enter__()
        if not hasattr(_ACTIVE, "stack"):
            _ACTIVE.stack = []
        _ACTIVE.stack.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.stack.pop()
        return super().__exit__(*exc)

    # -- layout -------------------------------------------------------------

    def global_rows(self, h: int) -> int:
        return h * self.width

    def local_rows(self, h: int) -> int:
        if h % self.width:
            raise ValueError(f"height {h} does not split over space={self.width}")
        return h // self.width

    def own_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a replicated tensor along `dim`."""
        h = self.local_rows(x.shape[dim])
        return x.narrow(dim, self.rank * h, h)

    def gather_rows(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """Every rank's rows of `x` along `dim`, in order (no gradient)."""
        parts = [torch.empty_like(x) for _ in range(self.width)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def gather_data_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every 'data' rank's batch rows of `x`, in order (no gradient)."""
        if axis_width(self.mesh, DATA_AXIS) == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(axis_width(self.mesh, DATA_AXIS))]
        dist.all_gather(parts, x.contiguous(), group=self.mesh.get_group(DATA_AXIS))
        return torch.cat(parts)

    def check_guidance(self, hr: int, pool: int) -> None:
        """Refuse, by name and before anything runs, an HR height the guided
        step cannot split: each rank's rows must pool to whole latent rows.
        Each seg map's height is checked by its op as it runs (the HR height
        must be a multiple of space x the model's total stride x the pool
        factor)."""
        if pool < 1 or hr % (self.width * pool):
            raise ValueError(f"spatial_mesh: HR height {hr} is not divisible by space={self.width} x the pool factor "
                             f"{pool}; it must be a multiple of space x the seg model's total stride x the pool factor")

    def sum_over_space(self, x: torch.Tensor, differentiable: bool) -> torch.Tensor:
        """`x` summed over the 'space' ranks; `differentiable`: as a value
        every rank then uses alike (`_ReplicatedSum`)."""
        if differentiable:
            return _ReplicatedSum.apply(x, self.group)
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def _refuse(self, what: str, why: str):
        raise NotImplementedError(f"spatial context (space={self.width}): {what} {why}")

    def _out_rows(self, op: str, h_in: int, kernel: int, stride: int, padding: int, dilation: int) -> int:
        total = (self.global_rows(h_in) + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
        if total % self.width:
            self._refuse(op, f"gives a map of height {total}, which does not split over space={self.width}: the HR "
                             "height must be a multiple of space x the model's total stride x the pool factor")
        return total // self.width

    def rows(self, x: torch.Tensor, windows: list[tuple[int, int]], fill: float) -> torch.Tensor:
        """Rows windows[rank] (global indices) of the split map `x`, fetched
        from their owners, `fill` past the edges."""
        plan = _RowPlan(self.group, self.width, self.rank, x.shape[2], windows)
        if not plan.exchange and plan.a >= 0 and plan.b <= self.global_rows(x.shape[2]):
            return x[:, :, plan.a - self.rank * x.shape[2]:plan.b - self.rank * x.shape[2]]
        return _Rows.apply(x, plan, fill)

    def _windowed(self, op: str, x, kernel: int, stride: int, padding: int, dilation: int, fill: float):
        """The input rows of a sliding-window op, this rank's output rows' windows."""
        ho = self._out_rows(op, x.shape[2], kernel, stride, padding, dilation)
        extent = dilation * (kernel - 1) + 1
        windows = [(q * ho * stride - padding, (q * ho + ho - 1) * stride - padding + extent)
                   for q in range(self.width)]
        return self.rows(x, windows, fill)

    # -- the covered ops ------------------------------------------------------

    def conv2d(self, x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        if isinstance(padding, str):
            if padding != "valid":
                self._refuse("F.conv2d", f"with padding={padding!r}")
            padding = 0
        (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
        slab = self._windowed("F.conv2d", x, weight.shape[2], sh, ph, dh, 0.0)
        return F.conv2d(slab, weight, bias, (sh, sw), (0, pw), (dh, dw), groups)

    def max_pool2d(self, x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                   return_indices=False):
        if ceil_mode or return_indices:
            self._refuse("F.max_pool2d", "with ceil_mode or return_indices")
        (kh, kw), (ph, pw), (dh, dw) = _pair(kernel_size), _pair(padding), _pair(dilation)
        sh, sw = _pair(kernel_size if stride is None or stride == [] else stride)
        slab = self._windowed("F.max_pool2d", x, kh, sh, ph, dh, float("-inf"))
        return F.max_pool2d(slab, (kh, kw), (sh, sw), (0, pw), (dh, dw))

    def resize_bilinear(self, x, size):
        """Bilinear (align_corners=False) in global coordinates: W first on
        the fetched rows, then H with ATen's source indices and weights."""
        ho, wo = int(size[0]), int(size[1])
        h_in, h_out = self.global_rows(x.shape[2]), self.global_rows(ho)
        scale = np.float32(h_in) / np.float32(h_out)
        dst = np.arange(self.rank * ho, (self.rank + 1) * ho, dtype=np.float32)
        src = np.maximum(scale * (dst + np.float32(0.5)) - np.float32(0.5), np.float32(0))
        i0 = np.minimum(np.floor(src).astype(np.int64), h_in - 1)
        i1 = i0 + (i0 < h_in - 1)
        lam1 = np.clip(src - i0.astype(np.float32), 0, 1).astype(np.float32)
        windows = []
        for q in range(self.width):
            qd = np.arange(q * ho, (q + 1) * ho, dtype=np.float32)
            qs = np.maximum(scale * (qd + np.float32(0.5)) - np.float32(0.5), np.float32(0))
            q0 = np.minimum(np.floor(qs).astype(np.int64), h_in - 1)
            windows.append((int(q0[0]), int(np.minimum(q0[-1] + 1, h_in - 1)) + 1))
        slab = self.rows(x, windows, 0.0)
        a = windows[self.rank][0]
        wide = F.interpolate(slab, size=(slab.shape[2], wo), mode="bilinear", align_corners=False)
        dev, acc = x.device, torch.promote_types(wide.dtype, torch.float32)
        top = wide.index_select(2, torch.as_tensor(i0 - a, device=dev)).to(acc)
        bot = wide.index_select(2, torch.as_tensor(i1 - a, device=dev)).to(acc)
        l1 = torch.as_tensor(lam1, device=dev).reshape(1, 1, -1, 1).to(acc)
        return (top * (1 - l1) + bot * l1).to(wide.dtype)

    def resize_nearest(self, x, size):
        ho = int(size[0])
        if not (ho % x.shape[2] == 0 or x.shape[2] % ho == 0):
            self._refuse("ops.image.resize_nearest", f"from {x.shape[2]} to {ho} rows a shard: the shard boundaries "
                                                     "do not line up with the factor")
        return image_ops.resize_nearest(x, size)

    def avg_pool(self, x, window, stride=None):
        if (stride or window) != window or x.shape[2] % window:
            self._refuse("ops.image.avg_pool", f"of window {window}, stride {stride} on {x.shape[2]} rows a shard: "
                                               "the shard boundaries do not line up with the window")
        return image_ops.avg_pool(x, window, stride)

    def global_avg_pool(self, x, keepdims=True):
        s = x.sum(dim=(2, 3), keepdim=keepdims, dtype=torch.promote_types(x.dtype, torch.float32))
        s = _AllReduceSum.apply(s, self.group)
        return (s / (self.global_rows(x.shape[2]) * x.shape[3])).to(x.dtype)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d:
            return self.conv2d(*args, **kwargs)
        if func is F.max_pool2d:
            return self.max_pool2d(*args, **kwargs)
        if func is image_ops.resize_bilinear:
            return self.resize_bilinear(*args, **kwargs)
        if func is image_ops.resize_nearest:
            return self.resize_nearest(*args, **kwargs)
        if func is image_ops.avg_pool:
            return self.avg_pool(*args, **kwargs)
        if func is image_ops.global_avg_pool:
            return self.global_avg_pool(*args, **kwargs)
        if func in _REFUSED:
            self._refuse(_REFUSED[func], "is not covered: its rows would mix across shards")
        if func is F.pad:
            pad = kwargs.get("pad", args[1] if len(args) > 1 else ())
            if len(pad) >= 4 and (pad[2] or pad[3]):
                self._refuse("F.pad", f"over H ({pad}) is not covered: the padded map would not split evenly")
        return func(*args, **kwargs)
