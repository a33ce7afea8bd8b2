"""The LM mesh and its collectives: one process a device, axes such as
``("data", "model")`` or ``("pod", "data", "model")``, and ``all_gather``,
``all_to_all``, ``psum``, ``pmean`` and a reduce-scatter over a named
axis (or a tuple of axes), as the reference's ``jax.lax`` collectives
inside ``shard_map``.

Every collective of the LM stack goes through this module.  It moves
bytes only: each collective is an all-gather or an all-to-all of the
tensors' bytes over the group of the named axes, and every reduction is
done afterwards on this rank, adding the members' parts one at a time in
the members' order (row-major over the axes, as JAX orders them).  So a
reduction does not depend on the backend's algorithm, and a rank-by-rank
emulation of the mesh can reproduce it.

Where the group's backend takes no CUDA tensor for these operations
(gloo: one card running four ranks, where NCCL refuses two ranks on one
device), a CUDA tensor goes through pinned host buffers, grown to the
largest payload and reused; a NCCL group takes the CUDA tensors directly
(that path has not been run: the card at hand holds one device).  A
collective over axes of total size 1 is the identity and sends nothing.
A failed collective raises (the group's timeout bounds every wait); a
layout-only mesh (no processes) raises on any collective of size > 1.

Under autograd (``torch.autograd.Function`` classes):

* :func:`all_gather` - its backward sums the gradient's blocks over the
  axes that shard the batch (a reduce-scatter: those ranks computed on
  different rows) and takes this rank's block over the replica axes
  (``model``: the dense compute is repeated there, so each rank holds the
  whole gradient already, and it is taken once);
* :func:`scatter` - this rank's block of a replicated tensor; backward an
  all-gather;
* :func:`all_to_all` - split dim 0 over the members, the inverse move in
  the backward;
* :func:`psum`, :func:`pmean` - backward the identity (and ``1/n``): the
  result is replicated, and so is its gradient;
* :func:`grad_psum` - the identity, whose backward is a ``psum``: where a
  replicated tensor enters a computation split over the members.

:data:`STATS` counts, for each operation, its calls, the bytes of this
rank's input, those bytes by dtype, and the host seconds spent
(staging and the wire, from a synchronised start).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Axes = Union[str, Sequence[str]]

# Axes over which the LM stack repeats its dense compute (the batch is not
# split there): the gradient of a gather over them is taken, not summed.
REPLICA_AXES = ("model",)

STATS: Dict[str, Dict[str, Any]] = {}


def reset_stats() -> None:
    STATS.clear()


def _count(op: str, x: torch.Tensor, seconds: float) -> None:
    s = STATS.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0,
                              "dtypes": {}})
    nbytes = x.numel() * x.element_size()
    s["calls"] += 1
    s["bytes"] += nbytes
    s["seconds"] += seconds
    key = str(x.dtype).replace("torch.", "")
    s["dtypes"][key] = s["dtypes"].get(key, 0) + nbytes


@dataclasses.dataclass(eq=False)
class Mesh:
    """A mesh of devices with named axes, laid out row-major.  With
    ``rank`` set it is a process mesh (this process is the device at
    ``coords``) whose ``groups`` join the ranks of each set of axes;
    ``rank=None`` is a layout only (its specs and block shapes, no
    collective)."""
    axis_names: Tuple[str, ...]
    devices_shape: Tuple[int, ...]
    rank: Optional[int] = None
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    # a sorted tuple of axes -> this rank's group over them (None: the
    # default group); only sets of total size > 1
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False)
    _pinned: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        self.axis_names = tuple(self.axis_names)
        self.devices_shape = tuple(int(n) for n in self.devices_shape)
        if len(self.axis_names) != len(self.devices_shape) or len(
                set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} for shape "
                             f"{self.devices_shape}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in the mesh's order (JAX's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices_shape))

    @property
    def size(self) -> int:
        return math.prod(self.devices_shape)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        if self.rank is None:
            raise ValueError("a layout-only mesh has no rank")
        idx, out = int(self.rank), {}
        for a, n in reversed(list(zip(self.axis_names,
                                      self.devices_shape))):
            idx, out[a] = divmod(idx, n)
        return {a: out[a] for a in self.axis_names}

    def key(self) -> Tuple[int, ...]:
        """This rank's coordinates as a tuple, in axis order."""
        c = self.coords
        return tuple(c[a] for a in self.axis_names)

    def axes_of(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in mesh {self.shape}")
        # the mesh's order, as JAX orders a tuple of axes' members
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self.axes_of(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index among the members over ``axes`` (row-major
        over them: ``jax.lax.axis_index``)."""
        c = self.coords
        idx = 0
        for a in self.axes_of(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def members(self, axes: Axes, coords: Optional[Dict[str, int]] = None
                ) -> Tuple[int, ...]:
        """The ranks that share this rank's (or ``coords``') coordinates
        on every other axis, in their order over ``axes``."""
        axes = self.axes_of(axes)
        c = dict(self.coords if coords is None else coords)
        out = []
        for vals in itertools.product(*(range(self.shape[a])
                                        for a in axes)):
            c.update(zip(axes, vals))
            r = 0
            for a, n in zip(self.axis_names, self.devices_shape):
                r = r * n + c[a]
            out.append(r)
        return tuple(out)

    def group(self, axes: Tuple[str, ...]):
        if self.rank is None:
            raise RuntimeError("a collective on a layout-only mesh "
                               f"{self.shape}: it has no processes")
        if axes not in self.groups:
            raise RuntimeError(f"mesh {self.shape} holds no group over "
                               f"{axes}")
        return self.groups[axes]

    def pinned(self, role: str, nbytes: int) -> torch.Tensor:
        """A pinned host byte buffer of at least ``nbytes`` for ``role``,
        grown (never shrunk) and reused."""
        buf = self._pinned.get(role)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[role] = buf
        return buf[:nbytes]

    def wire_group(self, axes: Axes):
        """``(axes, n, group)`` of a collective over ``axes``."""
        axes = self.axes_of(axes)
        n = self.axis_size(axes)
        return axes, n, (self.group(axes) if n > 1 else None)


def _stage(mesh: Mesh, x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and mesh.backend != "nccl"


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, n: int
                ) -> torch.Tensor:
    """``n`` tensors of ``like``'s shape and dtype from their bytes,
    stacked ``(n, *like.shape)``."""
    return b.view(like.dtype).reshape((n,) + tuple(like.shape))


def _timed_start(x: torch.Tensor) -> float:
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
    return time.perf_counter()


def gather_raw(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """Every member's ``x`` stacked ``(n, *x.shape)`` in member order."""
    import torch.distributed as dist

    axes, n, group = mesh.wire_group(axes)
    if n == 1:
        return x[None]
    t0 = _timed_start(x)
    src = _bytes(x)
    nb = src.numel()
    if _stage(mesh, x):
        host = mesh.pinned("in", nb)
        host.copy_(src)
        out = mesh.pinned("out", n * nb)
        dist.all_gather(list(out.view(n, nb).unbind(0)), host, group=group)
        dst = out.to(x.device)
    else:
        dst = torch.empty(n * nb, dtype=torch.uint8, device=x.device)
        dist.all_gather(list(dst.view(n, nb).unbind(0)), src, group=group)
    _count("all_gather", x, time.perf_counter() - t0)
    return _from_bytes(dst, x, n)


def all_to_all_raw(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """``x``'s dim 0 split into ``n`` chunks, chunk ``j`` sent to member
    ``j``; the chunks received, concatenated in member order along dim 0
    (``jax.lax.all_to_all`` with ``split_axis = concat_axis = 0``)."""
    import torch.distributed as dist

    axes, n, group = mesh.wire_group(axes)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {n} members")
    t0 = _timed_start(x)
    src = _bytes(x)
    nb = src.numel()
    if _stage(mesh, x):
        host = mesh.pinned("in", nb)
        host.copy_(src)
        out = mesh.pinned("out", nb)
        dist.all_to_all_single(out, host, group=group)
        dst = out.to(x.device)
    else:
        dst = torch.empty(nb, dtype=torch.uint8, device=x.device)
        dist.all_to_all_single(dst, src, group=group)
    _count("all_to_all", x, time.perf_counter() - t0)
    return dst.view(x.dtype).reshape(x.shape)


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, one add at a time in member order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def psum_raw(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    return ordered_sum(gather_raw(x, axes, mesh))


def reduce_scatter_raw(x: torch.Tensor, axes: Axes, mesh: Mesh,
                       dim: int = 0) -> torch.Tensor:
    """The sum over the members of ``x``, cut along ``dim`` into ``n``
    blocks, this rank's block: each member's block ``j`` goes to member
    ``j`` (an all-to-all), which adds them in member order."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    parts = torch.stack(x.chunk(n, dim=dim))       # (n, ...block)
    got = all_to_all_raw(parts, axes, mesh)
    return ordered_sum(got)


def block(x: torch.Tensor, axes: Axes, mesh: Mesh, dim: int = 0
          ) -> torch.Tensor:
    """This rank's block of ``x`` cut along ``dim`` over ``axes``."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[mesh.axis_index(axes)]


def _grad_mode(axes: Tuple[str, ...]) -> str:
    rep = [a in REPLICA_AXES for a in axes]
    if all(rep):
        return "block"
    if any(rep):
        raise NotImplementedError(
            f"a gather over {axes} mixes replica and batch axes")
    return "sum"


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.args = (axes, mesh, dim)
        parts = gather_raw(x, axes, mesh)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, dim = ctx.args
        if _grad_mode(mesh.axes_of(axes)) == "block":
            out = block(g, axes, mesh, dim)
        else:
            out = reduce_scatter_raw(g, axes, mesh, dim)
        return out.contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.args = (axes, mesh, dim)
        return block(x, axes, mesh, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        axes, mesh, dim = ctx.args
        parts = gather_raw(g.contiguous(), axes, mesh)
        return torch.cat(parts.unbind(0), dim=dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.args = (axes, mesh)
        return all_to_all_raw(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        axes, mesh = ctx.args
        return all_to_all_raw(g.contiguous(), axes, mesh), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, div):
        ctx.div = div
        out = psum_raw(x, axes, mesh)
        return out if div == 1 else out / div

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.div == 1 else g / ctx.div), None, None, None


class _GradPSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.args = (axes, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axes, mesh = ctx.args
        return psum_raw(g.contiguous(), axes, mesh), None, None


def all_gather(x: torch.Tensor, axes: Axes, mesh: Mesh, dim: int = 0
               ) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in member order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _AllGather.apply(x.contiguous(), mesh.axes_of(axes), mesh, dim)


def scatter(x: torch.Tensor, axes: Axes, mesh: Mesh, dim: int = 0
            ) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    return _Scatter.apply(x, mesh.axes_of(axes), mesh, dim)


def all_to_all(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    return _AllToAll.apply(x.contiguous(), mesh.axes_of(axes), mesh)


def psum(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    return _PSum.apply(x.contiguous(), mesh.axes_of(axes), mesh, 1)


def pmean(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    return _PSum.apply(x.contiguous(), mesh.axes_of(axes), mesh, n)


def grad_psum(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    return _GradPSum.apply(x, mesh.axes_of(axes), mesh)
