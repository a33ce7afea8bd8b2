"""Aura (halo) exchange, N-dimensional (port of ``repro/core/halo.py``).

The exchange is dimension-ordered over the Domain's axes (``2 * ndim``
directed edges): axis-0 slabs first, then axis-1 slabs that include the
freshly filled axis-0 ring cells, which propagates corner neighbours in at
most ``ndim`` hops.

Three comms stand in for the reference's:

* :class:`LocalComm` - one device, tensors without mesh dims (the
  reference's single-device oracle);
* :class:`VirtualMeshComm` - the whole device mesh in one process on one
  card, kept as ``lead = ndim`` leading dims of every tensor in the
  reference's row-major ``linear_rank`` order.  ``shift`` moves data one
  step along a mesh axis, with zeros where a device has no source, as
  ``ppermute`` gives them;
* :class:`ProcessMeshComm` - the counterpart of ``ShardComm``: one process
  a device of the mesh, joined by ``torch.distributed``.  Each process
  holds its own block with ``ndim`` leading dims of size 1 (what the
  reference's ``shard_map`` body sees), and ``shift`` sends each directed
  edge's whole payload as one packed byte buffer (:func:`pack`), which the
  receiver reads through dtype views into its receive buffer
  (:func:`unpack`): the paper's zero-copy receive (section 2.1).

The exchange and the slab helpers work on each: a comm's ``lead`` says
how many leading mesh dims its tensors carry, and ``blocks()`` which
devices of the mesh its tensors hold.  Under an uneven partition the high
faces sit at each device's owned extent, so on the virtual mesh a slab's
index along its axis is one int a device along that mesh axis
(:func:`~repro_torch.core.grid.take_plane`); a process passes its own.

Each comm says which devices one ``shift(tree, axis, direction)`` joins:
``edges(axis, direction)``, the (source, destination) pairs of indices
along the mesh axis - the counterpart of a ``ppermute``'s ``perm`` - and
``shift`` moves data along exactly those pairs (:func:`ring_edges`), so
the step audit (``analysis.step_audit``) checks what runs.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.agent_soa import AgentSoA
from repro_torch.core.delta import (
    DeltaConfig,
    Slab,
    decode_delta,
    decode_full,
    encode_delta,
    encode_full,
    payload_bytes,
)
from repro_torch.core.domain import AXIS_CHARS, Domain
from repro_torch.core.grid import ring_index, set_plane, take_plane


Edges = Tuple[Tuple[int, int], ...]


def ring_edges(size: int, direction: int, toroidal: bool) -> Edges:
    """The (source, destination) pairs of one step by ``direction`` along
    a mesh axis of ``size`` devices: ``i -> i + direction``, wrapping when
    ``toroidal`` and dropped off a closed end (an open chain: a partial
    permutation).  A size-1 axis is ``((0, 0),)`` when toroidal and empty
    when closed."""
    if direction not in (-1, 1):
        raise ValueError(f"shift direction {direction}; expected +-1")
    return tuple((i, (i + direction) % size) for i in range(size)
                 if toroidal or 0 <= i + direction < size)


class Comm:
    """Spatial communication abstraction over an N-D device mesh."""

    lead = 0   # leading device-mesh dims of every tensor the comm moves

    def shift(self, tree: Slab, axis: int, direction: int) -> Slab:
        """Move data one step along a mesh axis; devices with no source get
        zeros (closed boundary) or wrap (toroidal)."""
        raise NotImplementedError

    def edges(self, axis: int, direction: int) -> Edges:
        """The (source, destination) pairs, as indices along mesh axis
        ``axis``, that ``shift(tree, axis, direction)`` moves data along;
        a destination missing from them gets zeros."""
        raise NotImplementedError

    def coords(self):
        raise NotImplementedError

    def linear_rank(self):
        raise NotImplementedError

    def sum_over_all_ranks(self, x):
        raise NotImplementedError

    def blocks(self) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]:
        """The mesh devices whose blocks this comm's tensors hold, as
        ``(index in the leading dims, global mesh coordinates)`` pairs in
        row-major order."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LocalComm(Comm):
    """Single-device comm: an all-ones mesh, tensors without mesh dims."""

    toroidal: Tuple[bool, ...]

    def edges(self, axis: int, direction: int) -> Edges:
        return ring_edges(1, direction, self.toroidal[axis])

    def shift(self, tree: Slab, axis: int, direction: int) -> Slab:
        if self.edges(axis, direction):
            return tree
        return {k: torch.zeros_like(v) for k, v in tree.items()}

    def coords(self) -> Tuple[int, ...]:
        return tuple(0 for _ in self.toroidal)

    def linear_rank(self) -> int:
        return 0

    def sum_over_all_ranks(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class VirtualMeshComm(Comm):
    """The device mesh as ``len(mesh_shape)`` leading dims of every tensor,
    in one process.  ``shift`` along ``axis`` by ``direction`` gives device
    ``i`` the data of device ``i - direction`` (wrapping on toroidal axes)
    and zeros where there is none - every entry of the payload, its
    ``/scale`` and ``/center`` entries included.  On a size-1 axis that is
    the identity when toroidal and zeros when closed, as the reference."""

    mesh_shape: Tuple[int, ...]
    toroidal: Tuple[bool, ...]

    @property
    def lead(self) -> int:
        return len(self.mesh_shape)

    def edges(self, axis: int, direction: int) -> Edges:
        return ring_edges(self.mesh_shape[axis], direction,
                          self.toroidal[axis])

    @staticmethod
    def _runs(size: int, edges: Edges):
        """``edges`` as runs along the axis: ``(source start or None,
        length)`` for consecutive destinations fed by consecutive sources
        (None: destinations with no source, given zeros)."""
        src_of = {d: s for s, d in edges}
        runs, j = [], 0
        while j < size:
            s, k = src_of.get(j), j + 1
            if s is None:
                while k < size and k not in src_of:
                    k += 1
            else:
                while k < size and src_of.get(k) == s + (k - j):
                    k += 1
            runs.append((s, k - j))
            j = k
        return runs

    def shift(self, tree: Slab, axis: int, direction: int) -> Slab:
        runs = self._runs(self.mesh_shape[axis], self.edges(axis, direction))

        def one(x: torch.Tensor) -> torch.Tensor:
            return torch.cat(
                [x.narrow(axis, s, n) if s is not None
                 else torch.zeros_like(x.narrow(axis, 0, n))
                 for s, n in runs], dim=axis)

        return {k: one(v) for k, v in tree.items()}

    def coords(self) -> Tuple[torch.Tensor, ...]:
        """Per-axis mesh coordinates of every device, each shaped like the
        mesh (int32)."""
        grids = np.indices(self.mesh_shape, dtype=np.int32)
        return tuple(torch.from_numpy(g) for g in grids)

    def linear_rank(self) -> torch.Tensor:
        """Row-major rank of every device, shaped like the mesh (int32)."""
        n = math.prod(self.mesh_shape)
        return torch.arange(n, dtype=torch.int32).reshape(self.mesh_shape)

    def sum_over_all_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the leading mesh dims, given back to every device."""
        lead = self.lead
        total = x.sum(dim=tuple(range(lead)), keepdim=True)
        return total.expand(x.shape)

    @property
    def lead_shape(self) -> Tuple[int, ...]:
        return tuple(self.mesh_shape)

    def blocks(self):
        return tuple((c, c) for c in np.ndindex(*self.mesh_shape))


# ---------------------------------------------------------------------------
# One process a device: packed edge buffers over torch.distributed
# ---------------------------------------------------------------------------

# Byte alignment of each entry in a packed buffer: every dtype view of the
# receive buffer starts on a multiple of its element size.
PACK_ALIGN = 16

# (name, dtype, shape, byte offset, byte count) of each entry of a payload
Layout = Tuple[Tuple[str, torch.dtype, Tuple[int, ...], int, int], ...]


def pack_layout(tree: Slab) -> Tuple[Layout, int]:
    """Where each entry of ``tree`` sits in its packed buffer, and the
    buffer's length in bytes.  Both ends of an edge compute it from their
    own payload: slab shapes are fixed and the same on every device, so no
    size crosses the wire."""
    out, off = [], 0
    for name, t in tree.items():
        n = t.numel() * t.element_size()
        out.append((name, t.dtype, tuple(t.shape), off, n))
        off += -(-n // PACK_ALIGN) * PACK_ALIGN
    return tuple(out), off


def pack(tree: Slab, layout: Layout, buf: torch.Tensor) -> torch.Tensor:
    """Copy every entry of ``tree`` into the uint8 ``buf`` at ``layout``'s
    offsets; returns ``buf``."""
    for name, dtype, shape, off, n in layout:
        if n:
            buf[off:off + n].view(dtype).view(shape).copy_(tree[name])
    return buf


def unpack(buf: torch.Tensor, layout: Layout) -> Slab:
    """The entries of a packed buffer as dtype views into it (no copy)."""
    return {name: buf[off:off + n].view(dtype).view(shape)
            for name, dtype, shape, off, n in layout}


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMeshComm(Comm):
    """This process's device of a spatial mesh of processes, one device
    each, joined by the mesh's ``torch.distributed`` group: the default
    group, or for a mesh over a subset of its ranks (a degraded run's
    survivors) the subset's own, ``group`` (the counterpart of the
    reference's ``ShardComm``).  Every tensor carries ``ndim`` leading
    dims of size 1, the layout of the virtual mesh's one-device case.

    ``shift(tree, axis, direction)`` sends this device's payload to the
    neighbour at ``coords[axis] + direction`` and gives back the one
    received from ``coords[axis] - direction``, wrapping on toroidal axes;
    a device with no source gets zeros in every entry (``/scale`` and
    ``/center`` included), and a size-1 axis is the identity when toroidal
    and zeros when closed, with no message - :class:`VirtualMeshComm`'s
    rules.  The payload crosses as ONE message: its tensors packed into a
    contiguous byte buffer (:func:`pack_layout`), sent and received with
    non-blocking ``isend``/``irecv`` under a tag of its (axis, direction)
    - on a size-2 torus both neighbours are one rank, and the two
    directions' messages must not cross.  The receiver's payload is views
    into its receive buffer.  Where the group's backend takes no CUDA
    tensor (gloo), a buffer on the card goes through a pinned host buffer
    allocated once per edge and reused.

    ``stats`` counts the messages sent, their bytes and the host seconds
    spent in ``shift`` (packing, staging and the wire, from a synchronised
    start) and in the all-reduces."""

    mesh_shape: Tuple[int, ...]
    toroidal: Tuple[bool, ...]
    mesh_coords: Tuple[int, ...]       # this process's device
    ranks: Any                         # numpy: process rank at each coord
    backend: str = "gloo"              # the group's
    group: Any = None                  # the mesh's group (None: default)
    # (axis, direction, "send"/"recv") -> reusable buffer
    _buffers: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    stats: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(messages=0, bytes=0, seconds=0.0),
        repr=False)

    @staticmethod
    def from_mesh(mesh, toroidal: Tuple[bool, ...]) -> "ProcessMeshComm":
        """The comm of this process's device of ``mesh``, a
        ``torch.distributed.device_mesh.DeviceMesh`` over every rank of
        its group (:func:`repro_torch.launch.mesh.make_abm_mesh`)."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_group

        group = mesh_group(mesh)
        ranks = np.asarray(mesh.mesh.cpu().numpy(), dtype=np.int64)
        size = dist.get_world_size(group)
        if ranks.size != size:
            raise ValueError(
                f"mesh {ranks.shape} holds {ranks.size} ranks; its process "
                f"group has {size}: a process mesh spans its whole group")
        coords = mesh.get_coordinate()
        if coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        return ProcessMeshComm(
            mesh_shape=tuple(ranks.shape), toroidal=tuple(toroidal),
            mesh_coords=tuple(int(c) for c in coords), ranks=ranks,
            backend=str(dist.get_backend(group)), group=group)

    def group_rank(self, ranks: torch.Tensor) -> torch.Tensor:
        """The ranks in the mesh's group of default-group ``ranks`` (an
        int64 tensor); a group numbers its members in ascending order."""
        if self.group is None:
            return ranks
        members = torch.from_numpy(np.sort(self.ranks.reshape(-1)))
        return torch.searchsorted(members.to(ranks.device), ranks)

    def global_rank(self, group_rank: int) -> int:
        """The default-group rank of rank ``group_rank`` of the mesh's
        group."""
        return int(np.sort(self.ranks.reshape(-1))[int(group_rank)])

    def barrier(self) -> None:
        """A barrier of the mesh's ranks."""
        import torch.distributed as dist

        dist.barrier(group=self.group)

    @property
    def lead(self) -> int:
        return len(self.mesh_shape)

    @property
    def lead_shape(self) -> Tuple[int, ...]:
        return (1,) * len(self.mesh_shape)

    def blocks(self):
        return (((0,) * self.lead, self.mesh_coords),)

    def coords(self) -> Tuple[int, ...]:
        """This device's mesh coordinates (host ints)."""
        return self.mesh_coords

    def linear_rank(self) -> int:
        """Row-major rank of this device in the mesh."""
        return int(np.ravel_multi_index(self.mesh_coords, self.mesh_shape))

    def edges(self, axis: int, direction: int) -> Edges:
        return ring_edges(self.mesh_shape[axis], direction,
                          self.toroidal[axis])

    def peers(self, axis: int, direction: int
              ) -> Tuple[Optional[int], Optional[int]]:
        """This device's (source, destination) process ranks in one
        ``shift(tree, axis, direction)``: its ``irecv`` and ``isend``
        peers, the pairs of :meth:`edges` that hold it (None where it
        has none)."""
        me = self.mesh_coords[axis]
        src = dst = None

        def rank(i):
            c = list(self.mesh_coords)
            c[axis] = i
            return int(self.ranks[tuple(c)])

        for s, d in self.edges(axis, direction):
            if s == me:
                dst = rank(d)
            if d == me:
                src = rank(s)
        return src, dst

    def _buffer(self, key, nbytes: int, device, pinned: bool = False
                ) -> torch.Tensor:
        buf = self._buffers.get(key)
        if buf is None or buf.numel() != nbytes or buf.device != device:
            buf = torch.empty(nbytes, dtype=torch.uint8, device=device,
                              pin_memory=pinned)
            self._buffers[key] = buf
        return buf

    def _staged(self, device: torch.device) -> bool:
        return device.type == "cuda" and self.backend != "nccl"

    def shift(self, tree: Slab, axis: int, direction: int) -> Slab:
        import torch.distributed as dist

        src, dst = self.peers(axis, direction)
        me = int(self.ranks[self.mesh_coords])
        if src == dst == me:
            return tree          # a size-1 torus: no message
        if src is None and dst is None:
            return {k: torch.zeros_like(v) for k, v in tree.items()}
        dev = next(iter(tree.values())).device
        staged = self._staged(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        layout, nbytes = pack_layout(tree)
        tag = 2 * axis + (direction > 0)
        reqs = []
        recv = wire_in = None
        if src is not None:
            recv = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            wire_in = self._buffer((axis, direction, "recv"), nbytes,
                                   torch.device("cpu"), pinned=True) \
                if staged else recv
            reqs.append(dist.irecv(wire_in, src=src, tag=tag,
                                    group=self.group))
        if dst is not None:
            send = pack(tree, layout, self._buffer(
                (axis, direction, "send"), nbytes, dev))
            if staged:
                wire_out = self._buffer((axis, direction, "send_host"),
                                        nbytes, torch.device("cpu"),
                                        pinned=True)
                wire_out.copy_(send)
            else:
                wire_out = send
            reqs.append(dist.isend(wire_out, dst=dst, tag=tag,
                                    group=self.group))
            self.stats["messages"] += 1
            self.stats["bytes"] += nbytes
        for r in reqs:
            r.wait()
        if recv is None:
            out = {k: torch.zeros_like(v) for k, v in tree.items()}
        else:
            if staged:
                recv.copy_(wire_in)
            out = unpack(recv, layout)
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        t0 = time.perf_counter()
        host = x.device.type == "cuda" and self.backend != "nccl"
        t = x.detach().to("cpu", copy=True) if host else x.detach().clone()
        dist.all_reduce(t, op=op, group=self.group)
        self.stats["seconds"] += time.perf_counter() - t0
        return t.to(x.device) if host else t

    def sum_over_all_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over every device of the mesh, on every
        device (an ``all_reduce``; paper section 3.4)."""
        import torch.distributed as dist

        return self._all_reduce(x, dist.ReduceOp.SUM)

    def max_over_all_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The largest ``x`` over every device of the mesh, on every
        device."""
        import torch.distributed as dist

        return self._all_reduce(x, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# Slab extraction / insertion
# ---------------------------------------------------------------------------

def take_slab(soa: AgentSoA, axis: int, index, lead: int = 0) -> Slab:
    """Copy one cell-hyperplane (incl. valid mask) of every device out as
    an exchange slab (``lead`` mesh dims first).  ``index`` is an int, or
    on a mesh one int a device along mesh axis ``axis``
    (:func:`~repro_torch.core.grid.take_plane`).

    A copy, not a view: slabs are kept as delta references and must not
    change when the SoA's ring is written later in the same exchange."""
    slab = {name: take_plane(a, axis, index, lead).clone()
            for name, a in soa.attrs.items()}
    slab["valid"] = take_plane(soa.valid, axis, index, lead).clone()
    return slab


def put_slab(soa: AgentSoA, axis: int, index, slab: Slab,
             lead: int = 0) -> AgentSoA:
    """Write ``slab`` into one hyperplane of ``soa`` **in place** (the
    reference returns a new SoA; the in-place write saves a full SoA copy
    per edge), ``index`` as :func:`take_slab` takes it.  Returns ``soa``."""
    for name, a in soa.attrs.items():
        set_plane(a, axis, index, slab[name], lead)
    set_plane(soa.valid, axis, index, slab["valid"], lead)
    return soa


def clear_slab_at(soa: AgentSoA, axis: int, index: int, lead: int = 0
                  ) -> AgentSoA:
    """Invalidate one hyperplane; returns a new ``valid``."""
    valid = soa.valid.clone()
    valid[ring_index(axis, index, lead)] = False
    return soa.replace(valid=valid)


def dirs_for(ndim: int) -> Dict[str, Tuple[int, int]]:
    """Directed edges for delta references: ``2 * ndim`` (axis, direction)
    pairs keyed ``"xm"/"xp"/"ym"/"yp"[/"zm"/"zp"]``."""
    out: Dict[str, Tuple[int, int]] = {}
    for axis in range(ndim):
        c = AXIS_CHARS[axis]
        out[c + "m"] = (axis, -1)
        out[c + "p"] = (axis, +1)
    return out


def _zero_overflow(slab: Slab, lead: int) -> torch.Tensor:
    v = slab["valid"]
    return torch.zeros(v.shape[:lead], dtype=torch.int32, device=v.device)


def _codec_send(slab, ref, cfg: DeltaConfig, full: bool, lead: int):
    if not cfg.enabled or full:
        payload, new_ref = encode_full(slab)
        return payload, new_ref, _zero_overflow(slab, lead)
    return encode_delta(slab, ref, cfg, lead)


def _codec_recv(payload, ref, cfg: DeltaConfig, full: bool, lead: int):
    if not cfg.enabled or full:
        return decode_full(payload)
    return decode_delta(payload, ref, cfg, lead)


def halo_exchange(
    geom: Domain,
    soa: AgentSoA,
    comm: Comm,
    refs: Dict[str, Slab],
    cfg: DeltaConfig,
    full: bool,
    out: AgentSoA = None,
    owned=None,
) -> Tuple[AgentSoA, Dict[str, Slab], int, torch.Tensor]:
    """Rebuild the aura ring from neighbour devices' boundary cells.

    ``soa`` and ``refs`` carry ``comm.lead`` leading mesh dims.  Returns
    (soa with ring filled, updated references, wire bytes of one device's
    sends, codec overflow count shaped like the mesh dims).  The ring is
    written into a copy of ``soa``, made into ``out``'s tensors when given
    (an ensemble's lane of its stacked SoA) and into new ones otherwise;
    the caller's tensors are not modified.

    ``refs[d + "_out"]`` holds what was last sent along directed edge
    ``d`` (receiver-reconstructed) and ``refs[d + "_in"]`` what was last
    received from it: the closed-loop invariant is that a device's
    ``xp_out`` equals its +x neighbour's ``xm_in``.  With ``cfg.enabled``
    and not ``full`` the float attributes cross as quantized deltas
    against those references (:func:`repro_torch.core.delta.encode_delta`),
    one kernel launch per float attribute for every device at once.

    Under uneven ownership (``owned``: per axis, one device's owned width
    on a one-device comm, or the widths at each mesh coordinate along the
    axis, ``Domain.axis_widths``, on the virtual mesh; a process of the
    mesh passes a one-element tuple) each device sends
    its last owned hyperplane ``owned[a]`` and receives into its ring at
    ``owned[a] + 1``; the low side stays at 1 and 0.  Slab shapes are the
    same on every device (full padded hyperplanes; slots beyond a sender's
    cross-axis widths are invalid), so the per-edge references work
    unchanged, and a rectilinear partition gives neighbours along an axis
    the same cross-axis widths, so a slab lands aligned.
    """
    lead = comm.lead
    shape = geom.local_shape
    new_refs = dict(refs)
    nbytes = 0
    overflow = None
    if out is None:
        soa = AgentSoA(attrs={k: v.clone() for k, v in soa.attrs.items()},
                       valid=soa.valid.clone())
    else:
        for k, v in soa.attrs.items():
            out.attrs[k].copy_(v)
        out.valid.copy_(soa.valid)
        soa = out

    def _exchange(soa, axis, src_index, dst_index, direction, out_key,
                  in_key):
        nonlocal nbytes, overflow
        slab = take_slab(soa, axis, src_index, lead)
        payload, new_refs[out_key], oflow = _codec_send(
            slab, new_refs[out_key], cfg, full, lead)
        overflow = oflow if overflow is None else overflow + oflow
        nbytes += payload_bytes(payload, lead)
        recv = comm.shift(payload, axis, direction)
        recon, new_refs[in_key] = _codec_recv(
            recv, new_refs[in_key], cfg, full, lead)
        return put_slab(soa, axis, dst_index, recon, lead)

    for axis in range(geom.ndim):
        h = shape[axis]
        c = AXIS_CHARS[axis]
        if owned is None:
            hi_src, hi_dst = h - 2, h - 1
        elif isinstance(owned[axis], (int, np.integer)):
            hi_src, hi_dst = int(owned[axis]), int(owned[axis]) + 1
        else:
            hi_src = tuple(int(w) for w in owned[axis])
            hi_dst = tuple(w + 1 for w in hi_src)
        # my high face -> +axis neighbour's low ring, and vice versa
        soa = _exchange(soa, axis, hi_src, 0, +1, c + "p_out", c + "m_in")
        soa = _exchange(soa, axis, 1, hi_dst, -1, c + "m_out", c + "p_in")
    return soa, new_refs, nbytes, overflow


def init_refs(geom: Domain, soa: AgentSoA, lead: int = 0
              ) -> Dict[str, Slab]:
    """Zero-valued reference slabs for all ``4 * ndim`` directed-edge refs;
    the slab for an edge along ``axis`` is shaped like that axis's face."""
    refs: Dict[str, Slab] = {}
    for d, (axis, _) in dirs_for(geom.ndim).items():
        proto = take_slab(soa, axis, 0, lead)
        refs[d + "_out"] = {k: torch.zeros_like(v) for k, v in proto.items()}
        refs[d + "_in"] = {k: torch.zeros_like(v) for k, v in proto.items()}
    return refs
