"""Neighbour iteration over the uniform NSG - the engine's interaction sweep
(port of ``repro/core/neighbors.py``).

Three interchangeable backends compute the same per-agent accumulator sums
over 2-D or 3-D domains (the ``3**ndim`` offset stencil):

* ``"reference"`` - :func:`pair_accumulate`: gathers the 3^D cell
  neighbourhood into a (3^D K,) slot axis and applies the pair kernel over
  the full (K, 3^D K) pair block.  The parity oracle.
* ``"tiled"`` - :func:`pair_accumulate_tiled`: 3^D (K, K) pair tiles from
  plain slices of the resident SoA, reduced in the reference's offset
  order.
* ``"kernel"`` - :func:`pair_accumulate_kernel`: the hand-written CUDA
  ``pair_sweep`` kernel (``kernels/neighbor_interaction.py``), which reads
  the resident SoA directly; on a CPU tensor it runs the kernel's plain
  version.

``"auto"`` resolves to ``"kernel"`` on a CUDA tensor and ``"tiled"`` on a
CPU tensor.  All backends share the masking semantics: invalid slots,
self-pairs (by global id) and pairs beyond the radius contribute zero.
:func:`sweep_accumulate_lanes` is the lane form an ensemble sweeps with:
the lanes of one device block, each with its own pair function and
params, in one kernel launch (the other backends: lane by lane).
:func:`sweep_accumulate_overlapped` is the interior/boundary split of the
sweep (communication hiding): the whole sweep over the pre-exchange SoA,
then each of the ``2 * ndim`` ring-adjacent faces recomputed over its
3-plane band of the post-exchange SoA - on the kernel, one more launch a
face.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.agent_soa import AgentSoA, GID_COUNT, GID_RANK, POS
from repro_torch.core.domain import Domain
from repro_torch.kernels import neighbor_interaction

Tensors = Dict[str, torch.Tensor]

SWEEP_BACKENDS = ("reference", "tiled", "kernel")

# pair_fn(attrs_i, attrs_j, disp, dist2, params) -> dict of contributions,
# each broadcastable over the pair axes (..., K, 3^D K) with trailing dims.
PairFn = Callable[[Tensors, Tensors, torch.Tensor, torch.Tensor, dict],
                  Tensors]


def offsets_for(ndim: int) -> Tuple[Tuple[int, ...], ...]:
    """The 3^ndim cell-offset stencil, in row-major (reference) order."""
    return tuple(itertools.product((-1, 0, 1), repeat=ndim))


def resolve_sweep_backend(backend: str = "auto",
                          device: torch.device = None) -> str:
    """Resolve ``"auto"`` for the device the SoA lives on: the CUDA kernel
    on a CUDA tensor, the tiled sweep on a CPU tensor."""
    if backend in (None, "auto"):
        if device is None:
            raise ValueError("resolving sweep backend 'auto' needs the "
                             "device of the SoA")
        return "kernel" if torch.device(device).type == "cuda" else "tiled"
    if backend not in SWEEP_BACKENDS:
        raise ValueError(
            f"unknown sweep backend {backend!r}; expected 'auto' or one of "
            f"{SWEEP_BACKENDS}")
    return backend


def _interior(geom: Domain):
    return tuple(slice(1, h - 1) for h in geom.local_shape)


def minimum_image_box(geom: Domain):
    """Per-axis minimum-image lengths (None on closed axes), as the
    ``pair_sweep`` kernel and its plain version take them."""
    return tuple(L if t else None
                 for L, t in zip(geom.domain_size, geom.toroidal))


def gather_neighborhood(geom: Domain, soa: AgentSoA, names: Tuple[str, ...]):
    """Stack the 3^D-cell neighbourhood of every interior cell.

    Returns (self_attrs, nbr_attrs, self_valid, nbr_valid): self tensors of
    shape (*interior, K, ...), neighbour tensors (*interior, 3^D K, ...).
    """
    ai, aj, vi, vj = neighbor_interaction.neighborhood_slabs(
        soa.attrs, soa.valid, names)
    interior = geom.interior

    def unflat(a):
        return a.reshape(interior + tuple(a.shape[1:]))

    return ({n: unflat(a) for n, a in ai.items()},
            {n: unflat(a) for n, a in aj.items()}, unflat(vi), unflat(vj))


def min_image(disp: torch.Tensor, geom: Domain) -> torch.Tensor:
    """Per-axis minimum-image convention on toroidal axes only."""
    tor = geom.toroidal
    if not any(tor):
        return disp
    box = torch.tensor(geom.domain_size, dtype=disp.dtype, device=disp.device)
    wrapped = disp - box * torch.round(disp / box)
    if all(tor):
        return wrapped
    return torch.where(torch.tensor(tor, device=disp.device), wrapped, disp)


def _r2(radius: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(radius * radius), device=device)


def _masked(mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    while mask.dim() < c.dim():
        mask = mask[..., None]
    return torch.where(mask, c, torch.zeros((), dtype=c.dtype,
                                            device=c.device))


def pair_accumulate(
    geom: Domain,
    soa: AgentSoA,
    pair_fn: PairFn,
    pair_attrs: Tuple[str, ...],
    radius: float,
    params: dict,
) -> Tensors:
    """Sum pair-kernel contributions over each interior agent's neighbours.

    Returns a dict of accumulators with shape (*interior, K, *trailing).
    """
    nd = geom.ndim
    self_a, nbr_a, self_v, nbr_v = gather_neighborhood(geom, soa, pair_attrs)
    attrs_i = {n: a.unsqueeze(nd + 1) for n, a in self_a.items()}
    attrs_j = {n: a.unsqueeze(nd) for n, a in nbr_a.items()}

    disp = min_image(attrs_j[POS] - attrs_i[POS], geom)  # (..., K, 3^D K, D)
    dist2 = (disp * disp).sum(dim=-1)
    same = (attrs_i[GID_RANK] == attrs_j[GID_RANK]) & (
        attrs_i[GID_COUNT] == attrs_j[GID_COUNT])
    mask = (self_v.unsqueeze(nd + 1) & nbr_v.unsqueeze(nd) & ~same
            & (dist2 <= _r2(radius, dist2.device)))

    contribs = pair_fn(attrs_i, attrs_j, disp, dist2, params)
    return {name: _masked(mask, c).sum(dim=nd + 1)
            for name, c in contribs.items()}


def pair_accumulate_tiled(
    geom: Domain,
    soa: AgentSoA,
    pair_fn: PairFn,
    pair_attrs: Tuple[str, ...],
    radius: float,
    params: dict,
) -> Tensors:
    """Offset-tiled sweep: 3^D (*interior, K, K) pair tiles from slices of
    the resident SoA, stacked along j in the reference's offset order and
    reduced with one sum."""
    shape = geom.local_shape
    nd = geom.ndim
    need = set(pair_attrs) | {POS, GID_RANK, GID_COUNT}
    isl = _interior(geom)

    attrs_i = {n: soa.attrs[n][isl].unsqueeze(nd + 1) for n in need}
    vi = soa.valid[isl].unsqueeze(nd + 1)
    r2 = _r2(radius, vi.device)

    tiles: Dict[str, list] = {}
    for off in offsets_for(nd):
        osl = tuple(slice(1 + o, h - 1 + o) for o, h in zip(off, shape))
        nbr = {n: soa.attrs[n][osl].unsqueeze(nd) for n in need}
        nv = soa.valid[osl].unsqueeze(nd)
        disp = min_image(nbr[POS] - attrs_i[POS], geom)  # (..., K, K, D)
        dist2 = (disp * disp).sum(dim=-1)
        same = (attrs_i[GID_RANK] == nbr[GID_RANK]) & (
            attrs_i[GID_COUNT] == nbr[GID_COUNT])
        mask = vi & nv & ~same & (dist2 <= r2)
        for name, c in pair_fn(attrs_i, nbr, disp, dist2, params).items():
            tiles.setdefault(name, []).append(_masked(mask, c))

    out: Tensors = {}
    for name, parts in tiles.items():
        shape_b = torch.broadcast_shapes(*[p.shape for p in parts])
        stacked = torch.stack([p.expand(shape_b) for p in parts], dim=nd + 1)
        flat = stacked.reshape(
            tuple(shape_b[:nd + 1]) + (len(parts) * shape_b[nd + 1],)
            + tuple(shape_b[nd + 2:]))
        out[name] = flat.sum(dim=nd + 1)
    return out


def pair_accumulate_kernel(
    geom: Domain,
    soa: AgentSoA,
    pair_fn: PairFn,
    pair_attrs: Tuple[str, ...],
    radius: float,
    params: dict,
) -> Tensors:
    """The ``pair_sweep`` kernel over the resident SoA (its plain version
    on a CPU tensor)."""
    return neighbor_interaction.pair_sweep(
        soa.attrs, soa.valid, pair_fn=pair_fn, pair_attrs=pair_attrs,
        radius=radius, params=params, box=minimum_image_box(geom))


_BACKENDS = {
    "reference": pair_accumulate,
    "tiled": pair_accumulate_tiled,
    "kernel": pair_accumulate_kernel,
}


def sweep_accumulate(
    geom: Domain,
    soa: AgentSoA,
    pair_fn: PairFn,
    pair_attrs: Tuple[str, ...],
    radius: float,
    params: dict,
    *,
    backend: str = "reference",
) -> Tensors:
    """Backend-dispatched neighbourhood sweep (the engine's entry point)."""
    backend = resolve_sweep_backend(backend, soa.valid.device)
    return _BACKENDS[backend](geom, soa, pair_fn, pair_attrs, radius, params)


def sweep_accumulate_lanes(
    geom: Domain,
    soa: AgentSoA,
    pair_fns: Sequence[PairFn],
    pair_attrs: Tuple[str, ...],
    radius: float,
    params: Sequence[dict],
    *,
    backend: str = "reference",
    table: Optional[torch.Tensor] = None,
) -> Tensors:
    """The sweep of B lanes of one device block: ``soa`` holds ``(B,
    *local_grid, K, ...)`` tensors (lane ``b`` at index ``b``, any lane
    stride), lane ``b`` runs ``pair_fns[b]`` with ``params[b]``.  Returns
    ``(B, *interior, K, *trailing)`` accumulators.  The ``"kernel"``
    backend sweeps every lane in one launch, its per-lane params from
    ``table`` (:func:`~repro_torch.kernels.neighbor_interaction.
    lane_table`); the others sweep lane by lane."""
    backend = resolve_sweep_backend(backend, soa.valid.device)
    if backend == "kernel":
        return neighbor_interaction.pair_sweep_lanes(
            soa.attrs, soa.valid, pair_fns=pair_fns, pair_attrs=pair_attrs,
            radius=radius, params=params, box=minimum_image_box(geom),
            table=table)
    per = [_BACKENDS[backend](
        geom, AgentSoA(attrs={n: a[b] for n, a in soa.attrs.items()},
                       valid=soa.valid[b]),
        fn, pair_attrs, radius, p) for b, (fn, p) in enumerate(
            zip(pair_fns, params))]
    return {n: torch.stack([acc[n] for acc in per]) for n in per[0]}


# ---------------------------------------------------------------------------
# Overlapped interior/boundary split (communication hiding)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SlabGeom:
    """Domain stand-in for a face band: every backend reads exactly these
    attributes, so the unmodified sweep runs on a sub-block of the local
    grid (the 3-plane band around a boundary hyperplane)."""
    local_shape: Tuple[int, ...]
    interior: Tuple[int, ...]
    ndim: int
    cap: int
    toroidal: Tuple[bool, ...]
    domain_size: Tuple[float, ...]


def face_band(geom: Domain, soa: AgentSoA, axis: int, face_idx: int
              ) -> Tuple[_SlabGeom, AgentSoA]:
    """The 3-plane band ``[face_idx - 1, face_idx + 1]`` along ``axis`` of
    a block (the full padded extent of every other axis) and its geometry,
    whose own interior is the one plane at ``face_idx``.  The band is a
    view: contiguous along axis 0, strided along a later axis."""
    band = AgentSoA(attrs={n: a.narrow(axis, face_idx - 1, 3)
                           for n, a in soa.attrs.items()},
                    valid=soa.valid.narrow(axis, face_idx - 1, 3))
    lengths = tuple(3 if a == axis else h
                    for a, h in enumerate(geom.local_shape))
    return _SlabGeom(local_shape=lengths,
                     interior=tuple(h - 2 for h in lengths),
                     ndim=geom.ndim, cap=geom.cap, toroidal=geom.toroidal,
                     domain_size=geom.domain_size), band


def face_indices(geom: Domain, axis: int, owned=None) -> Tuple[int, int]:
    """The two ring-adjacent faces along ``axis`` (local indices): 1, and
    ``h - 2`` or the owned extent ``owned[axis]``."""
    hi = geom.local_shape[axis] - 2 if owned is None else int(owned[axis])
    return (1, hi)


def _face_sweep(backend: str, bgeom: _SlabGeom, band: AgentSoA,
                pair_fn: PairFn, pair_attrs: Tuple[str, ...], radius: float,
                params: dict) -> Tensors:
    """One face band's sweep.  The kernel reads contiguous columns, so on
    it a band (strided along a later axis) has the columns the law reads
    copied first, and its launch counts as a face band's."""
    if backend != "kernel":
        return _BACKENDS[backend](bgeom, band, pair_fn, pair_attrs, radius,
                                  params)
    names = dict.fromkeys((POS, GID_RANK, GID_COUNT) + tuple(pair_attrs))
    return neighbor_interaction.pair_sweep(
        {n: band.attrs[n].contiguous() for n in names},
        band.valid.contiguous(), pair_fn=pair_fn, pair_attrs=pair_attrs,
        radius=radius, params=params, box=minimum_image_box(bgeom),
        face=True)


def sweep_accumulate_overlapped(
    geom: Domain,
    soa_pre: AgentSoA,
    soa_post: AgentSoA,
    pair_fn: PairFn,
    pair_attrs: Tuple[str, ...],
    radius: float,
    params: dict,
    *,
    backend: str = "reference",
    owned=None,
) -> Tensors:
    """Interior/boundary split sweep for communication hiding.

    ``soa_pre`` is one device's block *before* the aura exchange (ring
    invalidated by ``clear_ring``/``mask_unowned``) and ``soa_post`` the
    same block after it.  The interior pass sweeps ``soa_pre`` whole: it
    does not wait for the exchange.  Deep cells never read a ring
    hyperplane, and the exchange writes only ring hyperplanes, so their
    sums are final already.  The boundary pass then recomputes each
    ring-adjacent face (index 1, and ``h - 2`` or, under uneven ownership,
    the owned extent ``owned[a]``) from ``soa_post`` and overwrites those
    planes of the accumulators.  A cell on several faces gets its full
    sum from each, so the overwrite is idempotent at edges and corners.
    Per backend the result equals the monolithic sweep of ``soa_post`` bit
    for bit at every owned cell (every interior cell on an equal split):
    each cell's sum runs over the same stencil in the same order.
    """
    backend = resolve_sweep_backend(backend, soa_pre.valid.device)
    acc = _BACKENDS[backend](geom, soa_pre, pair_fn, pair_attrs, radius,
                             params)
    for axis in range(geom.ndim):
        for face_idx in face_indices(geom, axis, owned):
            # the band is the face's whole 3^D stencil support, so the
            # unmodified sweep over it sums each face cell as the whole
            # sweep does
            bgeom, band = face_band(geom, soa_post, axis, face_idx)
            facc = _face_sweep(backend, bgeom, band, pair_fn, pair_attrs,
                               radius, params)
            for name, a in acc.items():
                a.narrow(axis, face_idx - 1, 1).copy_(facc[name])
    return acc
