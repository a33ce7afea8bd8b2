"""Uniform neighbour-search grid with capacity-bounded binning (port of
``repro/core/grid.py``).

Agents are re-scattered into their cells each step with a sort-based,
capacity-bounded scatter.  The slot layout is the reference's exactly: the
same keys, a stable sort, the same within-cell rank, the same sentinel
slot for invalid and overflowing agents.  Everything stays on the device:
``dropped`` is returned as a tensor, so no host sync happens inside a step.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.agent_soa import AgentSoA, POS, flat_view
from repro_torch.core.domain import Domain


# The largest float32 below 2**31.
_F32_BELOW_2_31 = 2147483520.0


def floor_int32(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` as int32 by XLA's conversion, which saturates and
    takes NaN to 0 (the reference bins a NaN position into cell 1).  The
    card's conversion does the same; the CPU's (x86) gives INT_MIN for NaN
    and for every value out of range, so there it is spelled out."""
    f = torch.floor(x)
    if f.device.type != "cpu":
        return f.to(torch.int32)
    c = torch.nan_to_num(f, nan=0.0).clamp(
        min=-2147483648.0, max=_F32_BELOW_2_31).to(torch.int32)
    return torch.where(f > _F32_BELOW_2_31,
                       torch.tensor(2147483647, dtype=torch.int32), c)


def cell_of(geom: Domain, pos: torch.Tensor, origin: torch.Tensor,
            owned=None) -> torch.Tensor:
    """Map world positions (N, ndim) to local cell coordinates (N, ndim)
    including the halo offset: interior cells are [1, i_a] per axis, ring
    cells (0 or i_a + 1) hold agents that must migrate.  Under uneven
    ownership ``owned`` holds the device's per-axis owned widths and the
    clamp resolves against them: the high migration ring sits at
    ``owned[a] + 1``, and padding cells beyond it never bin agents."""
    # float32 division by a device tensor (not a Python scalar, which CUDA
    # may turn into a multiplication by the reciprocal), as the reference's
    # (pos - origin) / float32(cell_size).
    cs = torch.tensor(geom.cell_size, dtype=torch.float32, device=pos.device)
    rel = (pos - origin[None, :]) / cs
    c = floor_int32(rel) + 1
    top = [h - 1 for h in geom.local_shape] if owned is None \
        else [int(w) + 1 for w in owned]
    return torch.stack(
        [torch.clamp(c[:, a], 0, top[a]) for a in range(geom.ndim)], dim=1)


def ravel_cells(geom: Domain, cells: torch.Tensor) -> torch.Tensor:
    """Row-major fold of per-axis cell coordinates (N, ndim) into flat cell
    ids (N,) over the local grid."""
    shape = geom.local_shape
    cid = cells[:, 0]
    for a in range(1, geom.ndim):
        cid = cid * shape[a] + cells[:, a]
    return cid


_SCAN_ROW = 1024


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum of a 1-D integer tensor (the reference's
    ``associative_scan(maximum)``), as ``torch.cummax`` in two levels: over
    rows of ``_SCAN_ROW`` elements, then over the rows' carries.  PyTorch's
    CUDA cummax scans an innermost row with a single warp, so a one-level
    call over the ~1e8 slots of a full-size grid would run serially; the
    max is exact, so the two levels give the same result."""
    n = x.shape[0]
    low = torch.iinfo(x.dtype).min
    pad = (-n) % _SCAN_ROW
    if pad:
        x = torch.cat([x, x.new_full((pad,), low)])
    rows = torch.cummax(x.view(-1, _SCAN_ROW), dim=1).values
    carry = torch.cummax(rows[:, -1], dim=0).values
    carry = torch.cat([carry.new_full((1,), low), carry[:-1]])
    return torch.maximum(rows, carry[:, None]).reshape(-1)[:n]


def bin_agents(
    geom: Domain,
    attrs: Dict[str, torch.Tensor],
    valid: torch.Tensor,
    origin: torch.Tensor,
    owned=None,
) -> Tuple[AgentSoA, torch.Tensor]:
    """Capacity-bounded scatter of flat agents (N, ...) into the local
    cell-slot grid ``local_shape + (K, ...)``.

    Returns the binned SoA and the number of agents dropped for cell
    overflow, as an int32 device tensor.  ``owned`` (the device's per-axis
    owned widths) switches the clamp to uneven ownership (:func:`cell_of`).
    """
    shape = geom.local_shape
    cap = geom.cap
    n = valid.shape[0]
    dev = valid.device

    cell_id = ravel_cells(geom, cell_of(geom, attrs[POS], origin, owned))
    n_cells = math.prod(shape)
    # Invalid agents sort to a sentinel bucket past the last cell.
    key = torch.where(valid, cell_id, cell_id.new_tensor(n_cells))
    sorted_key, order = torch.sort(key, stable=True)

    # Rank of each agent within its cell run: distance to the run start,
    # found with a running maximum of the start indices.
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_start = torch.ones_like(sorted_key, dtype=torch.bool)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    start_idx = running_max(torch.where(is_start, idx, idx.new_tensor(-1)))
    rank = idx - start_idx

    live = sorted_key < n_cells
    ok = live & (rank < cap)
    dropped = (live & (rank >= cap)).sum(dtype=torch.int32)
    total = n_cells * cap
    slot = torch.where(ok, sorted_key * cap + rank,
                       sorted_key.new_tensor(total)).long()  # sentinel slot

    # Every live slot index is unique; only the sentinel row at ``total``
    # receives duplicate writes.  index_put_ leaves the order of duplicate
    # writes undefined on CUDA, which is harmless because that row is
    # sliced off (the reference's .at[slot].set has the same contract).
    out_attrs = {}
    for name, a in attrs.items():
        tgt = torch.zeros((total + 1,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=dev)
        tgt[slot] = a[order]
        out_attrs[name] = tgt[:total].reshape(
            shape + (cap,) + tuple(a.shape[1:]))
    v = torch.zeros((total + 1,), dtype=torch.bool, device=dev)
    v[slot] = ok
    soa = AgentSoA(attrs=out_attrs, valid=v[:total].reshape(shape + (cap,)))
    return soa, dropped


def rebin(geom: Domain, soa: AgentSoA, origin: torch.Tensor
          ) -> Tuple[AgentSoA, torch.Tensor]:
    attrs, valid = flat_view(soa)
    return bin_agents(geom, attrs, valid, origin)


def interior_mask(geom: Domain) -> np.ndarray:
    m = np.zeros(geom.local_shape, dtype=bool)
    m[(slice(1, -1),) * geom.ndim] = True
    return m


def owned_mask(geom: Domain, owned, device=None) -> torch.Tensor:
    """Boolean ``local_shape`` mask of a device's owned cells under uneven
    ownership: local cells ``[1, owned[a]]`` per axis.  Ring cells (0 and
    ``owned[a] + 1``) and the padding beyond the ring are False."""
    m = torch.zeros(geom.local_shape, dtype=torch.bool, device=device)
    m[tuple(slice(1, int(w) + 1) for w in owned)] = True
    return m


def mesh_owned_mask(geom: Domain, device=None) -> torch.Tensor:
    """:func:`owned_mask` of every device of the mesh, ``mesh_shape +
    local_shape``."""
    return torch.stack([owned_mask(geom, geom.owned_widths(c), device)
                        for c in np.ndindex(*geom.mesh_shape)]
                       ).reshape(geom.mesh_shape + geom.local_shape)


def mask_unowned(soa: AgentSoA, geom: Domain, owned=None, lead: int = 0,
                 mask: torch.Tensor = None) -> AgentSoA:
    """Uneven-ownership analogue of :func:`clear_ring`: invalidate every
    slot outside the owned region - the aura ring at 0 and ``owned[a] + 1``
    and the padding cells beyond it, which never hold agents.  ``owned``
    is one device's widths (``lead`` 0); a mesh-layout SoA (``lead`` =
    ndim leading mesh dims) takes each device's from ``geom``.  ``mask``
    is that region when the caller keeps it (:func:`owned_mask` /
    :func:`mesh_owned_mask`).  Returns a new ``valid``; the input SoA is
    untouched."""
    if mask is None:
        mask = owned_mask(geom, owned, soa.valid.device) if lead == 0 \
            else mesh_owned_mask(geom, soa.valid.device)
    return soa.replace(valid=soa.valid & mask[..., None])


def ring_index(axis: int, index, lead: int = 0) -> Tuple:
    """Indexing tuple selecting one cell-hyperplane along a grid axis,
    behind ``lead`` leading device-mesh dims."""
    return (slice(None),) * (lead + axis) + (index,)


def plane_index(index):
    """A plane index as :func:`take_plane` takes it: an int, or one int a
    device along a mesh axis, folded to an int where they agree."""
    if isinstance(index, (int, np.integer)):
        return int(index)
    index = tuple(int(i) for i in index)
    return index[0] if len(set(index)) == 1 else index


def take_plane(t: torch.Tensor, axis: int, index, lead: int = 0,
               mesh_axis: int = None) -> torch.Tensor:
    """``t[ring_index(axis, index, lead)]``: one cell-hyperplane along grid
    axis ``axis``.  ``index`` is an int, or (on a mesh-layout tensor) one
    int a device along mesh axis ``mesh_axis`` (default ``axis``): an
    uneven partition's owned extents, which a rectilinear cut varies along
    that axis only.  A view for an int index, a new tensor otherwise."""
    index = plane_index(index)
    if isinstance(index, int):
        return t[ring_index(axis, index, lead)]
    ma = axis if mesh_axis is None else mesh_axis
    return torch.cat([t.narrow(ma, i, 1)[ring_index(axis, j, lead)]
                      for i, j in enumerate(index)], dim=ma)


def set_plane(t: torch.Tensor, axis: int, index, value, lead: int = 0,
              mesh_axis: int = None) -> None:
    """``t[ring_index(axis, index, lead)] = value`` in place, ``index`` as
    :func:`take_plane` takes it (``value`` a tensor shaped like that plane,
    or a scalar)."""
    index = plane_index(index)
    if isinstance(index, int):
        t[ring_index(axis, index, lead)] = value
        return
    ma = axis if mesh_axis is None else mesh_axis
    for i, j in enumerate(index):
        v = value.narrow(ma, i, 1) if isinstance(value, torch.Tensor) \
            else value
        t.narrow(ma, i, 1)[ring_index(axis, j, lead)] = v


def clear_ring(soa: AgentSoA, lead: int = 0) -> AgentSoA:
    """Invalidate all halo-ring slots (the aura is rebuilt from scratch
    each iteration, paper section 2.2.1) of every device (``lead`` leading
    mesh dims).  Returns a new ``valid``; the input SoA is untouched."""
    v = soa.valid.clone()
    for axis in range(v.dim() - 1 - lead):   # grid axes; last is the slot
        v[ring_index(axis, 0, lead)] = False
        v[ring_index(axis, -1, lead)] = False
    return soa.replace(valid=v)
