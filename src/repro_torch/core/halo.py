"""Aura (halo) exchange, N-dimensional (port of ``repro/core/halo.py``).

The exchange is dimension-ordered over the Domain's axes (``2 * ndim``
directed edges): axis-0 slabs first, then axis-1 slabs that include the
freshly filled axis-0 ring cells, which propagates corner neighbours in at
most ``ndim`` hops.  This slice ports the single-device ``LocalComm`` and
the full-refresh payload; ``ShardComm`` and the delta codec wait for the
multi-device slice (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.agent_soa import AgentSoA
from repro_torch.core.delta import (
    DeltaConfig,
    Slab,
    decode_full,
    encode_full,
    payload_bytes,
)
from repro_torch.core.domain import AXIS_CHARS, Domain
from repro_torch.core.grid import ring_index


class Comm:
    """Spatial communication abstraction over an N-D device mesh."""

    def shift(self, tree: Slab, axis: int, direction: int) -> Slab:
        """Move data one step along a mesh axis; devices with no source get
        zeros (closed boundary) or wrap (toroidal)."""
        raise NotImplementedError

    def coords(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def linear_rank(self) -> int:
        raise NotImplementedError

    def sum_over_all_ranks(self, x):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LocalComm(Comm):
    """Single-device comm: an all-ones mesh."""

    toroidal: Tuple[bool, ...]

    def shift(self, tree: Slab, axis: int, direction: int) -> Slab:
        if self.toroidal[axis]:
            return tree
        return {k: torch.zeros_like(v) for k, v in tree.items()}

    def coords(self) -> Tuple[int, ...]:
        return tuple(0 for _ in self.toroidal)

    def linear_rank(self) -> int:
        return 0

    def sum_over_all_ranks(self, x):
        return x


# ---------------------------------------------------------------------------
# Slab extraction / insertion
# ---------------------------------------------------------------------------

def take_slab(soa: AgentSoA, axis: int, index: int) -> Slab:
    """Copy one cell-hyperplane (incl. valid mask) out as an exchange slab.

    A copy, not a view: slabs are kept as delta references and must not
    change when the SoA's ring is written later in the same exchange."""
    idx = ring_index(axis, index)
    slab = {name: a[idx].clone() for name, a in soa.attrs.items()}
    slab["valid"] = soa.valid[idx].clone()
    return slab


def put_slab(soa: AgentSoA, axis: int, index: int, slab: Slab) -> AgentSoA:
    """Write ``slab`` into one hyperplane of ``soa`` **in place** (the
    reference returns a new SoA; the in-place write saves a full SoA copy
    per edge).  Returns ``soa``."""
    idx = ring_index(axis, index)
    for name, a in soa.attrs.items():
        a[idx] = slab[name]
    soa.valid[idx] = slab["valid"]
    return soa


def dirs_for(ndim: int) -> Dict[str, Tuple[int, int]]:
    """Directed edges for delta references: ``2 * ndim`` (axis, direction)
    pairs keyed ``"xm"/"xp"/"ym"/"yp"[/"zm"/"zp"]``."""
    out: Dict[str, Tuple[int, int]] = {}
    for axis in range(ndim):
        c = AXIS_CHARS[axis]
        out[c + "m"] = (axis, -1)
        out[c + "p"] = (axis, +1)
    return out


def halo_exchange(
    geom: Domain,
    soa: AgentSoA,
    comm: Comm,
    refs: Dict[str, Slab],
    cfg: DeltaConfig,
    full: bool,
) -> Tuple[AgentSoA, Dict[str, Slab], int, int]:
    """Rebuild the aura ring from neighbour devices' boundary cells.

    Returns (soa with ring filled, updated references, wire bytes, codec
    overflow count).  The ring is written into a copy of ``soa``; the
    caller's tensors are not modified.  Only the full-refresh payload is
    ported (``cfg.enabled`` cannot be set in this slice, see
    :class:`DeltaConfig`), so ``full`` changes nothing yet and the
    overflow count is always 0.  ``refs[d + "_out"]`` / ``refs[d + "_in"]``
    end up holding the slabs sent / received along each directed edge,
    as in the reference.
    """
    shape = geom.local_shape
    new_refs = dict(refs)
    nbytes = 0
    soa = AgentSoA(attrs={k: v.clone() for k, v in soa.attrs.items()},
                   valid=soa.valid.clone())

    def _exchange(soa, axis, src_index, dst_index, direction, out_key,
                  in_key):
        slab = take_slab(soa, axis, src_index)
        payload, new_refs[out_key] = encode_full(slab)
        recv = comm.shift(payload, axis, direction)
        recon, new_refs[in_key] = decode_full(recv)
        return put_slab(soa, axis, dst_index, recon), payload_bytes(payload)

    for axis in range(geom.ndim):
        h = shape[axis]
        c = AXIS_CHARS[axis]
        # my high face -> +axis neighbour's low ring, and vice versa
        soa, b = _exchange(soa, axis, h - 2, 0, +1, c + "p_out", c + "m_in")
        nbytes += b
        soa, b = _exchange(soa, axis, 1, h - 1, -1, c + "m_out", c + "p_in")
        nbytes += b
    return soa, new_refs, nbytes, 0


def init_refs(geom: Domain, soa: AgentSoA) -> Dict[str, Slab]:
    """Zero-valued reference slabs for all ``4 * ndim`` directed-edge refs;
    the slab for an edge along ``axis`` is shaped like that axis's face."""
    refs: Dict[str, Slab] = {}
    for d, (axis, _) in dirs_for(geom.ndim).items():
        proto = take_slab(soa, axis, 0)
        zeros = {k: torch.zeros_like(v) for k, v in proto.items()}
        refs[d + "_out"] = dict(zeros)
        refs[d + "_in"] = dict(zeros)
    return refs
