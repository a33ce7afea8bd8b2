"""Load balancing (paper section 2.4.5): global RCB and diffusive planners
(port of ``repro/core/load_balance.py``, near verbatim: plain numpy).

The planners run on the host over the small per-box occupancy histogram
and emit an ownership plan; the engine re-initialises from the flattened
agent state (``core.reshard``).  The paper notes that global RCB "might
lead to a new partitioning that differs substantially ... causing mass
migrations" (section 2.4.5): that cost is paid once per re-shard, and the
same path restores a checkpoint onto another device count
(``distributed.elastic``).

Three planners:

* ``plan_rcb``     - recursive coordinate bisection over the weighted
                     occupancy histogram (Zoltan2-RCB analogue); its
                     hierarchical cuts are a report-only bound.
* ``plan_rectilinear`` - the realizable uneven planner: per-axis cut
                     positions shared across the mesh (marginal-quantile
                     init + exact per-axis DP refinement), the structure
                     ``core.domain.Partition`` holds.
* ``plan_diffusive`` - neighbouring partitions exchange boundary box
                     columns; partitions slower than the local average
                     cede boxes to faster neighbours.

``choose_partition(weights, n, ownership="equal"|"rcb")`` scans every mesh
factorization of the device count with the matching planner and returns
the best realizable plan; ``choose_mesh_shape`` survives as a
DeprecationWarning shim over it.  Plans, tie-breaks and ``imbalance``
floats are the reference's.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.domain import Partition


def imbalance(loads: np.ndarray) -> float:
    """max/mean - 1; 0 is perfect balance."""
    m = float(np.mean(loads))
    if m <= 0:
        return 0.0
    return float(np.max(loads)) / m - 1.0


def device_loads(ownership: np.ndarray, weights: np.ndarray,
                 n_devices: int) -> np.ndarray:
    loads = np.zeros((n_devices,), dtype=np.float64)
    np.add.at(loads, ownership.ravel(), weights.ravel())
    return loads


# ---------------------------------------------------------------------------
# Global: recursive coordinate bisection (RCB)
# ---------------------------------------------------------------------------

def plan_rcb(weights: np.ndarray, n_devices: int) -> np.ndarray:
    """Partition an N-D weight histogram into ``n_devices`` contiguous
    hyper-rectangles by recursive coordinate bisection.

    Args:
      weights: per-partitioning-box weight over the Domain's box grid
        (agent count, optionally scaled by last-iteration runtime, as in
        the paper) — 2-D or 3-D.
      n_devices: number of devices; must be a power of two.

    Returns:
      ownership: int32 box -> device map, same shape as ``weights``.
    """
    if n_devices & (n_devices - 1):
        raise ValueError("RCB requires a power-of-two device count")
    nd = weights.ndim
    ownership = np.zeros(weights.shape, dtype=np.int32)

    def split(bounds, dev0, ndev):
        region = tuple(slice(lo, hi) for lo, hi in bounds)
        if ndev == 1:
            ownership[region] = dev0
            return
        lens = [hi - lo for lo, hi in bounds]
        # Bisect the longest axis (ties -> lowest axis) at the weighted
        # median.
        ax = int(np.argmax(lens))
        w = weights[region]
        prof = w.sum(axis=tuple(a for a in range(nd) if a != ax))
        half = prof.sum() / 2.0
        cut = int(np.searchsorted(np.cumsum(prof), half)) + 1
        cut = max(1, min(lens[ax] - 1, cut))
        lo, hi = bounds[ax]
        b1 = list(bounds)
        b1[ax] = (lo, lo + cut)
        b2 = list(bounds)
        b2[ax] = (lo + cut, hi)
        split(tuple(b1), dev0, ndev // 2)
        split(tuple(b2), dev0 + ndev // 2, ndev // 2)

    split(tuple((0, s) for s in weights.shape), 0, n_devices)
    return ownership


# ---------------------------------------------------------------------------
# Diffusive: neighbor column exchange
# ---------------------------------------------------------------------------

def plan_diffusive(
    widths: np.ndarray, col_weights: np.ndarray, runtimes: np.ndarray
) -> np.ndarray:
    """One diffusive step over a 1D chain of partitions owning contiguous
    box-column ranges (paper: "ranks whose runtime exceeds the local average
    send boxes to neighbors that were faster").

    Args:
      widths: (D,) number of box columns owned by each device (sum = BX).
      col_weights: (BX,) weight per box column.
      runtimes: (D,) last-iteration runtime per device.

    Returns:
      new widths (D,), each >= 1, sum preserved.
    """
    d = len(widths)
    widths = widths.astype(np.int64).copy()
    for i in range(d - 1):
        pair_avg = (runtimes[i] + runtimes[i + 1]) / 2.0
        if runtimes[i] > pair_avg and widths[i] > 1:
            widths[i] -= 1
            widths[i + 1] += 1
        elif runtimes[i + 1] > pair_avg and widths[i + 1] > 1:
            widths[i + 1] -= 1
            widths[i] += 1
    return widths


def widths_to_ownership(widths: np.ndarray) -> np.ndarray:
    """(D,) column widths -> (BX,) column -> device map."""
    out = np.zeros((int(np.sum(widths)),), dtype=np.int32)
    x = 0
    for dev, w in enumerate(widths):
        out[x:x + int(w)] = dev
        x += int(w)
    return out


def equal_split_loads(weights: np.ndarray,
                      mesh_shape: Tuple[int, ...]) -> np.ndarray:
    """Per-device loads of the engine's equal-split partition: the device at
    mesh coordinate ``c`` owns the equal block of boxes at block-index
    ``c`` along every axis."""
    mesh = tuple(mesh_shape)
    if weights.ndim != len(mesh):
        raise ValueError(
            f"mesh {mesh} has {len(mesh)} axes for a {weights.ndim}-D "
            "box grid")
    if any(b % m for b, m in zip(weights.shape, mesh)):
        raise ValueError(
            f"mesh {mesh} does not divide the box grid {weights.shape}")
    shape: Tuple[int, ...] = ()
    for b, m in zip(weights.shape, mesh):
        shape += (m, b // m)
    return weights.reshape(shape).sum(
        axis=tuple(range(1, 2 * len(mesh), 2))).ravel()


# ---------------------------------------------------------------------------
# Rectilinear (box-granular uneven) partitions — the realizable RCB analogue
# ---------------------------------------------------------------------------

def partition_loads(weights: np.ndarray, partition: Partition) -> np.ndarray:
    """Per-device loads of a rectilinear :class:`Partition` whose cuts are
    expressed in the units of ``weights``' grid (boxes); device order is
    row-major over the partition's mesh."""
    w = np.asarray(weights, np.float64)
    if partition.global_cells != w.shape:
        raise ValueError(
            f"partition covers {partition.global_cells} boxes; the "
            f"histogram has {w.shape}")
    for a in range(w.ndim):
        w = np.add.reduceat(w, partition.cuts[a][:-1], axis=a)
    return w.ravel()


def _axis_profiles(weights: np.ndarray, cuts, axis: int) -> np.ndarray:
    """Collapse every axis except ``axis`` onto its current cut blocks:
    returns (X, J) where X is the axis length and J the flattened
    other-axis block index."""
    w = np.asarray(weights, np.float64)
    for b in range(w.ndim):
        if b != axis:
            w = np.add.reduceat(w, cuts[b][:-1], axis=b)
    w = np.moveaxis(w, axis, 0)
    return w.reshape(w.shape[0], -1)


def _best_axis_cuts(col: np.ndarray, m: int) -> Tuple[Tuple[int, ...], float]:
    """Optimal contiguous partition of the rows of ``col`` (X, J) into
    ``m`` non-empty parts minimizing the max over (part, j) of the part's
    column sum — the exact 1-D subproblem of rectilinear partitioning
    (each j is one fixed other-axis block; a part's worst column is the
    load of its worst device in that axis row)."""
    x = col.shape[0]
    if m > x:
        raise ValueError(f"{m} parts over {x} boxes")
    pref = np.concatenate(
        [np.zeros((1, col.shape[1])), np.cumsum(col, axis=0)])
    # L[lo, hi] = max_j sum of rows [lo, hi)
    L = np.max(pref[None, :, :] - pref[:, None, :], axis=2)
    inf = float("inf")
    dp = np.full((m + 1, x + 1), inf)
    arg = np.zeros((m + 1, x + 1), np.int64)
    dp[0, 0] = 0.0
    for k in range(1, m + 1):
        for i in range(k, x - (m - k) + 1):
            lo = k - 1
            cand = np.maximum(dp[k - 1, lo:i], L[lo:i, i])
            j = int(np.argmin(cand))
            dp[k, i] = cand[j]
            arg[k, i] = lo + j
    cuts = [x]
    i = x
    for k in range(m, 0, -1):
        i = int(arg[k, i])
        cuts.append(i)
    return tuple(reversed(cuts)), float(dp[m, x])


def _quantile_cuts(marginal: np.ndarray, m: int) -> Tuple[int, ...]:
    """Initial per-axis cuts at the weighted quantiles of a marginal, with
    every slab at least one box wide."""
    x = len(marginal)
    cs = np.cumsum(np.asarray(marginal, np.float64))
    total = cs[-1]
    cuts = [0]
    for k in range(1, m):
        c = int(np.searchsorted(cs, total * k / m, side="left")) + 1
        c = max(cuts[-1] + 1, min(c, x - (m - k)))
        cuts.append(c)
    cuts.append(x)
    return tuple(cuts)


def plan_rectilinear(weights: np.ndarray, mesh_shape: Tuple[int, ...],
                     sweeps: int = 4) -> Partition:
    """Rectilinear uneven partition over a weight histogram: per-axis cut
    positions shared across the whole mesh (the structure a masked
    halo exchange can realize; Nicol-style alternating
    refinement).

    Cuts start at the per-axis weighted marginal quantiles, then each axis
    is re-cut *optimally* (exact DP over contiguous box ranges) holding the
    other axes fixed, cycling until a sweep stops improving.  This is the
    realizable counterpart of :func:`plan_rcb`'s hierarchical bisection —
    for clustered densities whose mass separates along one axis, or
    symmetric blobs, the refined cuts reach the RCB bound; a strictly
    non-rectilinear RCB optimum cannot be realized on a tensor mesh.
    """
    w = np.asarray(weights, np.float64)
    mesh = tuple(int(m) for m in mesh_shape)
    if len(mesh) != w.ndim:
        raise ValueError(f"mesh {mesh} has {len(mesh)} axes for a "
                         f"{w.ndim}-D histogram")
    if any(m > s for m, s in zip(mesh, w.shape)):
        raise ValueError(f"mesh {mesh} exceeds the box grid {w.shape}")
    cuts = [
        _quantile_cuts(
            w.sum(axis=tuple(b for b in range(w.ndim) if b != a)), mesh[a])
        for a in range(w.ndim)
    ]

    def score(cs):
        return imbalance(partition_loads(w, Partition(cuts=tuple(cs))))

    best = score(cuts)
    for _ in range(max(int(sweeps), 1)):
        improved = False
        for a in range(w.ndim):
            new_a, _ = _best_axis_cuts(_axis_profiles(w, cuts, a), mesh[a])
            if new_a != cuts[a]:
                trial = list(cuts)
                trial[a] = new_a
                s = score(trial)
                if s < best - 1e-12:
                    cuts, best, improved = trial, s, True
        if not improved:
            break
    return Partition(cuts=tuple(cuts))


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """One realizable ownership plan over a box histogram."""

    mesh_shape: Tuple[int, ...]
    partition: Partition         # cuts in box units (the histogram's grid)
    imbalance: float


def choose_partition(weights: np.ndarray, n_devices: int,
                     ownership: str = "rcb") -> PartitionPlan:
    """Pick the best realizable ownership plan for ``n_devices`` over a
    weight histogram — the partition-aware successor of the deprecated
    :func:`choose_mesh_shape`.

    ``ownership="equal"`` reproduces the historical equal-split scan
    exactly (same factorization order, same score, same tie-break);
    ``ownership="rcb"`` additionally cuts every factorization with
    :func:`plan_rectilinear`, realizing box-granular uneven ownership —
    the live analogue of the ``plan_rcb`` bound.  Returns the plan with
    cuts in **box units** (scale by ``Domain.box_factor`` for cell cuts).
    """
    if ownership not in ("equal", "rcb"):
        raise ValueError(
            f"unknown ownership {ownership!r}; expected 'equal' or 'rcb'")
    best: Optional[PartitionPlan] = None
    for mesh in _factorizations(n_devices, weights.ndim):
        if ownership == "equal":
            if not all(b % m == 0 for b, m in zip(weights.shape, mesh)):
                continue
            part = Partition.equal(weights.shape, mesh)
            score = imbalance(equal_split_loads(weights, mesh))
        else:
            if any(m > b for m, b in zip(mesh, weights.shape)):
                continue
            part = plan_rectilinear(weights, mesh)
            score = imbalance(partition_loads(weights, part))
        if best is None or score < best.imbalance:
            best = PartitionPlan(mesh_shape=mesh, partition=part,
                                 imbalance=score)
    if best is None:
        raise ValueError("no valid mesh factorization divides the histogram")
    return best


def _factorizations(n: int, ndim: int):
    """All ordered ``ndim``-tuples of positive ints with product ``n``,
    lexicographically ascending."""
    if ndim == 1:
        yield (n,)
        return
    for m in range(1, n + 1):
        if n % m == 0:
            for rest in _factorizations(n // m, ndim - 1):
                yield (m,) + rest


def choose_mesh_shape(weights: np.ndarray,
                      n_devices: int) -> Tuple[int, ...]:
    """DEPRECATED equal-split-only mesh picker: scan the divisor
    factorizations of ``n_devices`` (not just powers of two, so degraded
    counts like 3 or 6 factorize too) for the least equal-split imbalance;
    ties break toward smaller earlier axes.

    Use :func:`choose_partition` — it runs the identical scan for
    ``ownership="equal"`` (shim-parity is pinned by tests) and also cuts
    box-granular uneven partitions for ``ownership="rcb"``."""
    warnings.warn(
        "choose_mesh_shape is deprecated — use choose_partition(weights, "
        "n_devices, ownership='equal').mesh_shape, which also plans "
        "box-granular uneven ownership with ownership='rcb'",
        DeprecationWarning, stacklevel=2)
    return choose_partition(weights, n_devices,
                            ownership="equal").mesh_shape
