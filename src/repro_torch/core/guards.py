"""Runtime health guards (port of ``repro/core/guards.py``): cheap
invariants computed inside the step and accumulated into the
``SimState.health`` word, one cumulative int32 counter a guard and a
device, read by the drivers at their host control points.

Guard catalogue (indices into the health word):

* ``nan_inf`` - live slots with a non-finite value in a float attribute,
  counted right after the aura exchange (the received ring included, so a
  corrupted halo receive is caught before the sweep reads it).
* ``out_of_domain`` - live *owned* agents whose position lies outside the
  global domain ``[0, L)`` on any axis, at step entry.
* ``out_of_slab`` - live owned agents outside their device's owned slab,
  at step entry: ``(pos - origin) / cell_size`` outside ``[0, w)`` on an
  axis, the coordinate the binning computes.
* ``conservation`` - ``|pre - post - lost|`` over the whole mesh for one
  step: live agents entering re-binning (spawns included) against owned
  agents after migration plus the step's capacity drops.  A global,
  replicated on every device.
* ``gid_duplicate`` - pairs of live slots sharing a ``(gid_rank,
  gid_count)`` identity, counted at the control points by
  :func:`check_health` (not in the step): one device sort of the live
  keys, and on a process mesh the keys routed to a rank by hash first.

Every reduction here is plain PyTorch on the state's tensors: the guards
are XLA reductions in the reference too, and none of them is a kernel.
The per-step ones read the live slots only (one nonzero of ``valid``,
then gathers), not every slot as the reference's masked reductions do:
the same counts.  ``policy="off"`` (the default) skips them all: the step launches what an
unguarded step launches and gives bit-equal results.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.agent_soa import AgentSoA, GID_COUNT, GID_RANK, POS

GUARD_NAN = 0
GUARD_DOMAIN = 1
GUARD_SLAB = 2
GUARD_CONSERVATION = 3
GUARD_GID_DUP = 4
NUM_GUARDS = 5

GUARD_NAMES: Tuple[str, ...] = (
    "nan_inf", "out_of_domain", "out_of_slab", "conservation",
    "gid_duplicate",
)

_POLICIES = ("off", "warn", "error")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Which invariants the step computes, and what a trip does: ``"off"``
    computes none, ``"warn"`` warns at the control point, ``"error"``
    raises :class:`HealthError` there (what a supervised run rolls back
    on)."""

    policy: str = "off"
    nan: bool = True
    domain: bool = True
    slab: bool = True
    conservation: bool = True
    gid_unique: bool = True

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(
                f"guard policy {self.policy!r} not in {_POLICIES}")

    @property
    def enabled(self) -> bool:
        return self.policy != "off"


def as_guard_config(guards) -> GuardConfig:
    """Normalize the facade shorthand: None -> off, str -> policy."""
    if guards is None:
        return GuardConfig()
    if isinstance(guards, str):
        return GuardConfig(policy=guards)
    if isinstance(guards, GuardConfig):
        return guards
    raise TypeError(
        f"guards must be a GuardConfig, a policy string or None, "
        f"got {type(guards).__name__}")


# ---------------------------------------------------------------------------
# Per-device reductions (called from the engine's step)
# ---------------------------------------------------------------------------

def _live_slots(valid: torch.Tensor, lead: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat indices of the live slots of a mesh-layout ``valid`` (one
    nonzero), and the linear index of each one's device among the
    ``lead`` leading mesh dims.  The guards read only these: 16.8M of the
    main path's 201M slots."""
    flat = valid.reshape(-1)
    idx = torch.nonzero(flat).reshape(-1)
    per_device = flat.numel() // max(math.prod(valid.shape[:lead]), 1)
    return idx, idx // per_device


def _per_device(dev: torch.Tensor, bad: torch.Tensor,
                lead_shape: Tuple[int, ...]) -> torch.Tensor:
    """How many of the live slots on each device are ``bad`` (int32,
    shaped like the mesh).  ``dev`` is sorted (the slots come in mesh
    order), so a running sum read at each device's last slot gives the
    counts with no atomic adds: an ``index_add_`` of 16.8M ones into one
    to four counters took 12 ms on an H100."""
    n = math.prod(lead_shape)
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=bad.device),
                     torch.cumsum(bad, 0, dtype=torch.int64)])
    ends = cum[torch.searchsorted(
        dev, torch.arange(n, dtype=dev.dtype, device=dev.device),
        right=True)]
    return torch.diff(ends, prepend=ends.new_zeros(1)).to(
        torch.int32).reshape(lead_shape)


def nan_count(soa: AgentSoA, lead: int) -> torch.Tensor:
    """Live slots carrying a non-finite value in any float attribute (a
    slot counts once an attribute), per device of the ``lead`` leading
    mesh dims."""
    v = soa.valid
    lead_shape = tuple(v.shape[:lead])
    idx, dev = _live_slots(v, lead)
    total = torch.zeros(lead_shape, dtype=torch.int32, device=v.device)
    for arr in soa.attrs.values():
        if not torch.is_floating_point(arr):
            continue
        a = arr.reshape(v.numel(), -1)[idx]
        total += _per_device(dev, ~torch.isfinite(a).all(-1), lead_shape)
    return total


def residency_counts(geom, soa: AgentSoA, origins: torch.Tensor,
                     widths: torch.Tensor, own_cells: torch.Tensor,
                     lead: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out_of_domain, out_of_slab)`` counts over live owned agents, per
    device.  ``origins`` and ``widths`` (cells) are each device's owned
    region, ``lead + (ndim,)``; ``own_cells`` its owned cells (a
    ``local_shape`` mask, or ``lead + local_shape``).  The slab test is
    the binning's coordinate ``(pos - origin) / cell_size`` in ``[0, w)``
    per axis; a NaN position fails both tests (and the NaN guard too)."""
    nd = geom.ndim
    v = soa.valid
    lead_shape = tuple(v.shape[:lead])
    idx, dev = _live_slots(v, lead)
    cell = idx // geom.cap            # its cell, with the lead dims
    if own_cells.dim() == nd:         # one local mask for every device
        cell = cell % math.prod(geom.local_shape)
    own = own_cells.reshape(-1)[cell]
    pos = soa.attrs[POS].reshape(v.numel(), nd)[idx]
    lsz = torch.tensor(geom.domain_size, dtype=torch.float32,
                       device=v.device)
    in_dom = ((pos >= 0.0) & (pos < lsz)).all(-1)
    cs = torch.tensor(geom.cell_size, dtype=torch.float32, device=v.device)
    rel = (pos - origins.reshape(-1, nd)[dev]) / cs
    w = widths.reshape(-1, nd)[dev].to(torch.float32)
    in_slab = ((rel >= 0.0) & (rel < w)).all(-1)
    return (_per_device(dev, own & ~in_dom, lead_shape),
            _per_device(dev, own & ~in_slab, lead_shape))


def gid_duplicate_count(state, comm=None) -> int:
    """Pairs of live slots sharing a ``(gid_rank, gid_count)`` identity
    over the whole mesh (a triple counts 2, as the reference's adjacent
    pairs after its ``lexsort``): one sort of the int64 keys
    ``gid_rank << 32 | gid_count`` on the state's device and an
    adjacent-equal count.  With a process mesh's ``comm`` each key goes
    first to the rank ``key mod world`` of the mesh's group (one
    ``all_to_all_single``), so equal keys of two ranks meet, and the
    counts are summed."""
    v = state.soa.valid.reshape(-1)
    r = state.soa.attrs[GID_RANK].reshape(-1)[v].to(torch.int64)
    c = state.soa.attrs[GID_COUNT].reshape(-1)[v].to(torch.int64)
    key = (r << 32) | (c & 0xFFFFFFFF)
    if comm is not None:
        import torch.distributed as dist

        from repro_torch.core.reshard import _to_all
        world = dist.get_world_size(comm.group)
        key = _to_all({"key": key}, key % world, world, comm.group)["key"]
    key = torch.sort(key).values
    n = (key[1:] == key[:-1]).sum()
    if comm is not None:
        n = comm.sum_over_all_ranks(n)
    return int(n)


# ---------------------------------------------------------------------------
# Host-side surfacing (drivers, at their control points)
# ---------------------------------------------------------------------------

def health_counts(state, comm=None) -> np.ndarray:
    """Cumulative per-guard counts over the mesh (int64): the per-device
    words summed, the conservation word (a replicated global) their max;
    with a process mesh's ``comm``, over every rank."""
    h = state.health.reshape(-1, NUM_GUARDS).to(torch.int64)
    out = h.sum(0)
    cons = h[:, GUARD_CONSERVATION].max() if h.shape[0] \
        else torch.zeros((), dtype=torch.int64, device=h.device)
    if comm is not None:
        out = comm.sum_over_all_ranks(out)
        cons = comm.max_over_all_ranks(cons)
    out = out.cpu().numpy()
    out[GUARD_CONSERVATION] = int(cons)
    return out


@dataclasses.dataclass
class HealthReport:
    """One host-side health reading: cumulative counts plus the delta
    since the previous mark (what tripped *now*)."""

    counts: np.ndarray       # (NUM_GUARDS,) cumulative
    new: np.ndarray          # (NUM_GUARDS,) since the last mark
    iteration: int
    policy: str

    @property
    def tripped(self):
        return [(GUARD_NAMES[i], int(self.new[i]))
                for i in range(NUM_GUARDS) if self.new[i] > 0]

    @property
    def ok(self) -> bool:
        return not self.tripped

    def format(self) -> str:
        if self.ok:
            return f"health@it={self.iteration}: ok"
        parts = ", ".join(f"{n}=+{c}" for n, c in self.tripped)
        return (f"health@it={self.iteration}: guard trip ({parts}; "
                f"cumulative {dict(zip(GUARD_NAMES, self.counts.tolist()))})")


class HealthError(RuntimeError):
    """A runtime guard tripped under ``policy="error"``; carries the
    :class:`HealthReport`.  The supervisor rolls back on it."""

    def __init__(self, report: HealthReport):
        self.report = report
        super().__init__(report.format())


def check_health(guards: GuardConfig, state, mark: np.ndarray,
                 iteration: Optional[int] = None, comm=None
                 ) -> Tuple[np.ndarray, Optional[HealthReport]]:
    """Read the health word against ``mark``; warn or raise per policy.
    Returns ``(new_mark, report)``, the report None when nothing tripped.
    A count *below* the mark means the counters were reset (a re-shard or
    a restore): the mark follows it down without a report.  With a
    process mesh's ``comm`` the reading is global, so every rank raises
    or warns alike."""
    counts = health_counts(state, comm)
    new = np.where(counts >= mark, counts - mark, counts)
    mark = counts.copy()
    if guards.gid_unique:
        # the current state's duplicates: a persisting one re-reports at
        # every control point
        dups = gid_duplicate_count(state, comm)
        new[GUARD_GID_DUP] += dups
        counts[GUARD_GID_DUP] += dups
    if not new.any():
        return mark, None
    if iteration is not None:
        it = iteration
    else:
        it = state.it.max()
        it = int(it if comm is None else comm.max_over_all_ranks(it))
    report = HealthReport(counts=counts, new=new, iteration=it,
                          policy=guards.policy)
    if guards.policy == "error":
        raise HealthError(report)
    warnings.warn(f"runtime guard: {report.format()}", stacklevel=3)
    return mark, report
