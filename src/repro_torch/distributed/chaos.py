"""Deterministic fault injection (port of ``repro/distributed/chaos.py``):
every recovery path of the resilience stack (``core.guards`` +
``launch.supervise``) made a tested path.

* ``nan_attrs`` - NaN a seeded fraction of one attribute's live slots.
* ``halo_slab`` - NaN the live agents in one device's first owned layer
  along an axis: the slab the next aura exchange puts on the wire.
* ``device_loss`` - raise :class:`DeviceLost` from the driver's control
  point; the supervisor restores onto the survivors.
* ``torn_checkpoint`` - truncate the newest checkpoint's first array leaf
  after a save; the verified restore must skip it.
* ``raise`` - raise :class:`ChaosError` from the control point.

A :class:`FaultPlan` fires each fault **once**, at an absolute engine
iteration, from the drivers' control points (``Engine.drive`` and
``Simulation.run`` end their segments at pending fault steps), so a
replay after a rollback is clean.  All randomness derives from
``(plan.seed, fault index, step)``.

The slots a fault picks are the reference's, bit for bit: it draws them
from the live slots in its *folded* global layout ``(M0*h0, M1*h1, ...,
K)``, where the port's virtual mesh holds ``mesh + (h0, h1, ..., K)``.
:func:`_corrupt` walks the folded order by row chunks - one device's
innermost grid row, ``h_last * K`` slots, contiguous in both layouts -
from each device's live count a row, and maps every pick back to its
device and slot.  On a process mesh those counts are summed over the
ranks (every rank draws the same picks) and each rank pokes only its own
device's.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional, Set, Tuple

import numpy as np
import torch

FAULT_KINDS = ("nan_attrs", "halo_slab", "device_loss",
               "torn_checkpoint", "raise")


class ChaosError(RuntimeError):
    """An injected generic failure (``kind="raise"``)."""


class DeviceLost(RuntimeError):
    """An injected device/node loss.  ``survivors`` is the device count
    the run should degrade onto."""

    def __init__(self, survivors: int, message: str = ""):
        self.survivors = int(survivors)
        super().__init__(
            message or f"injected device loss: {survivors} device(s) "
                       "survive")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault at absolute iteration ``step`` (a corruption
    lands before that step runs).  ``frac`` (nan_attrs): the fraction of
    live slots to corrupt; ``attr``: the attribute (default positions);
    ``axis`` (halo_slab): the grid axis whose boundary layer is hit;
    ``survivors`` (device_loss): the surviving device count (default one
    less than the run's)."""

    step: int
    kind: str
    frac: float = 0.05
    attr: str = "pos"
    axis: int = 0
    survivors: Optional[int] = None
    note: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} not in {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step {self.step} must be >= 0")


@dataclasses.dataclass
class FaultPlan:
    """A seeded, fire-once schedule of faults.  Drivers call :meth:`fire`
    at every control point with the iteration about to run; the
    supervisor calls :meth:`maybe_tear` after each save.  ``fired`` is
    mutable bookkeeping: share one plan across a supervised run."""

    faults: Tuple[Fault, ...]
    seed: int = 0

    def __post_init__(self):
        self.faults = tuple(self.faults)
        self.fired: Set[int] = set()

    # -- scheduling ------------------------------------------------------
    def next_step(self, after: int) -> Optional[int]:
        """Smallest unfired state/raise fault step strictly after
        ``after`` (torn_checkpoint rides on saves, not on steps)."""
        steps = [f.step for i, f in enumerate(self.faults)
                 if i not in self.fired and f.kind != "torn_checkpoint"
                 and f.step > after]
        return min(steps) if steps else None

    def _due(self, it: int):
        return [(i, f) for i, f in enumerate(self.faults)
                if i not in self.fired and f.kind != "torn_checkpoint"
                and f.step == it]

    # -- firing ----------------------------------------------------------
    def fire(self, engine, state, it: int, comm=None):
        """Apply every unfired fault scheduled at iteration ``it``;
        ``comm`` is a process mesh's comm (None on the virtual mesh).
        Returns ``(state, corrupted)`` (the same on every rank); raising
        faults (device_loss, raise) propagate *after* any corruption at
        the same step is applied and marked fired."""
        due = self._due(it)
        if not due:
            return state, False
        corrupted = False
        pending_raise = None
        for idx, fault in due:
            self.fired.add(idx)
            if fault.kind == "raise":
                pending_raise = pending_raise or ChaosError(
                    f"injected failure at iteration {it}"
                    + (f" ({fault.note})" if fault.note else ""))
            elif fault.kind == "device_loss":
                n = fault.survivors if fault.survivors is not None \
                    else max(1, engine.geom.n_devices - 1)
                pending_raise = pending_raise or DeviceLost(n)
            else:
                rng = np.random.default_rng([self.seed, idx, it])
                state = _corrupt(engine, state, fault, rng, comm)
                corrupted = True
        if pending_raise is not None:
            raise pending_raise
        return state, corrupted

    def maybe_tear(self, ckpt_dir: str, it: int,
                   tear: bool = True) -> Optional[str]:
        """Tear the newest published checkpoint if a torn_checkpoint fault
        is due (``fault.step <= it``); returns the torn path, or None.
        Stays armed until a checkpoint exists.  With ``tear=False`` the
        due faults are marked fired and the path returned, nothing is
        truncated: the other ranks of a process mesh, whose rank 0
        tears."""
        due = [(i, f) for i, f in enumerate(self.faults)
               if i not in self.fired and f.kind == "torn_checkpoint"
               and f.step <= it]
        if not due:
            return None
        base = pathlib.Path(ckpt_dir)
        steps = sorted(p for p in base.glob("step_*") if p.is_dir()) \
            if base.exists() else []
        if not steps:
            return None
        target = steps[-1]
        if tear:
            leaves = sorted(target.glob("leaf_*.npy"))
            victim = leaves[0] if leaves else (target / "manifest.json")
            size = victim.stat().st_size
            with open(victim, "r+b") as fh:
                fh.truncate(max(size // 2, 1))
        for i, _ in due:
            self.fired.add(i)
        return str(target)


# ---------------------------------------------------------------------------
# State corruption, on the state's device
# ---------------------------------------------------------------------------

def _mine(comm, dev: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
    """The leading index of device ``dev``'s block in this process's
    state, or None when another rank holds it."""
    if comm is None:
        return tuple(dev)
    if tuple(comm.coords()) != tuple(dev):
        return None
    return (0,) * len(dev)


def _row_counts(geom, valid: torch.Tensor, comm) -> np.ndarray:
    """Live slots of every device's grid rows (all axes but the last),
    ``mesh_shape + local_shape[:-1]`` int64, on every rank."""
    nd = geom.ndim
    rows = valid.reshape(tuple(valid.shape[:nd + nd - 1]) + (-1,)).sum(
        -1, dtype=torch.int64).cpu()
    if comm is None:
        return rows.numpy()
    full = torch.zeros(geom.mesh_shape + geom.local_shape[:-1],
                       dtype=torch.int64)
    full[tuple(comm.coords())] = rows[(0,) * nd]
    return comm.sum_over_all_ranks(full).numpy()


def _pick_live(geom, valid: torch.Tensor, frac: float,
               rng: np.random.Generator, comm):
    """The reference's draw of ``nan_attrs``: ``max(1, round(frac * n))``
    of the ``n`` live slots, without replacement, from the live slots in
    the folded global order.  Returns ``{device: ordinals}``: each pick as
    its device's coordinates and its rank among that device's live slots
    in the device's own (row-major) order."""
    nd = geom.ndim
    counts = _row_counts(geom, valid, comm)
    # the folded order's chunks: (M0, h0, M1, h1, ..., M_{D-1}), each one
    # device's innermost row
    perm = [ax for a in range(nd - 1) for ax in (a, nd + a)] + [nd - 1]
    chunks = counts.transpose(perm)
    cshape = chunks.shape
    chunks = chunks.reshape(-1)
    total = int(chunks.sum())
    if total == 0:
        return {}
    k = max(1, int(round(frac * total)))
    picks = rng.choice(total, size=min(k, total), replace=False)
    ends = np.cumsum(chunks)
    j = np.searchsorted(ends, picks, side="right")
    within = picks - (ends[j] - chunks[j])
    idx = np.unravel_index(j, cshape)
    devs = np.stack([idx[2 * a] for a in range(nd)], axis=-1)
    rows = [idx[2 * a + 1] for a in range(nd - 1)]
    # each device's live slots before each of its rows, its own order
    before = np.concatenate(
        [np.zeros(counts.shape[:nd] + (1,), np.int64),
         np.cumsum(counts.reshape(counts.shape[:nd] + (-1,)), axis=-1)],
        axis=-1)
    row_lin = np.ravel_multi_index(rows, geom.local_shape[:-1]) \
        if nd > 1 else np.zeros_like(j)
    out = {}
    for p in range(picks.shape[0]):
        d = tuple(int(v) for v in devs[p])
        ordinal = int(before[d + (int(row_lin[p]),)] + within[p])
        out.setdefault(d, []).append(ordinal)
    return out


def _corrupt(engine, state, fault: Fault, rng: np.random.Generator,
             comm=None):
    from repro_torch.core.agent_soa import POS

    geom = engine.geom
    nd = geom.ndim
    soa = state.soa
    valid = soa.valid
    if fault.kind == "nan_attrs":
        name = POS if fault.attr in ("pos", POS) else fault.attr
        arr = soa.attrs[name]
        if not torch.is_floating_point(arr):
            raise ValueError(
                f"nan_attrs targets float attrs; {name!r} is "
                f"{str(arr.dtype).replace('torch.', '')}")
        arr = arr.clone()
        for d, ordinals in _pick_live(geom, valid, fault.frac, rng,
                                      comm).items():
            at = _mine(comm, d)
            if at is None:
                continue
            v = valid[at].reshape(-1)
            slots = torch.nonzero(v).reshape(-1)[
                torch.tensor(ordinals, device=v.device)]
            blk = arr[at]
            flat = blk.reshape((v.shape[0],) + tuple(blk.shape[nd + 1:]))
            flat[slots] = float("nan")
    elif fault.kind == "halo_slab":
        if not 0 <= fault.axis < nd:
            raise ValueError(
                f"halo_slab axis {fault.axis} out of range for "
                f"{nd}-D domain")
        name = POS
        arr = soa.attrs[name].clone()
        dev = tuple(int(rng.integers(m)) for m in geom.mesh_shape)
        at = _mine(comm, dev)
        if at is not None:
            # the first owned layer along the axis: the low-side send slab
            sl = at + tuple(1 if a == fault.axis else slice(None)
                            for a in range(nd))
            layer = arr[sl]
            layer[valid[sl]] = float("nan")
    else:  # pragma: no cover - fire() routes only corrupting kinds here
        raise ValueError(f"not a state-corrupting fault: {fault.kind}")
    return dataclasses.replace(
        state, soa=soa.replace(attrs={**soa.attrs, name: arr}))
