"""Scheduled operations and reducers (port of
``repro/core/operations.py``): the facade's analogue of BioDynaMo's
operation list and of the paper's two-line ``SumOverAllRanks`` reduction
(section 3.4).

An :class:`Operation` is a callable ``op(sim) -> value`` registered with
``sim.every(n, op)``; its results are appended to ``sim.series[name]``.
Each reducer sums over the process's state and then over every process
(``sim.sum_over_all_ranks``): on the virtual mesh the state holds every
device and the second sum is the identity; on a process mesh it is an
all-reduce, and every rank gets the global value.  :func:`checkpoint_op`
saves a logical ABM checkpoint.  The ``batch_*`` reducers take a stacked
ensemble state (``core.ensemble``) and reduce each lane on its own, with
one host read a call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Operation:
    """One scheduled operation: ``fn(sim)`` every ``every`` iterations.
    ``pre`` operations run before the step on ticks with
    ``tick % every == 0`` (like the re-shard check), post operations after
    it on ticks with ``(tick + 1) % every == 0``; ``record`` appends
    non-None results to ``sim.series[name]``."""

    fn: Callable[[Any], Any]
    every: int = 1
    name: str = ""
    pre: bool = False
    record: bool = True

    def due(self, tick: int) -> bool:
        if self.every <= 0:
            return False
        return (tick % self.every == 0) if self.pre \
            else ((tick + 1) % self.every == 0)


def agent_count(sim) -> int:
    """Total live agents across all ranks."""
    return int(sim.sum_over_all_ranks(sim.state.soa.valid.sum()))


def attr_sum(attr: str, name: str = "") -> Callable:
    """Sum of a scalar attribute over all live agents, all ranks."""

    def op(sim):
        soa = sim.state.soa
        a = soa.attrs[attr]
        return float(sim.sum_over_all_ranks(
            torch.where(soa.valid, a, torch.zeros_like(a)).sum()))

    op.__name__ = name or f"sum_{attr}"
    return op


def attr_mean(attr: str, name: str = "") -> Callable:
    """Mean of a scalar attribute over all live agents, all ranks."""

    def op(sim):
        soa = sim.state.soa
        a = soa.attrs[attr]
        n = float(sim.sum_over_all_ranks(soa.valid.sum()))
        s = float(sim.sum_over_all_ranks(
            torch.where(soa.valid, a, torch.zeros_like(a)).sum()))
        return s / max(n, 1.0)

    op.__name__ = name or f"mean_{attr}"
    return op


def attr_counts(attr: str, values: Sequence[int],
                name: str = "") -> Callable:
    """Per-value occupation counts of an integer attribute (e.g. the SIR
    compartments) over all live agents, all ranks."""
    vals = tuple(values)

    def op(sim) -> Tuple[int, ...]:
        soa = sim.state.soa
        a = soa.attrs[attr]
        counts = torch.stack([((a == v) & soa.valid).sum() for v in vals])
        return tuple(int(c) for c in sim.sum_over_all_ranks(counts))

    op.__name__ = name or f"counts_{attr}"
    return op


def checkpoint_op(ckpt_dir: str, keep: int = 3) -> Callable:
    """Operation wrapping ``distributed.checkpoint.save_abm``: a logical,
    mesh-independent checkpoint of the facade's engine and state, labelled
    with the live iteration counter (on a process mesh every rank takes
    part; rank 0 writes)."""

    def op(sim) -> Optional[str]:
        from repro_torch.distributed.checkpoint import save_abm
        return save_abm(ckpt_dir, sim.iteration, sim.engine, sim.state,
                        keep=keep, mesh=sim.mesh)

    op.__name__ = "checkpoint"
    return op


# ---------------------------------------------------------------------------
# Per-lane reducers of a stacked SimState (every leaf carrying a leading
# (R,) lane axis, core.ensemble): each lane reduced on its own into an
# (R, ...) array, lane r's value the solo reducer's on lane r.
# ---------------------------------------------------------------------------

def batch_agent_count(state) -> np.ndarray:
    """Per-lane live-agent totals: (R,) int64."""
    v = state.soa.valid
    return v.reshape(v.shape[0], -1).sum(dim=1).cpu().numpy().astype(
        np.int64)


def batch_attr_sum(attr: str, name: str = "") -> Callable:
    """Per-lane sum of a scalar attribute over live agents: (R,)."""

    def reduce(state) -> np.ndarray:
        soa = state.soa
        r = soa.valid.shape[0]
        a = soa.attrs[attr].reshape(r, -1)
        v = soa.valid.reshape(r, -1)
        return torch.where(v, a, torch.zeros_like(a)).sum(dim=1).cpu() \
            .numpy()

    reduce.__name__ = name or f"batch_sum_{attr}"
    return reduce


def batch_attr_counts(attr: str, values: Sequence[int],
                      name: str = "") -> Callable:
    """Per-lane compartment counts of an integer attribute (e.g. the SIR
    occupation of each lane): (R, len(values)) int64."""
    vals = tuple(values)

    def reduce(state) -> np.ndarray:
        soa = state.soa
        r = soa.valid.shape[0]
        a = soa.attrs[attr].reshape(r, -1)
        v = soa.valid.reshape(r, -1)
        cols = [((a == val) & v).sum(dim=1) for val in vals]
        return torch.stack(cols, dim=1).cpu().numpy().astype(np.int64)

    reduce.__name__ = name or f"batch_counts_{attr}"
    return reduce
