"""Scheduled-operation reducers (port of the reducers of
``repro/core/operations.py``): the facade's analogue of the paper's
two-line ``SumOverAllRanks`` reduction (section 3.4).

An operation is a callable ``op(sim) -> value`` registered with
``sim.every(n, op)``; its results are appended to ``sim.series[name]``.
Each reducer sums over the process's state and then over every process
(``sim.sum_over_all_ranks``): on the virtual mesh the state holds every
device and the second sum is the identity; on a process mesh it is an
all-reduce, and every rank gets the global value.  The ``Operation`` class itself
stays in ``core/simulation.py`` until ROADMAP A6.  The ``batch_*``
reducers take a stacked ensemble state (``core.ensemble``) and reduce
each lane on its own, with one host read a call.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch


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
