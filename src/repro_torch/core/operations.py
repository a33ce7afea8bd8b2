"""Scheduled-operation reducers (port of the reducers of
``repro/core/operations.py``): the facade's analogue of the paper's
two-line ``SumOverAllRanks`` reduction (section 3.4).

An operation is a callable ``op(sim) -> value`` registered with
``sim.every(n, op)``; its results are appended to ``sim.series[name]``.
The state's tensors hold every device of the (virtual) mesh, so a sum
over a tensor is the sum over all ranks.  The ``Operation`` class itself
stays in ``core/simulation.py`` until ROADMAP A6.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def agent_count(sim) -> int:
    """Total live agents across all ranks."""
    return int(sim.state.soa.valid.sum())


def attr_sum(attr: str, name: str = "") -> Callable:
    """Sum of a scalar attribute over all live agents, all ranks."""

    def op(sim):
        soa = sim.state.soa
        a = soa.attrs[attr]
        return float(torch.where(soa.valid, a, torch.zeros_like(a)).sum())

    op.__name__ = name or f"sum_{attr}"
    return op


def attr_mean(attr: str, name: str = "") -> Callable:
    """Mean of a scalar attribute over all live agents, all ranks."""

    def op(sim):
        soa = sim.state.soa
        a = soa.attrs[attr]
        n = float(soa.valid.sum())
        s = float(torch.where(soa.valid, a, torch.zeros_like(a)).sum())
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
        return tuple(int(((a == v) & soa.valid).sum()) for v in vals)

    op.__name__ = name or f"counts_{attr}"
    return op
