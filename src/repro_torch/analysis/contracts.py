"""The batch-safety contract of an ensemble family (port of
``check_ensemble``, ``repro/analysis/contracts.py:524-621``).

The reference runs four passes; two are ported here:

2. a probe of the behaviour factory with every parameter a *two-lane*
   float32 tensor - torch's counterpart of the reference's abstract
   tracer: ``float()`` or an ``if`` on a two-element tensor raises, so a
   factory that concretizes or branches on a parameter (legal for one
   point, fatal for a lane axis) is caught;
3. structural stability: the behaviour built at 0.25 and at 0.75 must
   agree on schema, radius, pair attrs, accumulators and spawn.

Passes 1 (the solo engine contracts over the proto engine) and 4 (the
hot-path lint with parameters per lane, host callbacks in the kernels)
wait for ROADMAP A11, with the rest of the contract checker.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.analysis.diagnostics import Diagnostic

CONTRACT_ENSEMBLE_FACTORY = "ensemble-factory-static"


def _fn_label(fn) -> str:
    mod = getattr(fn, "__module__", "")
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn)))
    return f"{mod}.{name}" if mod else name


def check_ensemble(ensemble) -> List[Diagnostic]:
    """Findings of passes 2 and 3 (module docstring) for one ensemble
    family (duck-typed: needs ``behavior_fn``, ``param_names`` and
    ``proto_engine()``); empty when the family batches."""
    label = _fn_label(ensemble.behavior_fn)
    try:
        ensemble.proto_engine()
    except Exception as e:  # noqa: BLE001 - any factory failure is a finding
        return [Diagnostic(
            severity="error", contract=CONTRACT_ENSEMBLE_FACTORY,
            message=f"behavior factory failed at the zero parameter "
                    f"point: {type(e).__name__}: {e}",
            hint="the factory must build at any parameter value - "
                 "structure may not depend on the point",
            location=label)]

    names = tuple(ensemble.param_names)
    out: List[Diagnostic] = []
    probe = {n: torch.tensor([0.25, 0.75]) for n in names}
    try:
        ensemble.behavior_fn(probe)
    except Exception as e:  # noqa: BLE001
        msg = str(e).splitlines()[0] if str(e) else type(e).__name__
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_ENSEMBLE_FACTORY,
            message=(f"behavior factory concretizes a per-replica "
                     f"parameter ({type(e).__name__}: {msg})"),
            hint="parameters are per-lane values under the ensemble "
                 "runner: no float()/if on them; keep radii and shapes "
                 "static and gate numerically inside the kernel",
            location=label))
        return out  # the remaining probe needs a working factory

    lo = ensemble.behavior_fn({n: 0.25 for n in names})
    hi = ensemble.behavior_fn({n: 0.75 for n in names})
    drift = []
    if lo.schema != hi.schema:
        drift.append("schema")
    if float(lo.radius) != float(hi.radius):
        drift.append("radius")
    if tuple(lo.pair_attrs) != tuple(hi.pair_attrs):
        drift.append("pair_attrs")
    if sorted(lo.acc_spec) != sorted(hi.acc_spec):
        drift.append("accumulators")
    if bool(lo.can_spawn) != bool(hi.can_spawn):
        drift.append("can_spawn")
    if drift:
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_ENSEMBLE_FACTORY,
            message=("behavior structure varies with the parameter "
                     f"point ({', '.join(drift)}): replicas of one "
                     "family must share one structure"),
            hint="move structural choices (schema, radii, accumulator "
                 "specs) out of the swept parameters",
            location=label))
    return out
