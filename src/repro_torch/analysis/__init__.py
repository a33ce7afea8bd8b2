"""Port of ``repro.analysis`` - simcheck: the static contract checker,
the step audit and the repo lint, over one diagnostic currency
(:class:`Diagnostic` / :class:`Report`):

* :mod:`repro_torch.analysis.contracts` - static contracts on a geometry +
  behaviour stack (stencil soundness, one-hop migration, aura sufficiency,
  codec headroom, partition validity, supervised recovery), the
  construction gate (:func:`enforce`) and the ensemble family's
  batch-safety contract (:func:`check_ensemble`).
* :mod:`repro_torch.analysis.step_audit` - the counterpart of the jaxpr
  audit: one step run under a recording dispatch mode (shift edge lists,
  host syncs, dtype drift, int8 arithmetic, cache-key stability), and the
  engine's own host syncs listed apart.
* :mod:`repro_torch.analysis.lint` - AST lint over source files and
  behaviour pair/update functions.

Run everything via ``python -m repro_torch.launch.simcheck`` or
``Simulation.validate()``.
"""

from repro_torch.analysis.contracts import (
    CONTRACT_AURA, CONTRACT_ENSEMBLE, CONTRACT_ENSEMBLE_FACTORY,
    CONTRACT_HEADROOM, CONTRACT_ONE_HOP, CONTRACT_PARTITION,
    CONTRACT_STENCIL, CONTRACT_SUPERVISION, ContractError,
    DisplacementBound, check_codec_headroom, check_contracts, check_engine,
    check_ensemble, check_one_hop, check_partition, check_stencil,
    check_supervision, displacement_bound, enforce, enforce_diagnostics,
    leaf_behaviors, min_slab_width_cells,
)
from repro_torch.analysis.diagnostics import (
    SEVERITIES, Diagnostic, Report, with_context,
)
from repro_torch.analysis.lint import (
    lint_behavior, lint_behaviors, lint_hot_fn, lint_paths, lint_source,
)
from repro_torch.analysis.step_audit import (
    StepAudit, audit_cache_key, audit_edges, audit_engine, audit_fn,
    audit_step, check_edges, probe_state,
)

__all__ = [
    "CONTRACT_AURA", "CONTRACT_ENSEMBLE", "CONTRACT_ENSEMBLE_FACTORY",
    "CONTRACT_HEADROOM", "CONTRACT_ONE_HOP", "CONTRACT_PARTITION",
    "CONTRACT_STENCIL", "CONTRACT_SUPERVISION", "ContractError",
    "Diagnostic", "DisplacementBound", "Report", "SEVERITIES", "StepAudit",
    "audit_cache_key", "audit_edges", "audit_engine", "audit_fn",
    "audit_step", "check_codec_headroom", "check_contracts",
    "check_edges", "check_engine", "check_ensemble", "check_one_hop",
    "check_partition", "check_stencil", "check_supervision",
    "displacement_bound", "enforce", "enforce_diagnostics",
    "leaf_behaviors", "lint_behavior", "lint_behaviors", "lint_hot_fn",
    "lint_paths", "lint_source", "min_slab_width_cells", "probe_state",
    "with_context",
]
