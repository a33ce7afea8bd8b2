"""Port of ``repro.analysis``: the structured findings
(:class:`Diagnostic`), the static contract checker (stencil soundness, aura
sufficiency, one-hop migration, codec headroom, partition validity,
supervised recovery), its construction gate (:func:`enforce`) and the
ensemble family's batch-safety contract (:func:`check_ensemble`).  The
jaxpr audit's counterpart and the repo lint wait for ROADMAP A11."""

from repro_torch.analysis.contracts import (
    CONTRACT_AURA, CONTRACT_ENSEMBLE_FACTORY, CONTRACT_HEADROOM,
    CONTRACT_ONE_HOP, CONTRACT_PARTITION, CONTRACT_STENCIL,
    CONTRACT_SUPERVISION, ContractError, DisplacementBound,
    check_codec_headroom, check_contracts, check_engine, check_ensemble,
    check_one_hop,
    check_partition, check_stencil, check_supervision, displacement_bound,
    enforce, enforce_diagnostics, leaf_behaviors, min_slab_width_cells,
)
from repro_torch.analysis.diagnostics import SEVERITIES, Diagnostic

__all__ = [
    "CONTRACT_AURA", "CONTRACT_ENSEMBLE_FACTORY", "CONTRACT_HEADROOM",
    "CONTRACT_ONE_HOP", "CONTRACT_PARTITION", "CONTRACT_STENCIL",
    "CONTRACT_SUPERVISION", "ContractError", "Diagnostic",
    "DisplacementBound", "SEVERITIES", "check_codec_headroom",
    "check_contracts", "check_engine", "check_ensemble", "check_one_hop",
    "check_partition", "check_stencil", "check_supervision",
    "displacement_bound", "enforce", "enforce_diagnostics",
    "leaf_behaviors", "min_slab_width_cells",
]
