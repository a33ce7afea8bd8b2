"""Port of part of ``repro.analysis``: the structured findings
(:class:`Diagnostic`) and the ensemble family's batch-safety contract
(:func:`check_ensemble`), which the scenario server runs at admission.
The rest of the contract checker, the jaxpr audit and the repo lint wait
for ROADMAP A11."""

from repro_torch.analysis.contracts import (
    CONTRACT_ENSEMBLE_FACTORY, check_ensemble,
)
from repro_torch.analysis.diagnostics import SEVERITIES, Diagnostic

__all__ = ["CONTRACT_ENSEMBLE_FACTORY", "Diagnostic", "SEVERITIES",
           "check_ensemble"]
