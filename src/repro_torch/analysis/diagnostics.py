"""Structured findings (port of ``repro/analysis/diagnostics.py``'s
:class:`Diagnostic`).

A :class:`Diagnostic` is one finding: a severity, the *contract* it belongs
to (a stable kebab-case name, the reference's), a human message, an
actionable fix hint, and a location (a behaviour path or a ``file:line``).

* ``error``   - the simulation is (or will be) silently wrong;
* ``warning`` - a probable hazard;
* ``info``    - advisory.
"""

from __future__ import annotations

import dataclasses

SEVERITIES = ("info", "warning", "error")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding."""

    severity: str        # "error" | "warning" | "info"
    contract: str        # stable contract name, e.g. "one-hop-migration"
    message: str         # what is wrong
    hint: str = ""       # how to fix it
    location: str = ""   # behaviour path or file:line

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}")

    def format(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return f"{self.severity}: {self.contract}{loc}: {self.message}{hint}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
