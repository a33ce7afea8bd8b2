"""Structured findings shared by every check (port of
``repro/analysis/diagnostics.py``).

A :class:`Diagnostic` is one finding: a severity, the *contract* it belongs
to (a stable kebab-case name, the reference's), a human message, an
actionable fix hint, and a location (a behaviour path, a ``file:line`` or
a step context).  A :class:`Report` gathers the findings of one run of
the checks and owns the exit-code and formatting policy:

* ``error``   - the simulation is (or will be) silently wrong; always fails;
* ``warning`` - a probable hazard; fails only under ``--strict``;
* ``info``    - advisory; never fails.

The text and JSON formats are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Sequence

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


def with_context(diags: Iterable[Diagnostic], context: str
                 ) -> List[Diagnostic]:
    """Prefix every diagnostic's location with a run context label."""
    out = []
    for d in diags:
        loc = f"{context}: {d.location}" if d.location else context
        out.append(dataclasses.replace(d, location=loc))
    return out


class Report:
    """An ordered collection of diagnostics with exit-code policy."""

    def __init__(self, diagnostics: Sequence[Diagnostic] = ()):
        self.diagnostics: List[Diagnostic] = list(diagnostics)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def by_severity(self, severity: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> List[Diagnostic]:
        return self.by_severity("error")

    @property
    def warnings(self) -> List[Diagnostic]:
        return self.by_severity("warning")

    def failed(self, strict: bool = False) -> bool:
        """Errors always fail; warnings fail under strict; info never."""
        if self.errors:
            return True
        return bool(strict and self.warnings)

    def exit_code(self, strict: bool = False) -> int:
        return 1 if self.failed(strict) else 0

    def summary(self) -> str:
        counts = {s: len(self.by_severity(s)) for s in SEVERITIES}
        return (f"{counts['error']} error(s), {counts['warning']} "
                f"warning(s), {counts['info']} info")

    def format_text(self) -> str:
        order = {s: i for i, s in enumerate(reversed(SEVERITIES))}
        lines = [d.format() for d in sorted(
            self.diagnostics, key=lambda d: order[d.severity])]
        lines.append(f"simcheck: {self.summary()}")
        return "\n".join(lines)

    def format_json(self) -> str:
        return json.dumps({
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "summary": {s: len(self.by_severity(s)) for s in SEVERITIES},
        }, indent=1)
