"""Structured diagnostics for the trace verifier (a copy of ``thunder_tpu/analysis/diagnostics.py``).

A ``Diagnostic`` is one finding from one rule: machine-readable (rule id,
severity, bsym index, provenance pass name) so pipelines can gate on it, and
human-readable (message, fix hint, offending trace line) so ``examine.lint``
can pretty-print it. The design follows the FX-graph validation passes of
Forge-UGC (PAPERS.md): every transform's output is checked against a rule
suite and the first violation is attributed to the pass that introduced it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence


class Severity(enum.IntEnum):
    """Ordered so thresholds compose: ``sev >= Severity.ERROR`` gates raise."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR", in reports
        return self.name.lower()


@dataclass
class Diagnostic:
    """One finding: which rule fired, where, and how to fix it."""

    rule: str
    severity: Severity
    message: str
    bsym_index: Optional[int] = None
    pass_name: Optional[str] = None
    hint: Optional[str] = None
    # The offending generated line(s), filled in by formatting helpers.
    trace_line: Optional[str] = None

    def format(self) -> str:
        loc = f" @ bsym {self.bsym_index}" if self.bsym_index is not None else ""
        origin = f" [after: {self.pass_name}]" if self.pass_name else ""
        out = f"{self.severity}: [{self.rule}]{loc}{origin} {self.message}"
        if self.trace_line:
            out += f"\n    >> {self.trace_line}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


def attach_trace_lines(diagnostics: Sequence[Diagnostic], trace) -> None:
    """Fill each diagnostic's ``trace_line`` from its bsym index (best-effort:
    printers that need exec-namespace context may fail on hand-built bsyms)."""
    for d in diagnostics:
        if d.bsym_index is None or d.trace_line is not None:
            continue
        try:
            d.trace_line = trace.bound_symbols[d.bsym_index].one_line()
        except Exception:
            pass


def max_severity(diagnostics: Sequence[Diagnostic]) -> Optional[Severity]:
    return max((d.severity for d in diagnostics), default=None)


class TraceVerificationError(RuntimeError):
    """Raised when a verified trace violates an invariant at ERROR severity.

    Carries the full structured diagnostics list; the message leads with the
    first failing diagnostic and the pass that introduced it.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic], pass_name: Optional[str] = None):
        self.diagnostics = list(diagnostics)
        self.pass_name = pass_name
        errors = [d for d in self.diagnostics if d.severity >= Severity.ERROR]
        head = errors[0] if errors else (self.diagnostics[0] if self.diagnostics else None)
        origin = pass_name or (head.pass_name if head else None)
        lead = f"trace verification failed after pass {origin!r}" if origin else "trace verification failed"
        body = "\n".join(d.format() for d in self.diagnostics)
        super().__init__(f"{lead}: {len(errors)} error(s)\n{body}")
