"""spatterlint report schema: the one document every front-end emits.

A copy of ``repro.analysis.report`` (stdlib only), so that the two
packages' reports parse alike: the port's spatterd ``GET /lint``, ``python
-m repro_torch --lint`` and the matrix runner ``python -m
repro_torch.analysis`` emit this document, and so do the reference's.
Importing it imports neither torch nor jax.

Wire form::

    {"ok": false,
     "n_units": 12,                      # bucket callables/plans/files
     "n_violations": 1,
     "rules": ["no-sort-in-hot-path", ...],
     "meta": {"cells": [...]},           # matrix provenance (optional)
     "violations": [
        {"rule": "no-sort-in-hot-path",
         "severity": "error",
         "exec_key": "torch/scatter idx=64 fp=32 float32 r1 store b4 @single",
         "location": "sort x1",          # offending op / file:line
         "message": "1 sort op(s) in a timed bucket call: ..."}]}
"""
from __future__ import annotations

import dataclasses
import json

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule firing once: what broke, where, and the evidence."""
    rule: str
    message: str
    exec_key: str = ""        # ExecKey label / plan label / source file
    location: str = ""        # offending op, census count, or file:line
    severity: str = "error"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(doc: dict) -> "Violation":
        fields = {f.name for f in dataclasses.fields(Violation)}
        unknown = set(doc) - fields
        if unknown:
            raise ValueError(f"unknown violation fields: {sorted(unknown)}")
        if "rule" not in doc or "message" not in doc:
            raise ValueError("violation needs at least rule + message")
        return Violation(**doc)

    def render(self) -> str:
        where = f" [{self.exec_key}]" if self.exec_key else ""
        loc = f"\n    at: {self.location}" if self.location else ""
        return f"{self.severity}: {self.rule}{where}: {self.message}{loc}"


@dataclasses.dataclass
class LintReport:
    """The audit result: violations plus how much was actually checked.

    ``n_units`` exists so "zero violations" is distinguishable from
    "checked nothing" — an empty matrix cell must not read as a clean
    bill of health.
    """
    violations: list[Violation] = dataclasses.field(default_factory=list)
    n_units: int = 0
    rules: tuple[str, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        """True when no *error*-severity violation fired."""
        return not any(v.severity == "error" for v in self.violations)

    @property
    def n_violations(self) -> int:
        return len(self.violations)

    def merge(self, other: "LintReport") -> "LintReport":
        """Combine two audits (e.g. matrix cells) into one document."""
        meta: dict = {}
        cells = list(self.meta.get("cells", [])) \
            + list(other.meta.get("cells", []))
        for src in (self.meta, other.meta):
            for k, v in src.items():
                if k != "cells":
                    meta[k] = v
        if cells:
            meta["cells"] = cells
        return LintReport(
            violations=self.violations + other.violations,
            n_units=self.n_units + other.n_units,
            rules=self.rules + tuple(r for r in other.rules
                                     if r not in self.rules),
            meta=meta)

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "n_units": self.n_units,
            "n_violations": self.n_violations,
            "rules": list(self.rules),
            "meta": self.meta,
            "violations": [v.to_json() for v in self.violations],
        }

    @staticmethod
    def from_json(doc: dict) -> "LintReport":
        return LintReport(
            violations=[Violation.from_json(v)
                        for v in doc.get("violations", [])],
            n_units=int(doc.get("n_units", 0)),
            rules=tuple(doc.get("rules", ())),
            meta=dict(doc.get("meta", {})))

    def summary(self) -> str:
        head = (f"spatterlint: {self.n_units} unit(s) audited, "
                f"{len(self.rules)} rule(s), "
                f"{self.n_violations} violation(s)")
        if not self.violations:
            return head + " — clean"
        return "\n".join([head] + [v.render() for v in self.violations])

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
