"""spattercost on the port: the predicted traffic of every bucket launch,
held against what a census saw it move, with a calibrated GB/s.

The port of ``repro.analysis.cost``.  The prices themselves
(``UnitCost``, ``key_cost``, ``shape_cost``, ``select_shape``,
``auto_placement``) live in ``repro_torch.cost``, where ``mesh="auto"``
uses them; this module adds what the report needs:

  ``Calibration``   measured GB/s a backend and a recorded mesh sweep,
                    read from a device-tagged bench record (below)
  baselines         ``COST_baseline_torch.json``: each key's committed
                    ``io_bytes`` (``python -m repro_torch.analysis --cost
                    --write-baseline``), the ``cost-regression`` gate
  ``CostReport``    per-unit costs and violations, in the reference's
                    schema, so the two packages' reports parse alike
  drivers           ``cost_plan``, ``cost_suite_file``, ``cost_cache``

``lowered_bytes`` of a unit is what its census saw cross the launch
(operands plus result), where the reference lowers the executable; the
``traffic-conservation`` rule holds the two together.

Calibration reads only a record that names the card it was measured on:
``meta`` must say ``"platform": "cuda"``, the device's name and its power
limit.  Its path comes from ``$SPATTER_TORCH_BENCH`` or the caller, never
from a search: the reference's ``BENCH_suite.json`` (jax on a CPU) must not
calibrate the port.  Without such a record every ``predicted_gbs`` is -1.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re

from ..cost import (UnitCost, auto_placement, candidate_shapes, key_cost,
                    select_shape, shape_cost)
from .report import Violation

__all__ = ["UnitCost", "key_cost", "shape_cost", "select_shape",
           "candidate_shapes", "auto_placement", "Calibration",
           "CostReport", "cost_plan", "cost_suite_file", "cost_cache",
           "load_baseline", "write_baseline", "key_id", "suite_stem"]

# tolerances, as the reference's: layout slop at a launch's boundary (and
# an absolute floor for tiny launches), and how far the auto choice may
# sit from a recorded sweep cell before it counts as dominated
TRAFFIC_TOL = 0.02
TRAFFIC_TOL_FLOOR = 64          # bytes
PAD_WASTE_TOL = 0.02
GBS_TOL = 0.10

BENCH_ENV = "SPATTER_TORCH_BENCH"
BASELINE_ENV = "SPATTER_TORCH_COST_BASELINE"
BASELINE_NAME = "COST_baseline_torch.json"

COST_RULES = ("traffic-conservation", "cost-regression")


def key_id(key) -> str:
    """A key's identity in the baseline: its canonical repr."""
    return str(key)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured rates from a device-tagged bench record: ``bw_gbs`` maps
    backend -> suite harmonic-mean GB/s, ``sweep`` suite -> cell ->
    ``{hmean_gbs, pad_waste}``; ``source`` is the record's path, or
    ``"uncalibrated"``."""
    source: str = "uncalibrated"
    bw_gbs: dict = dataclasses.field(default_factory=dict)
    sweep: dict = dataclasses.field(default_factory=dict)
    n_dev: int = 1
    device: str = ""

    @staticmethod
    def names_a_card(meta) -> bool:
        """Whether a record's ``meta`` names the CUDA card it ran on and
        that card's power limit."""
        return (isinstance(meta, dict) and meta.get("platform") == "cuda"
                and bool(meta.get("device")) and meta.get("device") != "cpu"
                and bool(meta.get("power_limit")))

    @classmethod
    def from_record(cls, path: str | None = None) -> "Calibration":
        """Read ``path`` (default ``$SPATTER_TORCH_BENCH``) in the
        ``BENCH_suite.json`` schema; a missing, unreadable or untagged
        record is uncalibrated."""
        if path is None:
            path = os.environ.get(BENCH_ENV)
        if not path:
            return cls()
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return cls()
        if not isinstance(doc, dict) or not cls.names_a_card(
                doc.get("meta")):
            return cls()
        bw = {bk: float(rec["hmean_measured_gbs"])
              for bk, rec in doc.get("backends", {}).items()
              if isinstance(rec, dict) and "hmean_measured_gbs" in rec}
        mesh = doc.get("mesh_sweep", {})
        sweep = {}
        for suite, rec in mesh.get("suites", {}).items():
            cells = {"single": rec["single"]} if "single" in rec else {}
            cells.update(rec.get("shapes", {}))
            sweep[suite] = cells
        return cls(source=path, bw_gbs=bw, sweep=sweep,
                   n_dev=int(mesh.get("n_dev", 1)),
                   device=(f"{doc['meta']['device']}, "
                           f"{doc['meta']['power_limit']}"))

    def to_json(self) -> dict:
        return {"source": self.source, "bw_gbs": dict(self.bw_gbs),
                "n_dev": self.n_dev, "device": self.device}


_SUITE_RE = re.compile(r"([\w.\-]+)\.json")


def suite_stem(label: str) -> str:
    """The suite name a lint/cost cell label refers to ("" if none)."""
    m = _SUITE_RE.search(label)
    return os.path.basename(m.group(1)) if m else ""


def baseline_path() -> str | None:
    """``$SPATTER_TORCH_COST_BASELINE``, else ``COST_baseline_torch.json``
    in the working directory or at the root of this checkout."""
    p = os.environ.get(BASELINE_ENV)
    if p:
        return p if os.path.exists(p) else None
    root = os.path.normpath(os.path.join(os.path.dirname(__file__), "..",
                                         "..", ".."))
    for cand in (BASELINE_NAME, os.path.join(root, BASELINE_NAME)):
        if os.path.exists(cand):
            return cand
    return None


def load_baseline(path: str | None = None) -> dict:
    """``{key repr: io_bytes}``; ``{}`` when nothing is committed (only a
    smaller committed value fires ``cost-regression``)."""
    path = path or baseline_path()
    if path is None:
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    return {k: int(v) for k, v in doc.get("units", {}).items()}


def write_baseline(units: dict, path: str, meta: dict | None = None) -> None:
    doc = {"meta": meta or {},
           "units": {k: int(v) for k, v in sorted(units.items())}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


@dataclasses.dataclass
class CostReport:
    """Per-unit traffic and the gates' violations (the reference's
    schema); imports no torch."""
    units: list = dataclasses.field(default_factory=list)
    violations: list = dataclasses.field(default_factory=list)
    calibration: dict = dataclasses.field(default_factory=dict)
    rules: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def n_violations(self) -> int:
        return len(self.violations)

    @property
    def ok(self) -> bool:
        return not any(v.severity == "error" for v in self.violations)

    def merge(self, other: "CostReport") -> "CostReport":
        meta = dict(self.meta)
        for k, v in other.meta.items():
            if k == "cells" and isinstance(meta.get(k), list):
                meta[k] = meta[k] + v
            else:
                meta[k] = v
        return CostReport(units=self.units + other.units,
                          violations=self.violations + other.violations,
                          calibration=self.calibration or other.calibration,
                          rules=tuple(dict.fromkeys(self.rules
                                                    + other.rules)),
                          meta=meta)

    def to_json(self) -> dict:
        return {"units": [u.to_json() for u in self.units],
                "violations": [v.to_json() for v in self.violations],
                "calibration": dict(self.calibration),
                "rules": list(self.rules), "meta": self.meta,
                "n_units": self.n_units, "ok": self.ok}

    @classmethod
    def from_json(cls, doc: dict) -> "CostReport":
        known = {"units", "violations", "calibration", "rules", "meta",
                 "n_units", "ok"}
        bad = set(doc) - known
        if bad:
            raise ValueError(f"unknown CostReport fields: {sorted(bad)}")
        return cls(units=[UnitCost.from_json(u)
                          for u in doc.get("units", [])],
                   violations=[Violation.from_json(v)
                               for v in doc.get("violations", [])],
                   calibration=dict(doc.get("calibration", {})),
                   rules=tuple(doc.get("rules", ())),
                   meta=dict(doc.get("meta", {})))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    def summary(self) -> str:
        io = sum(u.io_bytes for u in self.units)
        useful = sum(u.useful_bytes for u in self.units
                     if u.useful_bytes > 0)
        head = (f"spattercost: {self.n_units} unit(s), "
                f"{io} predicted I/O bytes"
                + (f" ({io / useful:.2f}x analytic minimum)"
                   if useful else "")
                + f", {self.n_violations} violation(s)")
        lines = [head]
        for v in self.violations:
            lines.append(f"  [{v.severity}] {v.rule}: {v.message}"
                         + (f" ({v.exec_key})" if v.exec_key else ""))
        return "\n".join(lines)


def _cell_name(placement) -> str:
    if isinstance(placement, list):
        return "auto(" + ",".join(p.placement if p else "single"
                                  for p in placement) + ")"
    return placement.placement if placement else "single"


def cost_plan(patterns, *, backend: str = "torch", dtype=None,
              row_width: int = 1, mode: str = "store", placement=None,
              mesh_axis: str = "data", label: str = "", calibration=None,
              census: bool = True, rules: tuple | None = None, device=None,
              devices=None) -> CostReport:
    """Cost every bucket launch of one plan x placement cell.

    Mirrors ``lint.lint_plan``: the same enumeration and cell label; adds
    the members' useful/pad split and, with ``census``, each unit's census
    bytes (``lowered_bytes``, held by ``traffic-conservation``).
    """
    from ..plan import SuitePlan, enumerate_executables, resolve_mesh
    from .lint import run_rules
    from .rules import KEY_ONLY_RULES, ExecUnit, PlanUnit, rules_for
    if calibration is None:
        calibration = Calibration.from_record()
    plan = patterns if hasattr(patterns, "buckets") \
        else SuitePlan.build(list(patterns))
    units = enumerate_executables(
        plan, backend=backend, dtype=dtype, row_width=row_width, mode=mode,
        placement=placement, mesh_axis=mesh_axis, device=device,
        devices=devices)
    placed = [pl for _, _, pl in units]
    per_bucket = placement == "auto" or isinstance(placement, list)
    cell_place = _cell_name(placed if per_bucket else placed[0])
    cell = f"{label} @ {cell_place} backend={backend}" if label \
        else f"@ {cell_place} backend={backend}"
    exec_rules = [n for n in COST_RULES if rules is None or n in rules]
    if not census:
        exec_rules = [n for n in exec_rules if n in KEY_ONLY_RULES]
    out, violations = [], []
    for (key, builder, pl), bucket in zip(units, plan.buckets):
        unit = ExecUnit(key=key, builder=builder, placement=pl,
                        device=device)
        real = sum(plan.patterns[i].count * plan.patterns[i].index_len
                   for i in bucket.members)
        seen = (unit.census.operand_bytes + unit.census.result_bytes
                if census else -1)
        out.append(key_cost(key, n_members=len(bucket.members),
                            real_elems=real, lowered_bytes=seen,
                            calibration=calibration, label=unit.label))
        violations.extend(run_rules(unit, exec_rules))
    plan_rules = () if rules is not None \
        and "auto-placement-sane" not in rules else ("auto-placement-sane",)
    if plan_rules:
        grid = (1, 1) if per_bucket or placed[0] is None else placed[0].grid
        plan_unit = PlanUnit(plan=plan, grid=tuple(grid), label=cell,
                             placements=placed if per_bucket else None)
        for r in rules_for("plan", plan_rules):
            violations.extend(r.check(plan_unit))
    return CostReport(units=out, violations=violations,
                      calibration=calibration.to_json(),
                      rules=tuple(exec_rules) + plan_rules,
                      meta={"cells": [{"cell": cell, "n_units": len(out)}]})


def cost_suite_file(path: str, *, mesh=None, backends=("torch", "hopper"),
                    mode: str = "store", row_width: int = 1, dtype=None,
                    calibration=None, rules: tuple | None = None,
                    device=None, devices=None) -> CostReport:
    """Cost a suite file across backends at one placement (``mesh``: any
    ``make_work`` form; ``"auto"`` / ``"auto-suite"`` resolve inside each
    backend's cell, and the choices land in ``meta.auto``)."""
    from ..pattern import load_suite
    from ..plan import SuitePlan, auto_placements, device_pool
    plan = SuitePlan.build(load_suite(path))
    auto: dict = {}
    report = CostReport()
    for backend in backends:
        placement = mesh
        if mesh in ("auto", "auto-suite"):
            placement = auto_placements(
                plan, mesh, backend=backend, row_width=row_width,
                devices=devices if devices is not None
                else device_pool(device))
            auto[backend] = (
                [p.placement if p else "single" for p in placement]
                if isinstance(placement, list)
                else placement.placement if placement else "single")
        report = report.merge(cost_plan(
            plan, backend=backend, dtype=dtype, row_width=row_width,
            mode=mode, placement=placement, label=path,
            calibration=calibration, rules=rules, device=device,
            devices=devices))
    if auto:
        report.meta["auto"] = {path: auto}
    return report


def cost_cache(cache, *, calibration=None) -> CostReport:
    """``GET /cost``: the traffic of every entry of a live cache, with the
    census each entry kept from its first call.  An entry restored from
    disk has none: it gets the key's geometry and the key-only rules, as
    ``lint.lint_cache`` does.  Runs nothing."""
    from .lint import run_rules
    from .rules import KEY_ONLY_RULES, ExecUnit
    if calibration is None:
        calibration = Calibration.from_record()
    units, violations, n_restored = [], [], 0
    for key, fn, census in cache.entries():
        unit = ExecUnit(key=key, fn=fn, _census=census)
        seen = -1
        if census is None:
            n_restored += 1
            names = [n for n in COST_RULES if n in KEY_ONLY_RULES]
        else:
            seen = census.operand_bytes + census.result_bytes
            names = list(COST_RULES)
        units.append(key_cost(key, lowered_bytes=seen,
                              calibration=calibration, label=unit.label))
        violations.extend(run_rules(unit, names))
    return CostReport(units=units, violations=violations,
                      calibration=calibration.to_json(), rules=COST_RULES,
                      meta={"source": "live-cache",
                            "restored": n_restored})
