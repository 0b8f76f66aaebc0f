"""repro_torch.analysis: spatterlint and spattercost on the port.

The port of ``repro.analysis``.  spatterlint audits every bucket callable
the planner would build for a suite x placement (``plan.
enumerate_executables``), from the census of one untimed call of each
(``census``), against the invariants behind the port's bandwidth numbers
(``rules``): no sort and no host sync in the timed call, one hand-written
kernel launch a shard, held operands unchanged, the key honest about its
placement and its bytes; plus an ``ast`` concurrency lint over
``repro_torch/serve``.  spattercost prices the same units' traffic
(``repro_torch.cost``) and holds it against the census and a committed
baseline.

Three front-ends share the reference's report schema (``report``):

    python -m repro_torch --lint SUITE | --cost SUITE
    GET /lint, GET /cost           spatterd: audits the live cache
    python -m repro_torch.analysis [--cost] ...   the full matrix

Exports resolve lazily: importing ``report``, ``ast_lint`` or ``cost``
imports no torch; nothing here imports ``jax`` or ``repro``.
"""
import importlib

_EXPORTS = {
    "Violation": ".report",
    "LintReport": ".report",
    "Census": ".census",
    "Rule": ".rules",
    "RULES": ".rules",
    "ExecUnit": ".rules",
    "PlanUnit": ".rules",
    "ServeUnit": ".rules",
    "rules_for": ".rules",
    "run_rules": ".lint",
    "unit_for": ".lint",
    "lint_plan": ".lint",
    "lint_suite_file": ".lint",
    "lint_cache": ".lint",
    "lint_serve": ".lint",
    "UnitCost": ".cost",
    "CostReport": ".cost",
    "Calibration": ".cost",
    "cost_plan": ".cost",
    "cost_suite_file": ".cost",
    "cost_cache": ".cost",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(mod, __name__), name)
