"""spatterlint drivers on the port: enumerate -> census -> audit -> report.

Entry points, as the reference's (``repro.analysis.lint``):

    lint_plan(patterns, ...)     one suite x placement cell
    lint_suite_file(path, ...)   a suites/*.json file over backends
    lint_cache(cache)            a LIVE ExecutorCache's entries (what
                                 spatterd's GET /lint serves)
    lint_serve()                 the ast concurrency lint over
                                 repro_torch/serve
    unit_for(fn, args, ...)      wrap an ad-hoc bucket callable

A plan's units come from ``plan.enumerate_executables``, which shares
``bucket_key`` with the hot path, so what the lint checks is what the
cache would hold.  Each unit's census is one untimed call of its bucket
callable on zero operands at the key's shapes (``census.of_key``), on the
device and placement the key names: a hopper unit on a card launches its
kernel there.  ``lint_cache`` runs nothing: it reads the census each
entry kept from its first call.
"""
from __future__ import annotations

from .report import LintReport, Violation
from .rules import (KEY_ONLY_RULES, SYNC_EXEMPT, ExecUnit, PlanUnit,
                    ServeUnit, rules_for)


def _rule_names(*scopes) -> tuple[str, ...]:
    names: list[str] = []
    for scope in scopes:
        names.extend(r.name for r in rules_for(scope))
    return tuple(names)


def _with_exempt(meta: dict, backends) -> dict:
    """``meta`` plus, where one of ``backends`` is exempt from the
    host-sync rule, ``exempt``: the rule, the backends and why."""
    hit = {b: SYNC_EXEMPT[b] for b in sorted(backends) if b in SYNC_EXEMPT}
    if hit:
        meta["exempt"] = {"no-host-sync-in-timed-region": hit}
    return meta


def run_rules(unit: ExecUnit, names=None) -> list[Violation]:
    """Run executable-scope rules (all by default) on one unit."""
    out: list[Violation] = []
    for r in rules_for("executable", names):
        out.extend(r.check(unit))
    return out


def unit_for(fn, args, *, backend: str, kind: str, mode: str = "",
             placement: str = "", dtype=None, census=None) -> ExecUnit:
    """Wrap a bucket callable that did not come from the planner, with
    example operands: its census is one call of ``fn(*args)``, unless
    ``census=`` hands one over.  Geometry fields the rules do not read are
    zeroed (the rules that hold a key to the planner's geometry skip such
    units)."""
    from ..plan import OPERAND_NAMES, ExecKey
    from .census import take
    if dtype is None:
        dtype = next((a.dtype for a in args if a.is_floating_point()),
                     "float32")
    key = ExecKey(backend=backend, kind=kind, idx_len=0, footprint=0,
                  dtype=str(dtype).removeprefix("torch."), row_width=1,
                  mode=mode, batch=0, placement=placement)
    if census is None:
        census, _ = take(lambda wrap: wrap(fn)(*args),
                         device=args[0].device,
                         operands={n: [a] for n, a in
                                   zip(OPERAND_NAMES[kind], args)})
    return ExecUnit(key=key, fn=fn, _census=census)


def lint_plan(patterns, *, backend: str = "torch", mode: str = "store",
              dtype=None, row_width: int = 1, placement=None,
              mesh_axis: str = "data", label: str = "", rules=None,
              device=None, devices=None) -> LintReport:
    """Audit one suite x placement cell: each bucket's census, then the
    plan.  ``placement`` takes every ``make_work`` ``mesh=`` form over
    ``devices`` (default ``plan.device_pool(device)``); ``"auto"`` resolves
    per bucket against this cell's backend."""
    from ..plan import SuitePlan, enumerate_executables
    from .cost import _cell_name
    patterns = tuple(patterns)
    plan = SuitePlan.build(patterns)

    def enumerate_again():
        return enumerate_executables(
            SuitePlan.build(patterns), backend=backend, dtype=dtype,
            row_width=row_width, mode=mode, placement=placement,
            mesh_axis=mesh_axis, device=device, devices=devices)

    units = enumerate_again()
    placed = [pl for _, _, pl in units]
    per_bucket = placement == "auto" or isinstance(placement, list)
    place_str = _cell_name(placed if per_bucket else placed[0])
    cell = f"{label or f'suite[{len(patterns)}]'} @ {place_str} " \
           f"backend={backend}"
    violations: list[Violation] = []
    for key, builder, pl in units:
        unit = ExecUnit(key=key, builder=builder, placement=pl,
                        device=device)
        violations.extend(run_rules(unit, rules))
    grid = (1, 1) if per_bucket or placed[0] is None else placed[0].grid
    plan_unit = PlanUnit(plan=plan, grid=grid, label=cell,
                         enumerate=enumerate_again,
                         placements=placed if per_bucket else None)
    for r in rules_for("plan", rules):
        violations.extend(r.check(plan_unit))
    meta = {"cells": [{"cell": cell, "backend": backend,
                       "placement": place_str,
                       "n_buckets": plan.n_buckets}]}
    return LintReport(violations=violations, n_units=len(units) + 1,
                      rules=_rule_names("executable", "plan"),
                      meta=_with_exempt(meta, [backend]))


def lint_suite_file(path: str, *, mesh=None, backends=("torch", "hopper"),
                    mode: str = "store", row_width: int = 1, dtype=None,
                    rules=None, device=None, devices=None) -> LintReport:
    """Audit a suites/*.json file across backends on one placement."""
    from ..pattern import load_suite
    patterns = load_suite(path)
    report = LintReport()
    for backend in backends:
        report = report.merge(lint_plan(
            patterns, backend=backend, mode=mode, dtype=dtype,
            row_width=row_width, placement=mesh, label=path, rules=rules,
            device=device, devices=devices))
    return report


def lint_cache(cache, rules=None) -> LintReport:
    """Audit every entry of a LIVE ExecutorCache from the census it kept
    (``ExecutorCache.entries``): runs nothing, takes no device lock, and
    moves neither the cache's counters nor its LRU order.  An entry
    without a census (restored from disk) gets the key-only rules;
    ``meta.restored`` counts them."""
    violations: list[Violation] = []
    entries = cache.entries()
    n_restored = 0
    for key, fn, census in entries:
        unit = ExecUnit(key=key, fn=fn, _census=census)
        names = rules
        if census is None:
            n_restored += 1
            names = [n for n in KEY_ONLY_RULES
                     if rules is None or n in rules]
        violations.extend(run_rules(unit, names))
    meta = {"source": "live-cache", "restored": n_restored}
    return LintReport(violations=violations, n_units=len(entries),
                      rules=_rule_names("executable"),
                      meta=_with_exempt(meta, {k.backend
                                               for k, _, _ in entries}))


def lint_serve(paths=None, rules=None) -> LintReport:
    """Run the serve-scope (ast concurrency) rules over repro_torch/serve."""
    from .ast_lint import serve_sources
    paths = list(paths) if paths is not None else serve_sources()
    files = []
    for p in paths:
        with open(p) as f:
            files.append((p, f.read()))
    unit = ServeUnit(files=files)
    violations: list[Violation] = []
    for r in rules_for("serve", rules):
        violations.extend(r.check(unit))
    return LintReport(violations=violations, n_units=len(files),
                      rules=_rule_names("serve"),
                      meta={"source": "serve-ast"})
