"""Multi-pattern suite runner — the paper's JSON-input mode (§3.3, §3.5).

Runs many patterns, then reports the paper's aggregates: per-pattern
bandwidths, suite min/max and harmonic mean.  ``stream_r=True`` also times
the STREAM-like reference (paper §3.4) and reports its bandwidth as
``stream_gbs``; paper Eq. 1's Pearson R correlates measured with modeled
bandwidth, and the port has no modeled column yet, so ``stream_r`` stays
None.

Execution goes through the suite planner (``batch=True``, plan.py): one
launch per shape bucket.  ``batch=False`` runs one ``GSEngine`` per
pattern.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import backends as B
from .engine import GSEngine, RunResult
from .pattern import Pattern, make_pattern
from .plan import ExecutorCache, SuitePlan, run_plan

_METRIC_COLUMNS = {"measured": "measured_gbs",
                   "measured_gbs": "measured_gbs"}


def _metric_column(metric: str) -> str:
    col = _METRIC_COLUMNS.get(metric)
    if col is None:
        raise ValueError(f"unknown metric {metric!r}; "
                         f"expected one of {sorted(_METRIC_COLUMNS)}")
    return col


@dataclasses.dataclass
class SuiteStats:
    results: list[RunResult]
    min_gbs: float
    max_gbs: float
    hmean_gbs: float
    plan: SuitePlan | None = None        # set when the planner ran
    stream_gbs: float | None = None      # STREAM-like reference GB/s
    stream_r: float | None = None        # paper Eq. 1 R: no modeled series

    @property
    def host_s(self) -> float:
        """Host seconds spent building the suite's input buffers."""
        return sum(r.host_s for r in self.results)

    def table(self, metric: str = "measured") -> list[dict]:
        col = _metric_column(metric)
        rows = []
        for r in self.results:
            row = r.row()
            row["gbs"] = row[col]
            rows.append(row)
        return rows

    def to_json(self, metric: str = "measured") -> dict:
        """JSON-safe dict; non-finite aggregates serialize as null."""
        def _f(x):
            return x if x is not None and math.isfinite(x) else None
        table = [{k: (_f(v) if isinstance(v, float) else v)
                  for k, v in row.items()}
                 for row in self.table(metric)]
        return {
            "metric": _metric_column(metric),
            "device": self.results[0].device,
            "n_patterns": len(self.results),
            "min_gbs": _f(self.min_gbs),
            "max_gbs": _f(self.max_gbs),
            "hmean_gbs": _f(self.hmean_gbs),
            "stream_gbs": _f(self.stream_gbs),
            "stream_r": _f(self.stream_r),
            "n_buckets": self.plan.n_buckets if self.plan else None,
            "host_s": self.host_s,
            "table": table,
        }


def harmonic_mean(xs) -> float:
    xs = [x for x in xs if x > 0]
    if not xs:
        return 0.0
    return len(xs) / sum(1.0 / x for x in xs)


def pearson_r(xs, ys) -> float:
    """Paper Eq. (1): R = cov(X, STREAM) / (std(X)·std(STREAM))."""
    x, y = np.asarray(xs, float), np.asarray(ys, float)
    if x.size < 2 or x.std() == 0 or y.std() == 0:
        return float("nan")
    return float(np.corrcoef(x, y)[0, 1])


def aggregate_stats(results: list[RunResult], *, metric: str = "measured",
                    plan: SuitePlan | None = None,
                    stream_ref: RunResult | None = None) -> SuiteStats:
    """Fold per-pattern RunResults into the paper's §3.5 aggregates."""
    if not results:
        raise ValueError("aggregate_stats needs at least one result")
    col = _metric_column(metric)
    vals = [getattr(r, col) for r in results]
    return SuiteStats(
        results=list(results),
        min_gbs=min(vals), max_gbs=max(vals),
        hmean_gbs=harmonic_mean(vals),
        plan=plan,
        stream_gbs=None if stream_ref is None else stream_ref.measured_gbs)


def run_suite(patterns: list[Pattern], *, backend: str = "torch",
              dtype=None, row_width: int = 1, runs: int = 10,
              metric: str = "measured", mode: str = "store",
              batch: bool = True, seed: int = 0,
              cache: ExecutorCache | None = None,
              stream_r: bool = False, stream_n: int = 2 ** 22,
              stream_ref: RunResult | None = None,
              digest: bool = False, device=None) -> SuiteStats:
    """Run a pattern suite and aggregate the paper's §3.5 statistics.

    ``digest`` attaches each pattern's output sha256 (planner path only).
    ``device=None`` means ``"cuda"``.
    """
    if not patterns:
        raise ValueError("run_suite needs at least one pattern")
    _metric_column(metric)                  # reject typos up front
    B.check_mode(mode)
    if digest and not batch:
        raise ValueError("digest requires the batched planner (batch=True)")
    plan = None
    if batch:
        plan = SuitePlan.build(patterns)
        results = run_plan(plan, backend=backend, dtype=dtype,
                           row_width=row_width, runs=runs, mode=mode,
                           seed=seed, cache=cache, digest=digest,
                           device=device)
    else:
        results = [GSEngine(p, backend=backend, dtype=dtype,
                            row_width=row_width, mode=mode, seed=seed,
                            device=device).run(runs=runs)
                   for p in patterns]
    ref = None
    if stream_r:
        ref = stream_ref if stream_ref is not None else stream_reference(
            n=stream_n, runs=runs, backend=backend, device=device)
    return aggregate_stats(results, metric=metric, plan=plan, stream_ref=ref)


def stream_reference(*, n: int = 2 ** 22, runs: int = 10,
                     backend: str = "torch", device=None) -> RunResult:
    """STREAM-copy analogue (paper §3.4): UNIFORM:8:1 with delta 8."""
    p = make_pattern("UNIFORM:8:1", kind="gather", delta=8, count=n // 8,
                     name="STREAM-like")
    return GSEngine(p, backend=backend, device=device).run(runs=runs)
