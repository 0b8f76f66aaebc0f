"""repro_torch — the Spatter benchmark on PyTorch and hand-written Hopper
kernels, the port of ``repro.core`` (which stays the reference).

Main path: pattern string / JSON suite (``pattern``) -> host buffers
(``host``) -> backends (``backends``; ``hopper`` runs the CUDA kernels in
``kernels/``) -> timed engine (``engine``) -> pow-2 shape-bucket planner
(``plan``) -> suite statistics (``suite``) -> CLI (``python -m
repro_torch``).

Serving path (falcon-mamba-7b, llama3-8b, deepseek-v2-236b, gemma2-27b):
``launch.serve`` -> ``models.zoo`` -> ``models.transformer`` ->
``models.ssm`` (the Hopper selective-scan kernel), ``models.attention``
(flash attention and paged decode) or ``models.moe`` (the row kernels);
configs in ``configs``.

Suite daemon: ``python -m repro_torch.serve.daemon`` (``serve``) runs
suites over HTTP through the planner, with the disk tier ``diskcache``
for bucket recipes and the nvcc-built kernels.

Placements: ``plan.Placement`` lays a bucket launch over a (batch, lane)
grid of devices (axis rules in ``sharding``, ``mesh="auto"`` by
``cost``).

Traces: ``tracing.trace_gs`` records a model's gathers and scatters and
distils them into patterns that the engine replays (the paper's §2).

Public names load lazily, so importing the package imports no submodule
and builds nothing; the kernels are compiled at their first launch.  The
package never imports ``jax`` or ``repro``.
"""
import importlib

_EXPORTS = {
    "Pattern": "pattern", "make_pattern": "pattern",
    "generate_index": "pattern", "load_suite": "pattern",
    "dump_suite": "pattern",
    "make_host_buffers": "host", "keep_last_mask": "host",
    "BACKENDS": "backends", "gather": "backends", "scatter": "backends",
    "gather_batched": "backends", "scatter_batched": "backends",
    "GSEngine": "engine", "RunResult": "engine", "SCATTER_MODES": "engine",
    "SuitePlan": "plan", "BucketSpec": "plan", "Bucket": "plan",
    "ExecKey": "plan", "ExecutorCache": "plan", "CacheStats": "plan",
    "run_plan": "plan", "default_cache": "plan", "pad_batch": "plan",
    "pad_lanes": "plan", "next_pow2": "plan", "Placement": "plan",
    "run_suite": "suite",
    "stream_reference": "suite", "aggregate_stats": "suite",
    "harmonic_mean": "suite", "pearson_r": "suite", "SuiteStats": "suite",
    "trace_gs": "tracing", "TraceReport": "tracing",
    "TracedAccess": "tracing",
}
_SUBMODULES = ("appdb", "backends", "bandwidth", "configs", "cost",
               "diskcache", "engine", "host", "kernels", "launch", "models",
               "pattern", "plan", "serve", "sharding", "suite", "tracing")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                       name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
