"""repro_torch.serve: spatterd on the port, the long-lived suite server.

The port of ``repro.serve``: a daemon that accepts JSON suites over HTTP,
runs them on the card through the hand-written kernels on one warm
``ExecutorCache``, and answers with the reference's wire format (per-
pattern bandwidths and digests, exact per-request build counts).  See
daemon.py.

Exports resolve lazily, so ``python -m repro_torch.serve.daemon`` and
``python -m repro_torch.serve.client`` do not import their own module
twice, and the client imports the stdlib only.
"""
import importlib

_EXPORTS = {
    "SpatterDaemon": ".daemon",
    "SpatterClient": ".client",
    "ServerError": ".client",
    "SuiteRequest": ".schema",
    "Scheduler": ".scheduler",
    "QueueFull": ".scheduler",
    "SchedulerStopped": ".scheduler",
    "DeadlineExceeded": ".scheduler",
    "RequestCancelled": ".scheduler",
    "FamilyQuarantined": ".scheduler",
    "FaultInjector": ".faults",
    "InjectedFault": ".faults",
    "WorkerKilled": ".faults",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(mod, __name__), name)
