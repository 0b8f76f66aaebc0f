"""A model's gathers and scatters distilled into Spatter patterns: the
paper's §2 for a PyTorch program.

The port of ``repro/core/tracing.py:60-205`` (``TracedAccess``,
``TraceReport``, ``trace_gs``).  The paper harvests gather/scatter
patterns from mini-apps through an instrumented QEMU; the JAX package
walks a jaxpr.  PyTorch has no jaxpr: ``trace_gs(fn, *args, **kwargs)``
runs ``fn`` once, untimed, under a ``TorchDispatchMode`` (as
``analysis/census.py`` does) and records

  * each call of the port's gather/scatter backends
    (``backends.gather``, ``scatter``, ``gather_batched``,
    ``scatter_batched``) as one access, whatever the backend: on
    ``hopper`` the kernel is a ``ctypes`` call that dispatch never sees,
    so the trace observes the backend functions themselves (through
    ``backends.OBSERVER``), and the aten ops inside a call are neither
    recorded nor counted again;
  * outside those calls, aten's indexed ops: ``embedding``,
    ``index_select``, ``gather``, ``index.Tensor``, ``index_put(_)``,
    ``index_add(_)``, ``scatter``, ``scatter_add``, ``scatter_reduce``.

Each access has its kind, operand shape, ``n_lookups`` (rows) and
``slice_elems`` (elements a row), and ``moved_bytes`` = rows x row
elements x the operand's element size: a gather's output, a scatter's
updates, as the JAX package's ``_harvest`` counts them.  ``total_bytes``
is the bytes of every aten op's outputs (a backend call's: its result),
the counterpart of "all array outputs in the jaxpr".  The JAX trace
weights a scanned layer's accesses by the trip count; the port's layers
are unrolled, so it records one access a layer: compare the two by
aggregate, not list by list.

    report = trace_gs(lambda t: transformer.forward(cfg, lm, t), tokens)
    print(report.summary())
    suite = report.to_patterns()      # replayable through run_suite,
                                      # an access's in its ``mode``

The observer is a context variable set for the length of the call: other
threads' backend calls are not traced, and traces may nest (a call is
then an access of each).  The jaxpr census walkers of the JAX
module (``:209-351``) are not ported; ``analysis.census`` stands in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

from .pattern import Pattern

# aten op (overload packet name) -> access kind
_ATEN_GS = {
    "embedding": "gather", "index_select": "gather", "gather": "gather",
    "index": "gather",
    "index_put": "scatter", "index_put_": "scatter",
    "index_add": "scatter", "index_add_": "scatter",
    "scatter": "scatter", "scatter_": "scatter",
    "scatter_add": "scatter", "scatter_add_": "scatter",
    "scatter_reduce": "scatter", "scatter_reduce_": "scatter",
}
# primitives whose access sums into its rows (an ``index_put`` with
# ``accumulate`` and a ``scatter_reduce`` are recorded, and replayed, as
# stores)
_ADDS = frozenset({"scatter_add_rows", "index_add", "scatter_add"})


@dataclasses.dataclass
class TracedAccess:
    primitive: str
    kind: str                      # gather | scatter
    operand_shape: tuple
    out_shape: tuple
    index_shape: tuple
    moved_bytes: int               # bytes delivered by this access
    slice_elems: int               # elements per indexed lookup (row width)
    n_lookups: int                 # number of indexed lookups
    eqn_str: str = ""              # the call, as recorded

    @property
    def mode(self) -> str:
        """The scatter mode that replays this access (``run_suite``'s
        ``mode``): ``add`` where it sums into its rows, else ``store``."""
        return "add" if self.primitive in _ADDS else "store"

    def to_pattern(self) -> Pattern | None:
        """Static proxy: the access's row geometry as a UNIFORM row
        pattern, stride ``slice_elems`` over ``n_lookups`` ops (the index
        values are the run's own and are not kept)."""
        if self.n_lookups < 1:
            return None
        return Pattern(
            name=f"traced-{self.primitive}",
            kind=self.kind,
            index=tuple(range(max(1, self.slice_elems))),
            delta=max(1, self.slice_elems),
            count=self.n_lookups,
            source="torch-trace",
        )


@dataclasses.dataclass
class TraceReport:
    accesses: list[TracedAccess]
    total_bytes: int               # all aten op outputs of the call

    @property
    def gs_bytes(self) -> int:
        return sum(a.moved_bytes for a in self.accesses)

    @property
    def gs_fraction(self) -> float:
        """Table 1's G/S share of data motion."""
        return self.gs_bytes / max(1, self.total_bytes)

    def gathers(self) -> list[TracedAccess]:
        return [a for a in self.accesses if a.kind == "gather"]

    def scatters(self) -> list[TracedAccess]:
        return [a for a in self.accesses if a.kind == "scatter"]

    def to_patterns(self) -> list[Pattern]:
        out = []
        for a in self.accesses:
            p = a.to_pattern()
            if p is not None:
                out.append(p)
        return out

    def summary(self) -> str:
        lines = [
            f"traced {len(self.accesses)} G/S accesses "
            f"({len(self.gathers())} gathers / {len(self.scatters())} scatters)",
            f"G/S bytes: {self.gs_bytes / 1e6:.1f} MB of "
            f"{self.total_bytes / 1e6:.1f} MB total "
            f"({100 * self.gs_fraction:.1f}%)   [paper Table 1 analogue]",
        ]
        for a in sorted(self.accesses, key=lambda a: -a.moved_bytes)[:12]:
            lines.append(
                f"  {a.primitive:<22} {str(a.operand_shape):<20} "
                f"rows={a.n_lookups:<10} row_elems={a.slice_elems:<8} "
                f"{a.moved_bytes / 1e6:9.2f} MB")
        return "\n".join(lines)


def _nbytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _access(primitive, kind, operand, index_shape, out_shape, rows,
            row_elems, what) -> TracedAccess:
    return TracedAccess(
        primitive=primitive, kind=kind, operand_shape=tuple(operand.shape),
        out_shape=tuple(out_shape), index_shape=tuple(index_shape),
        moved_bytes=rows * row_elems * operand.element_size(),
        slice_elems=row_elems, n_lookups=rows, eqn_str=what[:120])


def _slice_elems(operand, dim: int) -> int:
    """Elements of one lookup along ``dim``: the operand's slice there."""
    if operand.dim() == 0:
        return 1
    return operand.numel() // max(1, operand.shape[dim])


def _indexed(operand, indices) -> tuple[tuple, int]:
    """(the broadcast index shape, elements a lookup) of advanced indexing
    ``operand[indices]``: a None keeps its dim, an integer index takes one
    dim, a boolean mask as many as it has and counts its true entries (a
    host sync: the trace is untimed); dims past the indices are kept."""
    import torch
    shapes, d, row = [], 0, 1
    for i in indices:
        if i is None:
            row *= operand.shape[d]
            d += 1
        elif i.dtype in (torch.bool, torch.uint8):
            shapes.append((int(i.count_nonzero()),))
            d += i.dim()
        else:
            shapes.append(tuple(i.shape))
            d += 1
    return (tuple(torch.broadcast_shapes(*shapes)),
            row * math.prod(operand.shape[d:]))


def _aten_access(name: str, func, args, out) -> TracedAccess:
    """The access an indexed aten op made (``_ATEN_GS``)."""
    kind = _ATEN_GS[name]
    prim = name.rstrip("_")
    what = str(func)
    if name == "embedding":
        weight, idx = args[0], args[1]
        return _access(prim, kind, weight, idx.shape, out.shape, idx.numel(),
                       _slice_elems(weight, 0), what)
    self = args[0]
    if name == "index" or name.startswith("index_put"):
        shape, row = _indexed(self, args[1])
        rows = math.prod(shape)
        out_shape = out.shape if name == "index" else self.shape
        return _access(prim, kind, self, shape, out_shape, rows, row, what)
    dim, idx = args[1], args[2]
    if name.startswith(("index_select", "index_add")):
        out_shape = out.shape if kind == "gather" else self.shape
        return _access(prim, kind, self, idx.shape, out_shape, idx.numel(),
                       _slice_elems(self, dim), what)
    # gather, scatter, scatter_add, scatter_reduce: one element a lookup
    out_shape = out.shape if kind == "gather" else self.shape
    return _access(prim, kind, self, idx.shape, out_shape, idx.numel(), 1,
                   what)


def _backend_access(fn_name: str, args, kwargs, out) -> TracedAccess:
    """The access of one backend call: a gather of ``idx.numel()`` rows of
    ``src``, or a scatter (store or add) of as many rows into ``dst``."""
    names = (("src", "idx") if fn_name.startswith("gather")
             else ("dst", "idx", "vals"))
    bound = dict(zip(names, args), **kwargs)
    idx = bound["idx"]
    backend = kwargs.get("backend", "torch")
    if fn_name.startswith("gather"):
        src = bound["src"]
        return _access("gather_rows", "gather", src, idx.shape, out.shape,
                       idx.numel(), src.shape[-1],
                       f"backends.{fn_name}(backend={backend!r})")
    dst, mode = bound["dst"], kwargs.get("mode", "store")
    prim = "scatter_add_rows" if mode == "add" else "scatter_store_rows"
    return _access(prim, "scatter", dst, idx.shape, dst.shape, idx.numel(),
                   dst.shape[-1],
                   f"backends.{fn_name}(mode={mode!r}, backend={backend!r})")


class _Recorder:
    """The accesses and output bytes of one traced call; ``depth`` > 0
    inside a backend call, where nothing is recorded."""

    def __init__(self, outer: Callable | None = None):
        self.accesses: list[TracedAccess] = []
        self.total_bytes = 0
        self.depth = 0
        self.outer = outer          # an enclosing trace's observer

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        rec = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if rec.depth == 0:
                    rec.total_bytes += _nbytes(out)
                    name = func.overloadpacket.__name__
                    if name in _ATEN_GS:
                        rec.accesses.append(_aten_access(name, func, args,
                                                         out))
                return out
        return Mode()

    def observe(self, fn_name: str, args, kwargs, run: Callable):
        """``backends.OBSERVER``'s hook: one access for the call, and
        nothing for the aten ops inside it."""
        self.depth += 1
        try:
            out = (run() if self.outer is None
                   else self.outer(fn_name, args, kwargs, run))
        finally:
            self.depth -= 1
        self.total_bytes += _nbytes(out)
        self.accesses.append(_backend_access(fn_name, args, kwargs, out))
        return out


def trace_gs(fn: Callable, *args: Any, **kwargs: Any) -> TraceReport:
    """Run ``fn(*args, **kwargs)`` once, without gradients, and return every
    gather/scatter access it made (the module docstring says which)."""
    import torch

    from . import backends
    rec = _Recorder(backends.OBSERVER.get())
    token = backends.OBSERVER.set(rec.observe)
    try:
        with torch.no_grad(), rec.mode():
            fn(*args, **kwargs)
    finally:
        backends.OBSERVER.reset(token)
    return TraceReport(accesses=rec.accesses, total_bytes=rec.total_bytes)
