"""GSEngine — pattern -> timed gather/scatter on one device.

The port's counterpart of ``repro.core.engine``: the engine materializes a
Pattern's host buffers (``host.make_host_buffers``), moves them to the
device, and times the backend's call the way the paper does: minimum over
K runs (§3.5), reported as the paper's useful-bytes bandwidth beside the
name of the device that ran it, and beside the modeled H100 rate
(``bandwidth.h100_sector_model``; a model, never mixed with the measured
number).

Timing.  On the card, CUDA events on the current stream bracket each call
and the run waits on the end event; on the CPU, ``perf_counter`` brackets
the call.  One untimed warm-up call comes first.  A scatter writes its dst
in place, so every run gets a fresh zeroed dst, made outside the timed
region (the lesson of the JAX engine's dst donation).

Devices.  ``device=None`` means ``"cuda"``; without CUDA that raises.  Only
an explicit ``device="cpu"`` runs on the CPU, where the hopper backend runs
its kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from . import backends as B
from . import bandwidth as bw
from .host import as_dtype, make_host_buffers
from .pattern import Pattern

SCATTER_MODES = B.SCATTER_MODES       # where repro.core.engine keeps it


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the kernels' plain versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def timed_runs(fn: Callable, args: tuple, runs: int, device: torch.device,
               fresh_dst: bool = False, warmup: Callable | None = None):
    """One warm-up call, then ``runs`` timed calls of ``fn(*args)``.

    Returns ``(min seconds, output of the last call)``.  With
    ``fresh_dst``, ``args[0]`` is a dst the call writes in place: each
    timed call gets a zeroed copy, made before the timed region opens.
    ``warmup(call)``, when given, makes the warm-up call and returns its
    output, where ``call(f)`` calls ``f(*args)`` (the planner takes the
    census of a new cache entry there, untimed).
    """
    if runs < 1:
        raise ValueError("runs must be >= 1 (min-of-K timing needs a run)")
    cuda = device.type == "cuda"
    out = (fn(*args) if warmup is None                 # warm-up
           else warmup(lambda f: f(*args)))
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(runs):
        out = None
        call_args = ((torch.zeros_like(args[0]),) + tuple(args[1:])
                     if fresh_dst else args)
        if cuda:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*call_args)
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*call_args)
            times.append(time.perf_counter() - t0)
    return min(times), out                             # paper §3.5


@dataclasses.dataclass(frozen=True)
class RunResult:
    pattern: Pattern
    backend: str
    device: str                   # name of the device the time is from
    elem_bytes: int
    row_width: int
    runs: int
    time_s: float                 # min over runs (paper §3.5)
    measured_gbs: float           # paper formula over time_s
    modeled_gbs: float            # paper formula over the modeled H100 time
    sector_efficiency: float      # useful / fetched bytes of that model
    host_s: float = 0.0           # host seconds building the input buffers
    out_digest: str | None = None   # sha256 of the output (digest runs)

    def row(self) -> dict:
        return {
            "name": self.pattern.name,
            "kind": self.pattern.kind,
            "type": self.pattern.classify(),
            "backend": self.backend,
            "device": self.device,
            "delta": self.pattern.delta,
            "idx_len": self.pattern.index_len,
            "count": self.pattern.count,
            "time_s": self.time_s,
            "measured_gbs": self.measured_gbs,
            "modeled_h100_gbs": self.modeled_gbs,
            "sector_eff": self.sector_efficiency,
            "digest": self.out_digest,
        }


class GSEngine:
    """Executable form of one Spatter pattern on one device.

    ``mode`` selects the scatter write semantics ("store" last-write-wins,
    the paper's default, or "add" accumulation); gathers ignore it.
    """

    def __init__(self, pattern: Pattern, *, backend: str = "torch",
                 dtype=None, row_width: int = 1, seed: int = 0,
                 mode: str = "store", device=None):
        B.check_backend(backend)
        B.check_mode(mode)
        self.dtype = B.check_dtype(dtype)
        self.device = resolve_device(device)
        self.pattern = pattern
        self.backend = backend
        self.row_width = row_width
        self.mode = mode
        self._seed = seed
        self._built = None
        self.host_s = 0.0

    @property
    def elem_bytes(self) -> int:
        return self.dtype.itemsize * self.row_width

    def footprint_shape(self) -> tuple[int, int]:
        return (self.pattern.footprint(), self.row_width)

    def make_buffers(self):
        """Device operands: (src, idx, None, None) for gathers,
        (None, idx, vals, keep) for scatters; the scatter dst is made per
        call (``build``)."""
        t0 = time.perf_counter()
        src, idx, vals, keep = make_host_buffers(
            self.pattern, self.row_width, seed=self._seed)
        dev = self.device
        idx_t = torch.from_numpy(idx).to(dev)
        if self.pattern.kind == "gather":
            out = (as_dtype(src, self.dtype).to(dev), idx_t, None, None)
        else:
            out = (None, idx_t, as_dtype(vals, self.dtype).to(dev),
                   torch.from_numpy(keep).to(dev))
        self.host_s = time.perf_counter() - t0
        return out

    def build(self):
        """Returns (fn, args) where fn(*args) performs the whole pattern;
        a scatter's args start with a fresh zeroed dst."""
        if self._built is None:
            backend, mode = self.backend, self.mode
            src, idx, vals, keep = self.make_buffers()
            if self.pattern.kind == "gather":
                def fn(src, idx):
                    return B.gather(src, idx, backend=backend)
                self._built = (fn, (src, idx))
            else:
                def fn(dst, idx, vals, keep):
                    return B.scatter(dst, idx, vals, mode=mode,
                                     backend=backend, keep=keep)
                self._built = (fn, (idx, vals, keep))
        fn, args = self._built
        if self.pattern.kind == "scatter":
            args = (torch.zeros(self.footprint_shape(), dtype=self.dtype,
                                device=self.device),) + args
        return fn, args

    def sharded(self, placement):
        """Split the pattern's lanes over a lane-only ``plan.Placement``
        (the paper's thread dim): returns ``(fn, args)`` like ``build``,
        where ``fn(*args)`` cuts the lanes by the placement, runs each
        shard on its device and combines on the first (``Placement.run``).
        A batch placement belongs to the suite planner: one pattern has
        no batch dim to split."""
        if placement.batch_axis is not None:
            raise ValueError("GSEngine.sharded is per pattern: the placement "
                             f"must be lane-only, got {placement.placement}")
        n = self.pattern.count * self.pattern.index_len
        if n % placement.lane_shards:
            raise ValueError(f"count*index_len={n} not divisible by "
                             f"{placement.lane_shards} shards")
        from .plan import _bucket_fn
        _, args = self.build()
        kind, mode = self.pattern.kind, self.mode
        raw = _bucket_fn(self.backend, kind, mode)

        def sharded_fn(*ops):
            shards = [tuple(a[None] for a in sh) for sh in placement.place(
                kind, ops[1:] if kind == "scatter" else ops, batched=False)]
            if kind == "gather":
                return placement.run(raw, kind, mode, shards)[0]
            dst = ops[0][None].to(placement.devices[0])
            return placement.run(raw, kind, mode, shards,
                                 placement.scratch(mode, dst), dst)[0]
        return sharded_fn, args

    def run(self, runs: int = 10) -> RunResult:
        fn, args = self.build()
        t, _ = timed_runs(fn, args, runs, self.device,
                          fresh_dst=self.pattern.kind == "scatter")
        sm = bw.h100_sector_model(self.pattern, self.elem_bytes)
        return RunResult(
            pattern=self.pattern, backend=self.backend,
            device=device_name(self.device),
            elem_bytes=self.elem_bytes, row_width=self.row_width,
            runs=runs, time_s=t,
            measured_gbs=bw.paper_bandwidth(self.pattern, t,
                                            self.elem_bytes) / 1e9,
            modeled_gbs=sm.modeled_gbs,
            sector_efficiency=sm.sector_efficiency, host_s=self.host_s)
