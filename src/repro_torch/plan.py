"""Suite planner: pow-2 shape buckets, executor cache, one launch per bucket.

The single-device part of ``repro.core.plan``, on PyTorch.

Plan.  ``SuitePlan.build`` groups patterns into shape buckets: a pattern's
flattened lane count ``count * index_len`` and its table ``footprint`` are
padded to the next power of two, and patterns that agree on ``(kind,
padded lanes, padded footprint)`` share a bucket.

Cache.  A bucket runs through a callable fetched from an ``ExecutorCache``,
an LRU keyed by ``ExecKey`` (backend, kind, shape, dtype, row width, mode,
padded batch).  PyTorch compiles nothing, so ``misses`` counts the bucket
callables built, one per ``ExecKey``; on a card, building a hopper bucket
loads the libraries it launches (``build_bucket``; ``kernels._build``
compiles each once per process, or takes it from the disk tier).  A
second identical run builds nothing.  The lookup is batch-polymorphic as
in the reference: a bucket whose membership shrank reuses a warm key with
a larger padded batch (``best_batch``).  Builders run outside the cache's
lock, one per key (racing callers wait on its future), so ``misses`` stays
exact under threads and ``launch`` reports whether it built
(``LaunchResult.compiled``).  ``ExecutorCache(disk=)`` adds the disk tier
(``diskcache.DiskTier``): a build owner first restores the key from disk
(``disk_hits``, not ``misses``) and stores what it built;
``fault_hook("compile")`` runs just before a builder (``serve.faults``).

Execute.  Same-bucket patterns are stacked: indices into (B_pad, N_pad)
int32, tables into (B_pad, F_pad + 1, R).  Row F_pad of every table is a
scratch row: padding lanes point at it, and of those only each row's last
padding lane keeps in store mode, so the at-most-one-write-per-row
contract of the store kernel holds for every row.  Batch rows past the
member count are scratch patterns (all lanes on the scratch row, zero
tables and payloads) whose outputs are dropped.  The buffers come from
``host.make_host_buffers``, the same draws as the JAX package, so the
per-pattern output digests (``run_plan(digest=True)``) equal the
reference's for gathers and store-mode scatters.

Timing.  A bucket launch is timed like ``GSEngine.run``: one warm-up, then
min over ``runs`` (fresh zeroed dst per scatter run, outside the timed
region).  Each member is attributed the bucket's time in proportion to its
real lanes over all launched lanes, scratch patterns included, so padding
never inflates a member's bandwidth.  Threads (the serving scheduler's
workers) share the device and its default stream, so a launch holds its
device's lock (``device_lock``) from its first copy to the device until
its output is back on the host: no other launch's copies or kernels fall
between its CUDA events.  The host work (drawing the buffers in numpy,
hashing the output) runs outside the lock.

Not here yet: placements over several devices (ROADMAP A5), and the
reference's quiet pallas->xla degradation, which the port does not carry
over: on a CUDA tensor a kernel launches or raises, and a failed build
fails its launch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from . import backends as B
from . import bandwidth as bw
from .engine import RunResult, device_name, resolve_device, timed_runs
from .host import make_host_buffers
from .pattern import Pattern


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def _bracket_multiple(n: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= ``next_pow2(n)``."""
    if n_shards < 1:
        raise ValueError(f"need n_shards >= 1, got {n_shards}")
    return -(-next_pow2(n) // n_shards) * n_shards


def pad_batch(nb: int, n_shards: int = 1) -> int:
    """Padded pattern-batch dim: the next pow2 bracket, rounded up to a
    multiple of ``n_shards`` (1 on a single device)."""
    return _bracket_multiple(nb, n_shards)


def pad_lanes(n: int, n_shards: int = 1) -> int:
    """Padded lane dim; the lane-axis twin of ``pad_batch``."""
    return _bracket_multiple(n, n_shards)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Shape signature shared by every pattern in a bucket."""
    kind: str           # "gather" | "scatter"
    idx_len: int        # count * index_len, padded to pow2
    footprint: int      # table footprint, padded to pow2

    @staticmethod
    def of(p: Pattern) -> "BucketSpec":
        return BucketSpec(kind=p.kind,
                          idx_len=next_pow2(p.count * p.index_len),
                          footprint=next_pow2(p.footprint()))


@dataclasses.dataclass(frozen=True)
class Bucket:
    spec: BucketSpec
    members: tuple[int, ...]      # positions into the suite's pattern list


@dataclasses.dataclass(frozen=True)
class SuitePlan:
    patterns: tuple[Pattern, ...]
    buckets: tuple[Bucket, ...]

    @staticmethod
    def build(patterns: Sequence[Pattern]) -> "SuitePlan":
        groups: dict[BucketSpec, list[int]] = {}
        for i, p in enumerate(patterns):
            groups.setdefault(BucketSpec.of(p), []).append(i)
        buckets = tuple(
            Bucket(spec=spec, members=tuple(groups[spec]))
            for spec in sorted(groups,
                               key=lambda s: (s.kind, s.idx_len, s.footprint)))
        return SuitePlan(patterns=tuple(patterns), buckets=buckets)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def pad_waste(self) -> float:
        """Fraction of launched lanes that are padding (0 = no waste)."""
        real = sum(p.count * p.index_len for p in self.patterns)
        launched = sum(b.spec.idx_len * pad_batch(len(b.members))
                       for b in self.buckets)
        return 1.0 - real / max(1, launched)


# ---------------------------------------------------------------------------
# Executor cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecKey:
    backend: str
    kind: str
    idx_len: int
    footprint: int
    dtype: str
    row_width: int
    mode: str           # "store" | "add" for scatter, "" for gather
    batch: int          # padded pattern-batch dim (pad_batch)


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Point-in-time ``ExecutorCache`` counters.

    ``misses`` is the exact count of bucket callables built.
    ``batch_hits`` (a subset of ``hits``) counts launches served by a warm
    key with a larger padded batch; ``disk_hits`` counts keys restored
    from the disk tier (built nothing).
    """
    hits: int
    misses: int
    size: int
    batch_hits: int = 0
    disk_hits: int = 0

    def delta(self, before: "CacheStats") -> "CacheStats":
        return CacheStats(hits=self.hits - before.hits,
                          misses=self.misses - before.misses,
                          size=self.size - before.size,
                          batch_hits=self.batch_hits - before.batch_hits,
                          disk_hits=self.disk_hits - before.disk_hits)

    def to_json(self) -> dict:
        # the reference's wire document also counts launches served by its
        # pallas->xla fallback; the port has none, so that count is 0
        return {**dataclasses.asdict(self), "degraded": 0}


class _BuildFuture:
    """In-flight build of one key: the owning thread publishes the callable
    (or the builder's exception) and racing threads wait on it."""
    __slots__ = ("done", "fn", "exc")

    def __init__(self):
        self.done = threading.Event()
        self.fn = None
        self.exc = None


class ExecutorCache:
    """LRU of bucket callables; ``misses`` counts the ones built.

    One lock guards the entries and the counters.  Builders run outside
    it, one per key: a thread that claims a key builds it (or restores it
    from ``disk``), and threads racing on the same key wait for that build
    and count a hit, so ``misses`` is exact under concurrency.

    ``disk`` is the optional ``diskcache.DiskTier``; ``fault_hook`` is
    called with ``"compile"`` just before a builder runs and may raise
    (``serve.faults``).
    """

    def __init__(self, maxsize: int = 128, *, disk=None, fault_hook=None):
        self.maxsize = maxsize
        self.disk = disk
        self.fault_hook = fault_hook
        self._entries: OrderedDict[ExecKey, Callable] = OrderedDict()
        self._pending: dict[ExecKey, _BuildFuture] = {}
        self._families: dict[ExecKey, set[int]] = {}   # family -> batches
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.batch_hits = 0
        self.disk_hits = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @staticmethod
    def _family(key: ExecKey) -> ExecKey:
        """Batch-stripped key (real batches are >= 1, 0 is free)."""
        return dataclasses.replace(key, batch=0)

    def _insert_locked(self, key: ExecKey, fn: Callable) -> None:
        self._entries[key] = fn
        self._families.setdefault(self._family(key), set()).add(key.batch)
        while len(self._entries) > self.maxsize:
            old, _ = self._entries.popitem(last=False)
            batches = self._families[self._family(old)]
            batches.discard(old.batch)
            if not batches:
                del self._families[self._family(old)]

    def _best_batch_locked(self, key: ExecKey) -> ExecKey | None:
        batches = self._families.get(self._family(key))
        cands = [b for b in batches or () if b >= key.batch]
        if not cands:
            return None
        return dataclasses.replace(key, batch=min(cands))

    def best_batch(self, key: ExecKey) -> ExecKey | None:
        """Smallest cached key differing from ``key`` only by a >= batch."""
        with self._lock:
            return self._best_batch_locked(key)

    def _build(self, key: ExecKey, fut: _BuildFuture,
               builder: Callable[[], Callable]) -> tuple[Callable, bool]:
        """Resolve the build this thread claimed, outside the lock:
        restore from the disk tier, else run ``builder``.  Returns
        ``(fn, built)``."""
        disk = self.disk
        try:
            fn = disk.load(key) if disk is not None else None
            built = fn is None
            if built:
                if self.fault_hook is not None:
                    self.fault_hook("compile")
                fn = builder()
        except BaseException as e:
            # publish the failure: threads waiting on this key raise it too
            fut.exc = e
            with self._lock:
                if self._pending.get(key) is fut:
                    del self._pending[key]
            fut.done.set()
            raise
        with self._lock:
            # a clear() while this built emptied _pending: insert nothing,
            # so the reset counters stay consistent with the entries
            if self._pending.get(key) is fut:
                del self._pending[key]
                self._insert_locked(key, fn)
                if built:
                    self.misses += 1
                else:
                    self.disk_hits += 1
        fut.fn = fn
        fut.done.set()
        if disk is not None and built:
            disk.store(key, fn)          # failures are counted, not raised
        return fn, built

    def serve_poly_info(self, key: ExecKey, builder: Callable[[], Callable]
                        ) -> tuple[Callable, ExecKey, bool]:
        """``(fn, served_key, built)``: ``served_key`` is ``key`` or its
        smallest warm larger-batch sibling; ``built`` is True iff this call
        ran ``builder`` (counted in ``misses``; a disk restore is not)."""
        with self._lock:
            best = self._best_batch_locked(key)
            if best is not None:
                self._entries.move_to_end(best)
                self.hits += 1
                if best.batch > key.batch:
                    self.batch_hits += 1
                return self._entries[best], best, False
            fut = self._pending.get(key)
            owner = fut is None
            if owner:
                fut = self._pending[key] = _BuildFuture()
            else:
                self.hits += 1             # that build is in flight
        if not owner:
            fut.done.wait()
            if fut.exc is not None:
                raise fut.exc
            return fut.fn, key, False
        fn, built = self._build(key, fut, builder)
        return fn, key, built

    def attach_disk(self, tier, preload: bool = True) -> int:
        """Adopt a disk tier; with ``preload`` restore every verifiable
        entry now (each counts ``disk_hits``).  Returns how many."""
        self.disk = tier
        if not preload:
            return 0
        restored = tier.load_all()
        n = 0
        with self._lock:
            for key, fn in restored:
                if key not in self._entries:
                    self._insert_locked(key, fn)
                    self.disk_hits += 1
                    n += 1
        return n

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(hits=self.hits, misses=self.misses,
                              size=len(self._entries),
                              batch_hits=self.batch_hits,
                              disk_hits=self.disk_hits)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._families.clear()
            self._pending.clear()
            self.hits = self.misses = self.batch_hits = self.disk_hits = 0


_DEFAULT_CACHE = ExecutorCache()


def default_cache() -> ExecutorCache:
    """Process-wide cache: repeated run_suite calls share warm entries."""
    return _DEFAULT_CACHE


def _bucket_fn(backend: str, kind: str, mode: str) -> Callable:
    """The bucket callable: gather (table, idx) or scatter (dst, idx, vals,
    keep), one backend call for the whole bucket."""
    if kind == "gather":
        def fn(table, idx):
            return B.gather_batched(table, idx, backend=backend)
    else:
        def fn(dst, idx, vals, keep):
            return B.scatter_batched(dst, idx, vals, mode=mode,
                                     backend=backend, keep=keep)
    return fn


def bucket_libraries(backend: str, kind: str, platform: str
                     ) -> tuple[str, ...]:
    """The nvcc-built libraries a bucket callable launches on
    ``platform`` (on the CPU the hopper backend runs plain versions)."""
    if backend != "hopper" or platform != "cuda":
        return ()
    return ("gather_rows",) if kind == "gather" else ("scatter_rows",)


def build_bucket(backend: str, kind: str, mode: str, device,
                 tier=None) -> Callable:
    """Build a bucket callable: load the libraries it launches (from
    ``tier`` when given, so a corrupt one is rebuilt), then close over
    its options."""
    from .kernels import _build
    for name in bucket_libraries(backend, kind, device.type):
        _build.library(name, tier=tier)
    return _bucket_fn(backend, kind, mode)


def bucket_key(backend: str, spec: BucketSpec, dtype, row_width: int,
               mode: str, n_members: int) -> ExecKey:
    """The ``ExecKey`` a bucket launch is served under."""
    return ExecKey(backend=backend, kind=spec.kind, idx_len=spec.idx_len,
                   footprint=spec.footprint,
                   dtype=str(dtype).removeprefix("torch."),
                   row_width=row_width,
                   mode=mode if spec.kind == "scatter" else "",
                   batch=pad_batch(n_members))


# ---------------------------------------------------------------------------
# Bucket assembly
# ---------------------------------------------------------------------------

# One lock per device, for the whole process: every cache and scheduler in
# the process shares the device and its default stream (module docstring).
_DEVICE_LOCKS: dict[str, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_lock(device) -> threading.Lock:
    """The lock a launch holds while it has work on ``device``."""
    name = str(device)
    with _DEVICE_LOCKS_GUARD:
        lock = _DEVICE_LOCKS.get(name)
        if lock is None:
            lock = _DEVICE_LOCKS[name] = threading.Lock()
        return lock


def _host_members(spec: BucketSpec, patterns: Sequence[Pattern],
                  row_width: int, seeds: Sequence[int],
                  batch: int | None = None, mode: str = "store"):
    """Stack member patterns (of one bucket shape) into host buffers.

    Returns (host, real_lanes): ``host`` is (table, idx) for gathers and
    (idx, vals, keep) for scatters, numpy arrays; real_lanes[b] is member
    b's un-padded lane count.  ``batch`` (default ``pad_batch`` of the
    member count) sets the padded batch.  Member b's buffers come from
    ``make_host_buffers(p, row_width, seeds[b])``.  In add mode the keep
    mask is an all-False placeholder the kernel never reads.
    """
    nb = len(patterns)
    if len(seeds) != nb:
        raise ValueError(f"{len(seeds)} seeds for {nb} members")
    b_pad = pad_batch(nb) if batch is None else batch
    if b_pad < nb:
        raise ValueError(f"batch {b_pad} < member count {nb}")
    n_pad, f_pad, r = spec.idx_len, spec.footprint, row_width
    gather = spec.kind == "gather"
    idx_b = np.full((b_pad, n_pad), f_pad, np.int32)       # pad -> scratch
    table_b = np.zeros((b_pad, f_pad + 1, r), np.float32) if gather else None
    vals_b = None if gather else np.zeros((b_pad, n_pad, r), np.float32)
    keep_b = None if gather else np.zeros((b_pad, n_pad), bool)
    store = not gather and mode == "store"
    if store:
        keep_b[:, -1] = True       # the scratch row's single write
    real_lanes = []
    for b, p in enumerate(patterns):
        src, abs_idx, vals, keep = make_host_buffers(p, r, seed=seeds[b])
        n = abs_idx.shape[0]
        real_lanes.append(n)
        idx_b[b, :n] = abs_idx
        if gather:
            table_b[b, :src.shape[0]] = src
        else:
            vals_b[b, :n] = vals
            if store:
                keep_b[b, :n] = keep      # n == n_pad overwrites the True
    host = (table_b, idx_b) if gather else (idx_b, vals_b, keep_b)
    return host, real_lanes


def _to_device(spec: BucketSpec, host: tuple, device) -> tuple:
    """The launch's operands on ``device``: (table, idx) for gathers, (dst,
    idx, vals, keep) for scatters, with a zeroed dst."""
    if spec.kind == "gather":
        return tuple(torch.from_numpy(a).to(device) for a in host)
    idx, vals, keep = (torch.from_numpy(a).to(device) for a in host)
    dst = torch.zeros((vals.shape[0], spec.footprint + 1, vals.shape[2]),
                      dtype=torch.float32, device=device)
    return dst, idx, vals, keep


def _assemble_members(spec: BucketSpec, patterns: Sequence[Pattern],
                      row_width: int, seeds: Sequence[int], device,
                      batch: int | None = None, mode: str = "store"):
    """``_host_members`` moved to ``device``: (args, real_lanes)."""
    host, real_lanes = _host_members(spec, patterns, row_width, seeds,
                                     batch=batch, mode=mode)
    return _to_device(spec, host, device), real_lanes


# ---------------------------------------------------------------------------
# Work units: make_work -> launch -> demux
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketWork:
    """One bucket's worth of a suite run: everything a ``launch`` needs."""
    spec: BucketSpec
    patterns: tuple[Pattern, ...]     # member patterns, bucket order
    positions: tuple[int, ...]        # members' positions in their suite
    backend: str
    dtype: str
    row_width: int
    mode: str
    runs: int
    seed: int
    digest: bool
    device: str

    def __post_init__(self):
        if len(self.patterns) != len(self.positions):
            raise ValueError(f"{len(self.patterns)} patterns vs "
                             f"{len(self.positions)} positions")
        if not self.patterns:
            raise ValueError("work unit needs at least one member")

    @property
    def n_members(self) -> int:
        return len(self.patterns)

    @property
    def family(self) -> ExecKey:
        """Batch-stripped ExecKey: work units of one family may share a
        launch."""
        key = bucket_key(self.backend, self.spec, self.dtype,
                         self.row_width, self.mode, self.n_members)
        return dataclasses.replace(key, batch=0)


@dataclasses.dataclass(frozen=True)
class LaunchResult:
    """What one bucket launch produced; rows are in launch order.

    ``compiled`` is True iff this launch built the bucket callable
    (``ExecutorCache.serve_poly_info``): summed over launches it equals
    the cache's ``misses`` delta, which is how the serving scheduler
    attributes each build to one request.
    """
    key: ExecKey                      # the key actually served
    t_bucket: float                   # min over runs (paper §3.5)
    host_s: float                     # host seconds assembling the buffers
    batch: int                        # launched pattern-batch dim
    lanes: int                        # launched lane dim
    n_members: int                    # real members across all units
    real_lanes: tuple[int, ...]       # per member, launch order
    out: torch.Tensor | None          # batched output on the host (digests)
    device: str                       # name of the device that ran it
    compiled: bool
    lock_wait_s: float                # waiting for the device's lock


def make_work(plan: SuitePlan, *, backend: str = "torch", dtype=None,
              row_width: int = 1, runs: int = 10, mode: str = "store",
              seed: int = 0, digest: bool = False,
              device=None) -> list[BucketWork]:
    """Decompose a suite plan into one ``BucketWork`` per bucket."""
    B.check_backend(backend)
    B.check_mode(mode)
    dtype = B.check_dtype(dtype)
    dev = resolve_device(device)
    if runs < 1:
        raise ValueError("runs must be >= 1 (min-of-K timing needs a run)")
    return [
        BucketWork(spec=bucket.spec,
                   patterns=tuple(plan.patterns[pos]
                                  for pos in bucket.members),
                   positions=bucket.members, backend=backend,
                   dtype=str(dtype).removeprefix("torch."),
                   row_width=row_width, mode=mode, runs=runs, seed=seed,
                   digest=digest, device=str(dev))
        for bucket in plan.buckets
    ]


def launch(works: Sequence[BucketWork],
           cache: ExecutorCache | None = None) -> LaunchResult:
    """Run one bucket launch for one or more work units of one family.

    Their members are stacked into ONE padded launch; one warm-up call,
    then ``runs`` timed calls (a fresh zeroed dst per scatter run), all
    under the device's lock.
    """
    if not works:
        raise ValueError("launch needs at least one work unit")
    w0 = works[0]
    fam, runs = w0.family, w0.runs
    for w in works[1:]:
        if w.family != fam or w.runs != runs or w.device != w0.device:
            raise ValueError(
                f"cannot share a launch: {fam}/r{runs}/{w0.device} vs "
                f"{w.family}/r{w.runs}/{w.device}")
    cache = cache if cache is not None else default_cache()
    dev = resolve_device(w0.device)
    spec = w0.spec
    n_members = sum(w.n_members for w in works)
    key = bucket_key(w0.backend, spec, w0.dtype, w0.row_width, w0.mode,
                     n_members)
    fn, served, compiled = cache.serve_poly_info(
        key, lambda: build_bucket(w0.backend, spec.kind, key.mode, dev,
                                  cache.disk))
    patterns = [p for w in works for p in w.patterns]
    seeds = [w.seed for w in works for _ in w.patterns]
    want_out = any(w.digest for w in works)
    t0 = time.perf_counter()
    host, real_lanes = _host_members(spec, patterns, w0.row_width, seeds,
                                     batch=served.batch, mode=w0.mode)
    host_s = time.perf_counter() - t0
    t_wait = time.perf_counter()
    with device_lock(dev):
        lock_wait_s = time.perf_counter() - t_wait
        t0 = time.perf_counter()
        args = _to_device(spec, host, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        host_s += time.perf_counter() - t0
        t_bucket, out = timed_runs(fn, args, runs, dev,
                                   fresh_dst=spec.kind == "scatter")
        out = out.cpu() if want_out else None
        del args
    return LaunchResult(key=served, t_bucket=t_bucket, host_s=host_s,
                        batch=served.batch, lanes=spec.idx_len,
                        n_members=n_members, real_lanes=tuple(real_lanes),
                        out=out, device=device_name(dev), compiled=compiled,
                        lock_wait_s=lock_wait_s)


def demux(result: LaunchResult, work: BucketWork,
          offset: int = 0) -> list[tuple[int, RunResult]]:
    """Slice one work unit's per-pattern results back out of a launch.

    ``offset`` is the unit's first row in the launch.  Time (and host
    assembly time) is attributed by each member's real lanes over the
    launch's total lanes, scratch patterns included.  Digests hash the
    member's trimmed float32 rows: its (count*index_len, R) gathered rows,
    or its (footprint, R) scattered table.
    """
    elem_bytes = 4 * work.row_width
    total_lanes = (sum(result.real_lanes)
                   + (result.batch - result.n_members) * result.lanes)
    out: list[tuple[int, RunResult]] = []
    for i, pos in enumerate(work.positions):
        b = offset + i
        p = work.patterns[i]
        share = result.real_lanes[b] / total_lanes
        t_i = result.t_bucket * share
        dg = None
        if work.digest:
            n = (result.real_lanes[b] if work.spec.kind == "gather"
                 else p.footprint())
            trim = result.out[b, :n].numpy()
            dg = hashlib.sha256(
                np.ascontiguousarray(trim).tobytes()).hexdigest()
        out.append((pos, RunResult(
            pattern=p, backend=work.backend, device=result.device,
            elem_bytes=elem_bytes, row_width=work.row_width, runs=work.runs,
            time_s=t_i,
            measured_gbs=bw.paper_bandwidth(p, t_i, elem_bytes) / 1e9,
            host_s=result.host_s * share, out_digest=dg)))
    return out


def run_plan(plan: SuitePlan, *, backend: str = "torch", dtype=None,
             row_width: int = 1, runs: int = 10, mode: str = "store",
             seed: int = 0, cache: ExecutorCache | None = None,
             digest: bool = False, device=None) -> list[RunResult]:
    """Execute a SuitePlan with paper-style timing (min over ``runs``).

    Returns one RunResult per pattern, in the suite's original order: a
    serial driver over ``make_work`` -> ``launch`` -> ``demux``.  With
    ``digest``, each result carries the sha256 of its trimmed output, a
    pure function of (pattern, seed, mode, row width).
    """
    cache = cache if cache is not None else default_cache()
    works = make_work(plan, backend=backend, dtype=dtype,
                      row_width=row_width, runs=runs, mode=mode, seed=seed,
                      digest=digest, device=device)
    results: list[RunResult | None] = [None] * len(plan.patterns)
    for work in works:
        res = launch((work,), cache)
        for pos, r in demux(res, work):
            results[pos] = r
    return results  # type: ignore[return-value]
