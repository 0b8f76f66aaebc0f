"""Suite planner: pow-2 shape buckets, executor cache, one launch per bucket,
and placements of a bucket launch over several devices.

The port of ``repro.core.plan``, on PyTorch.

Plan.  ``SuitePlan.build`` groups patterns into shape buckets: a pattern's
flattened lane count ``count * index_len`` and its table ``footprint`` are
padded to the next power of two, and patterns that agree on ``(kind,
padded lanes, padded footprint)`` share a bucket.

Cache.  A bucket runs through a callable fetched from an ``ExecutorCache``,
an LRU keyed by ``ExecKey`` (backend, kind, shape, dtype, row width, mode,
padded batch, placement).  PyTorch compiles nothing, so ``misses`` counts
the bucket callables built, one per ``ExecKey``; on a card, building a
hopper bucket loads the libraries it launches (``build_bucket``;
``kernels._build`` compiles each once per process, or takes it from the
disk tier).  A second identical run builds nothing.  The lookup is batch-polymorphic as
in the reference: a bucket whose membership shrank reuses a warm key with
a larger padded batch (``best_batch``).  Builders run outside the cache's
lock, one per key (racing callers wait on its future), so ``misses`` stays
exact under threads and ``launch`` reports whether it built
(``LaunchResult.compiled``).  ``ExecutorCache(disk=)`` adds the disk tier
(``diskcache.DiskTier``): a build owner first restores the key from disk
(``disk_hits``, not ``misses``) and stores what it built;
``fault_hook("compile")`` runs just before a builder (``serve.faults``).
The launch that builds an entry takes the census of its untimed warm-up
call (``analysis.census``) and stores it beside the entry, so an audit of
the live cache (``ExecutorCache.entries``, spatterd's ``GET /lint``) reads
what each entry did and runs nothing; an entry restored from disk has no
census.  ``enumerate_executables`` lists every ``ExecKey`` a plan launches
under, through the same ``bucket_key``, without running anything.

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

Placements.  ``make_work(mesh=...)`` / ``run_plan(mesh=...)`` place a
bucket launch on a ``Placement``: an explicit list of devices arranged as
a ``(batch, lane)`` grid, run by this one process (one controller, as the
reference's jitted body over a mesh).  The batch axis splits the pattern
batch (whole patterns a shard), the lane axis the flattened lanes within
each pattern; ``sharding.gs_specs`` says which operand splits on which
axis, and tables are replicated along the lane axis.  ``pad_batch`` and
``pad_lanes`` round the launched dims up to shard multiples.  The host
buffers (and the store's keep mask, over the whole padded lane buffer)
are built as for one device, then cut by the grid and copied to each
shard's device outside the timed region (``Placement.place``).  A timed
call launches the bucket callable once on every shard, on its device,
and combines on the first device (``Placement.run``): gathers
concatenate their lanes; adds sum the shards' partials (each from zeros)
onto dst; a lane-split store stores each shard into zeros with its
coverage map (the store kernel's coverage output) and takes each row
from the one shard that covered it, else from dst, so it is bit-identical
to the one-device launch, ``-0.0`` included (the reference's ``psum`` of
such shards turns ``-0.0`` into ``+0.0``).  A placed launch is timed by
the host clock between synchronisations of every device it uses, and it
holds the lock of each distinct device, taken in the order of their
names (``device_locks``), so two launches over the same devices in
another order cannot deadlock.  Devices may repeat: the CPU tests place
shards on ``["cpu"] * n`` and one card on ``[cuda:0] * n``, which shows
that a placement is right, not how it scales.  The canonical placement
string is part of the ``ExecKey``, so placed and unplaced callables never
share an entry.

Not carried over: the reference's quiet pallas->xla degradation.  On a
CUDA tensor a kernel launches or raises, and a failed build fails its
launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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
from .sharding import gs_specs, shard_of


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

    def pad_waste(self, n_shards: int = 1, lane_shards: int = 1) -> float:
        """Fraction of launched lanes that are padding (0 = no waste):
        lane padding (the pow-2 bracket and the ``lane_shards`` multiple)
        and the scratch patterns of batch padding (the ``n_shards``
        multiple on the batch axis)."""
        return self.pad_waste_for([(n_shards, lane_shards)]
                                  * len(self.buckets))

    def pad_waste_for(self, placements) -> float:
        """``pad_waste`` under a per-bucket placement list (what
        ``mesh="auto"`` resolves to): each bucket pads to its own
        placement's shard multiples.  An entry is a ``Placement``, a
        ``(batch, lane)`` grid, or ``None`` (one device)."""
        real = sum(p.count * p.index_len for p in self.patterns)
        launched = 0
        for b, pl in zip(self.buckets, placements):
            bs, ls = (pl.grid if isinstance(pl, Placement)
                      else pl or (1, 1))
            launched += (pad_lanes(b.spec.idx_len, ls)
                         * pad_batch(len(b.members), bs))
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
    placement: str = ""   # Placement.placement; "" = one device, unplaced


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
        self._censuses: dict[ExecKey, object] = {}     # key -> its census
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
            self._censuses.pop(old, None)
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

    def set_census(self, key: ExecKey, census) -> None:
        """Keep ``key``'s census (``analysis.census.Census``) beside its
        entry while the entry lives."""
        with self._lock:
            if key in self._entries:
                self._censuses[key] = census

    def entries(self) -> list[tuple[ExecKey, Callable, object]]:
        """``(key, callable, census or None)`` of every entry, LRU order.

        For auditors (spatterd's ``GET /lint`` and ``/cost``): touches
        neither the LRU order nor the counters."""
        with self._lock:
            return [(k, fn, self._censuses.get(k))
                    for k, fn in self._entries.items()]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._families.clear()
            self._censuses.clear()
            self._pending.clear()
            self.hits = self.misses = self.batch_hits = self.disk_hits = 0


_DEFAULT_CACHE = ExecutorCache()


def default_cache() -> ExecutorCache:
    """Process-wide cache: repeated run_suite calls share warm entries."""
    return _DEFAULT_CACHE


def _bucket_fn(backend: str, kind: str, mode: str) -> Callable:
    """The bucket callable: gather (table, idx) or scatter (dst, idx, vals,
    keep[, cov]), one backend call for the whole bucket, or for one shard
    of a placed launch (a lane-split store passes its coverage map)."""
    if kind == "gather":
        def fn(table, idx):
            return B.gather_batched(table, idx, backend=backend)
    else:
        def fn(dst, idx, vals, keep, cov=None):
            return B.scatter_batched(dst, idx, vals, mode=mode,
                                     backend=backend, keep=keep, cov=cov)
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
               mode: str, n_members: int,
               placement: "Placement | None" = None) -> ExecKey:
    """The ``ExecKey`` a bucket launch is served under."""
    return ExecKey(backend=backend, kind=spec.kind, idx_len=spec.idx_len,
                   footprint=spec.footprint,
                   dtype=str(dtype).removeprefix("torch."),
                   row_width=row_width,
                   mode=mode if spec.kind == "scatter" else "",
                   batch=pad_batch(n_members, placement.batch_shards
                                   if placement else 1),
                   placement=placement.placement if placement else "")


OPERAND_NAMES = {"gather": ("table", "idx"),
                 "scatter": ("dst", "idx", "vals", "keep")}


def key_operands(key: ExecKey, device) -> tuple[torch.Tensor, ...]:
    """Zero operands of ``key``'s whole launch on ``device``, at its global
    shapes (``OPERAND_NAMES[key.kind]``; the lane dim is ``pad_lanes`` of
    the placement's lane shards): a gather reads row 0, a store with an
    all-False keep mask writes nothing, an add adds zeros to row 0."""
    _, l_shards, _ = placement_grid(key.placement)
    b, f, r = key.batch, key.footprint + 1, key.row_width
    n = pad_lanes(key.idx_len, l_shards)
    dtype = getattr(torch, key.dtype)
    idx = torch.zeros((b, n), dtype=torch.int32, device=device)
    table = torch.zeros((b, f, r), dtype=dtype, device=device)
    if key.kind == "gather":
        return table, idx
    vals = torch.zeros((b, n, r), dtype=dtype, device=device)
    keep = torch.zeros((b, n), dtype=torch.bool, device=device)
    return table, idx, vals, keep


def enumerate_executables(plan: "SuitePlan", *, backend: str = "torch",
                          dtype=None, row_width: int = 1,
                          mode: str = "store", placement=None,
                          mesh_axis: str = "data", device=None,
                          devices=None) -> list[tuple]:
    """Every bucket callable a run of ``plan`` asks the cache for, without
    building or running anything: ``[(key, builder, placement), ...]``,
    one per bucket, in bucket order.

    The keys come from ``bucket_key`` at each bucket's member count, so
    they equal the live cache's keys after the same ``run_plan``; a
    builder is ``build_bucket`` on the launch's first device.
    ``placement`` takes every ``make_work`` ``mesh=`` form, resolved over
    ``devices`` (default ``device_pool(device)``).
    """
    B.check_backend(backend)
    B.check_mode(mode)
    dtype = B.check_dtype(dtype)
    dev = _canonical_device(device)
    placements = resolve_mesh(plan, placement, mesh_axis=mesh_axis,
                              backend=backend, dtype=dtype,
                              row_width=row_width,
                              devices=(device_pool(dev) if devices is None
                                       else devices))
    out = []
    for bucket, pl in zip(plan.buckets, placements):
        key = bucket_key(backend, bucket.spec, dtype, row_width, mode,
                         len(bucket.members), pl)
        where = pl.devices[0] if pl else dev
        out.append((key, functools.partial(build_bucket, backend, key.kind,
                                           key.mode, where), pl))
    return out


# ---------------------------------------------------------------------------
# Placement: the (pattern-batch x lane) split over devices
# ---------------------------------------------------------------------------

def _canonical_device(device) -> torch.device:
    """``device`` with a CUDA index always given (``cuda`` -> ``cuda:N``,
    the current device), so equal devices compare and print equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Placement:
    """A bucket launch's devices, arranged as a ``(batch, lane)`` grid.

    ``devices`` lists one device per shard, row-major over the grid
    (shard ``(i, j)`` is ``devices[i * lanes + j]``); a device may be
    listed more than once.  The batch axis splits the pattern batch, the
    lane axis the flattened lanes within a pattern; a degenerate axis has
    no name (``None``), as in the reference's 1-D meshes.  ``placement``
    is the canonical string of the ``ExecKey``, the reference's: batch-only
    ``data=8/8dev``, lane-only ``lane:lane=8/8dev``, both
    ``data=4xlane=2/8dev``.
    """
    devices: tuple
    grid: tuple[int, int]
    batch_axis: str | None = "data"
    lane_axis: str | None = None

    def __post_init__(self):
        b, l = self.grid
        if b < 1 or l < 1:
            raise ValueError(f"placement grid must be >= 1, got {self.grid}")
        if self.batch_axis is None and self.lane_axis is None:
            raise ValueError("placement needs at least one axis")
        if self.batch_axis == self.lane_axis:
            raise ValueError(f"batch and lane axes must differ, both "
                             f"{self.batch_axis!r}")
        if (self.batch_axis is None and b != 1) or (
                self.lane_axis is None and l != 1):
            raise ValueError(f"grid {b}x{l} splits an axis that has no "
                             f"name (batch {self.batch_axis!r}, lane "
                             f"{self.lane_axis!r})")
        if len(self.devices) != b * l:
            raise ValueError(f"grid {b}x{l} needs {b * l} devices, "
                             f"{len(self.devices)} listed")
        object.__setattr__(self, "devices",
                           tuple(_canonical_device(d) for d in self.devices))

    @staticmethod
    def create(shape, *, batch_axis: str = "data", lane_axis: str = "lane",
               devices=None) -> "Placement":
        """A placement from a shape: an int ``N`` (batch-only over N
        devices) or a ``(b, l)`` tuple.  Degenerate dims collapse as in the
        reference, so ``(8, 1)`` and ``8`` give the same placement and
        ``(1, 8)`` is lane-only.  It takes the first ``b * l`` of
        ``devices`` (repeats allowed), by default of the CUDA devices, and
        raises when there are fewer: a placement never runs on fewer
        devices than it has shards."""
        if isinstance(shape, int):
            shape = (shape,)
        shape = tuple(int(s) for s in shape)
        if not 1 <= len(shape) <= 2 or any(s < 1 for s in shape):
            raise ValueError(f"placement shape must be N or (b, l) with "
                             f"b, l >= 1, got {shape}")
        b, l = shape[0], shape[1] if len(shape) == 2 else 1
        if devices is None:
            have = (torch.cuda.device_count() if torch.cuda.is_available()
                    else 0)
            listed = [torch.device("cuda", i) for i in range(have)]
            what = "CUDA devices"
        else:
            listed = list(devices)
            what = "devices listed"
        if b * l > len(listed):
            raise ValueError(f"placement {b}x{l} needs {b * l} devices, "
                             f"have {len(listed)} {what}")
        axes = ((batch_axis, None) if l == 1 else (None, lane_axis)
                if b == 1 else (batch_axis, lane_axis))
        return Placement(devices=tuple(listed[:b * l]), grid=(b, l),
                         batch_axis=axes[0], lane_axis=axes[1])

    @property
    def batch_shards(self) -> int:
        return self.grid[0]

    @property
    def lane_shards(self) -> int:
        return self.grid[1]

    @property
    def placement(self) -> str:
        """Canonical ``ExecKey`` string (the reference's forms)."""
        ndev = len(self.devices)
        if self.lane_axis is None:
            return f"{self.batch_axis}={self.batch_shards}/{ndev}dev"
        if self.batch_axis is None:
            return f"lane:{self.lane_axis}={self.lane_shards}/{ndev}dev"
        return (f"{self.batch_axis}={self.batch_shards}"
                f"x{self.lane_axis}={self.lane_shards}/{ndev}dev")

    def _coords(self, shard: int) -> dict:
        b, l = self.grid
        return {self.batch_axis: (shard // l, b),
                self.lane_axis: (shard % l, l)}

    def place(self, kind: str, args: Sequence[torch.Tensor], *,
              batched: bool = True) -> list[tuple]:
        """Cut the launch operands by ``sharding.gs_specs`` and copy each
        shard's block to its device: one operand tuple a shard, in
        ``devices`` order.  ``args`` are all of the kind's operands
        (gather: table, idx; scatter: dst, idx, vals, keep) or, for a
        scatter, the last three (its dst is per run: ``scratch``)."""
        in_specs, _ = gs_specs(kind, batched=batched,
                               batch_axis=self.batch_axis,
                               lane_axis=self.lane_axis)
        specs = in_specs[len(in_specs) - len(args):]
        return [tuple(shard_of(a, spec, self._coords(s)).to(dev)
                      .contiguous() for a, spec in zip(args, specs))
                for s, dev in enumerate(self.devices)]

    def scratch(self, mode: str, dst: torch.Tensor) -> list[tuple]:
        """Each shard's (dst, cov) for one scatter call, made before the
        timed region: with one lane shard, a copy of the shard's block of
        ``dst`` (the call stores or adds into it); with several, zeros
        (partials for the add, a store's rows) and, for a store, a zeroed
        (Bs, F) int32 coverage map.  ``dst`` is (B, F, R)."""
        b, l = self.grid
        out = []
        for s, dev in enumerate(self.devices):
            block = shard_of(dst, (self.batch_axis,), self._coords(s))
            if l == 1:
                out.append((block.to(dev, copy=True), None))
                continue
            cov = (torch.zeros(block.shape[:2], dtype=torch.int32,
                               device=dev) if mode == "store" else None)
            out.append((torch.zeros(block.shape, dtype=block.dtype,
                                    device=dev), cov))
        return out

    def run(self, fn: Callable, kind: str, mode: str, shards: list,
            scratch: list | None = None,
            dst: torch.Tensor | None = None) -> torch.Tensor:
        """One placed call: ``fn`` (the bucket callable) on every shard, on
        its device, then the combine on ``devices[0]``.  ``shards`` come
        from ``place``; a scatter also takes ``scratch`` and its (B, F,
        R) ``dst`` on ``devices[0]``, the rows no shard writes."""
        b, l = self.grid
        dev0 = self.devices[0]
        outs = []
        for s, args in enumerate(shards):
            if kind == "gather":
                outs.append(fn(*args))
            else:
                d, cov = scratch[s]
                if cov is None:
                    fn(d, *args)
                else:
                    fn(d, *args, cov)
                outs.append(d)
        blocks = []
        for i in range(b):
            parts = [outs[i * l + j].to(dev0) for j in range(l)]
            if kind == "gather" or l == 1:
                blocks.append(torch.cat(parts, dim=1) if l > 1 else parts[0])
                continue
            base = shard_of(dst, (self.batch_axis,), self._coords(i * l))
            if mode == "add":
                total = parts[0]
                for p in parts[1:]:
                    total = total + p
                blocks.append(base + total)
            else:
                # at most one shard covers a row (the keep mask was made
                # before the split): a select, exact for every bit
                for j, p in enumerate(parts):
                    cov = scratch[i * l + j][1].to(dev0)
                    base = torch.where(cov[..., None] != 0, p, base)
                blocks.append(base)
        return torch.cat(blocks) if b > 1 else blocks[0]

    def synchronize(self) -> None:
        """Wait for every CUDA device of the placement."""
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)


def as_placement(mesh, mesh_axis: str = "data",
                 devices=None) -> Placement | None:
    """Normalise a ``mesh=`` form to a Placement (or None).

    ``None``/``0``/empty -> None (one device, unplaced); a ``Placement``
    passes through; an int ``N`` or a ``(b, l)`` tuple goes through
    ``Placement.create`` over ``devices`` (default: the CUDA devices),
    which raises when there are too few.
    """
    if mesh is None or isinstance(mesh, Placement):
        return mesh
    if isinstance(mesh, int):
        return (Placement.create(mesh, batch_axis=mesh_axis, devices=devices)
                if mesh else None)
    shape = tuple(mesh)
    if not shape:
        return None
    return Placement.create(shape, batch_axis=mesh_axis, devices=devices)


def auto_placements(plan: SuitePlan, mesh: str, *, mesh_axis: str = "data",
                    backend: str = "torch", dtype=None, row_width: int = 1,
                    devices=None):
    """Resolve ``mesh="auto"`` / ``"auto-suite"`` through the cost model
    (``cost.auto_placement``) over ``devices`` (default: the CUDA
    devices).

    ``"auto"`` picks a placement per bucket: each bucket's members form a
    one-bucket plan scored alone, and a per-bucket list comes back.
    ``"auto-suite"`` picks one shape for the whole suite and returns one
    Placement (or None).  A ``(1, 1)`` choice is None, the unplaced key
    ``""``, as on one device.  Equal shapes share one Placement.
    """
    from . import cost
    if devices is None:
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    else:
        n_dev = len(devices)
    kw = dict(n_devices=max(n_dev, 1), dtype=dtype, row_width=row_width,
              backend=backend)
    if mesh == "auto-suite":
        return as_placement(cost.auto_placement(plan, **kw), mesh_axis,
                            devices)
    if mesh != "auto":
        raise ValueError(f"unknown auto mesh mode {mesh!r}; "
                         f"expected 'auto' or 'auto-suite'")
    memo: dict = {}
    out = []
    for bucket in plan.buckets:
        sub = SuitePlan(
            patterns=tuple(plan.patterns[p] for p in bucket.members),
            buckets=(Bucket(spec=bucket.spec,
                            members=tuple(range(len(bucket.members)))),))
        shape = cost.auto_placement(sub, **kw)
        if shape not in memo:
            memo[shape] = as_placement(shape, mesh_axis, devices)
        out.append(memo[shape])
    return out


def resolve_mesh(plan: SuitePlan, mesh, *, mesh_axis: str = "data",
                 backend: str = "torch", dtype=None, row_width: int = 1,
                 devices=None) -> list:
    """Every ``mesh=`` form as one ``Placement | None`` a bucket: an
    ``as_placement`` form (the same placement for every bucket), a
    per-bucket list of them, or ``"auto"`` / ``"auto-suite"``."""
    if isinstance(mesh, str):
        mesh = auto_placements(plan, mesh, mesh_axis=mesh_axis,
                               backend=backend, dtype=dtype,
                               row_width=row_width, devices=devices)
    if isinstance(mesh, list):
        if len(mesh) != len(plan.buckets):
            raise ValueError(f"{len(mesh)} placements for "
                             f"{len(plan.buckets)} buckets")
        return [as_placement(m, mesh_axis, devices) for m in mesh]
    return [as_placement(mesh, mesh_axis, devices)] * len(plan.buckets)


def placement_grid(placement: str) -> tuple[int, int, int]:
    """Parse a canonical ``ExecKey.placement`` string back to
    ``(batch_shards, lane_shards, n_devices)``; ``""`` is ``(1, 1, 1)``.
    The inverse of ``Placement.placement`` for its three forms."""
    if not placement:
        return (1, 1, 1)
    body, sep, dev = placement.rpartition("/")
    if not sep or not dev.endswith("dev"):
        raise ValueError(f"not a canonical placement string: {placement!r}")
    ndev = int(dev[:-len("dev")])
    if body.startswith("lane:"):
        return (1, int(body.split("=", 1)[1]), ndev)
    if "x" in body:
        b_part, l_part = body.split("x", 1)
        return (int(b_part.split("=", 1)[1]),
                int(l_part.split("=", 1)[1]), ndev)
    return (int(body.split("=", 1)[1]), 1, ndev)


def placement_axes(placement: str) -> dict[str, int]:
    """Parse a canonical ``ExecKey.placement`` string to its named axes,
    e.g. ``"data=4xlane=2/8dev"`` -> ``{"data": 4, "lane": 2}``; ``""`` ->
    ``{}``."""
    if not placement:
        return {}
    body, sep, dev = placement.rpartition("/")
    if not sep or not dev.endswith("dev"):
        raise ValueError(f"not a canonical placement string: {placement!r}")
    if body.startswith("lane:"):
        parts = [body[len("lane:"):]]
    elif "x" in body:
        parts = body.split("x", 1)
    else:
        parts = [body]
    out = {}
    for part in parts:
        name, _, size = part.partition("=")
        out[name] = int(size)
    return out


# ---------------------------------------------------------------------------
# Bucket assembly
# ---------------------------------------------------------------------------

# One lock per device, for the whole process: every cache and scheduler in
# the process shares the device and its default stream (module docstring).
_DEVICE_LOCKS: dict[str, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_lock(device) -> threading.Lock:
    """The lock a launch holds while it has work on ``device`` (``cuda``
    and ``cuda:N`` of the current device share one)."""
    name = str(_canonical_device(device))
    with _DEVICE_LOCKS_GUARD:
        lock = _DEVICE_LOCKS.get(name)
        if lock is None:
            lock = _DEVICE_LOCKS[name] = threading.Lock()
        return lock


@contextlib.contextmanager
def device_locks(devices):
    """Hold the lock of every distinct device in ``devices``, taken in the
    order of their names: two launches that lock the same devices take
    them in one order, so neither waits on the other forever."""
    names = {str(_canonical_device(d)) for d in devices}
    locks = [device_lock(name) for name in sorted(names)]
    held = []
    try:
        for lock in locks:
            lock.acquire()
            held.append(lock)
        yield
    finally:
        for lock in reversed(held):
            lock.release()


def _host_members(spec: BucketSpec, patterns: Sequence[Pattern],
                  row_width: int, seeds: Sequence[int],
                  batch: int | None = None, mode: str = "store",
                  lanes: int | None = None):
    """Stack member patterns (of one bucket shape) into host buffers.

    Returns (host, real_lanes): ``host`` is (table, idx) for gathers and
    (idx, vals, keep) for scatters, numpy arrays; real_lanes[b] is member
    b's un-padded lane count.  ``batch`` (default ``pad_batch`` of the
    member count) sets the padded batch, ``lanes`` (default the bucket's
    idx_len) the launched lane dim: a lane-split launch passes
    ``pad_lanes``' shard multiple, and the extra lanes are padding lanes.
    Member b's buffers come from ``make_host_buffers(p, row_width,
    seeds[b])``.  In add mode the keep mask is an all-False placeholder
    the kernel never reads.
    """
    nb = len(patterns)
    if len(seeds) != nb:
        raise ValueError(f"{len(seeds)} seeds for {nb} members")
    b_pad = pad_batch(nb) if batch is None else batch
    if b_pad < nb:
        raise ValueError(f"batch {b_pad} < member count {nb}")
    n_pad = spec.idx_len if lanes is None else lanes
    if n_pad < spec.idx_len:
        raise ValueError(f"lanes {n_pad} < bucket idx_len {spec.idx_len}")
    f_pad, r = spec.footprint, row_width
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
    device: str                       # placed: its first device
    placement: Placement | None = None

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
                         self.row_width, self.mode, self.n_members,
                         self.placement)
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
    lanes: int                        # launched lane dim (pad_lanes)
    n_members: int                    # real members across all units
    real_lanes: tuple[int, ...]       # per member, launch order
    out: torch.Tensor | None          # batched output on the host (digests)
    device: str                       # name of the device that ran it
    compiled: bool
    lock_wait_s: float                # waiting for the device's lock


def device_pool(device=None) -> list | None:
    """The devices a ``mesh=`` shape is placed on for a run on ``device``:
    the CUDA devices (``None``, ``Placement.create``'s default) or the one
    CPU, where a placement of several shards raises."""
    dev = resolve_device(device)
    return None if dev.type == "cuda" else [dev]


def make_work(plan: SuitePlan, *, backend: str = "torch", dtype=None,
              row_width: int = 1, runs: int = 10, mode: str = "store",
              seed: int = 0, digest: bool = False, device=None,
              mesh=None, mesh_axis: str = "data") -> list[BucketWork]:
    """Decompose a suite plan into one ``BucketWork`` per bucket.

    ``mesh`` places the launches (``resolve_mesh``): a ``Placement``, an
    int ``N`` or ``(b, l)`` shape over ``device_pool(device)``, a
    per-bucket list, or ``"auto"`` / ``"auto-suite"``.
    """
    B.check_backend(backend)
    B.check_mode(mode)
    dtype = B.check_dtype(dtype)
    dev = _canonical_device(device)
    if runs < 1:
        raise ValueError("runs must be >= 1 (min-of-K timing needs a run)")
    placements = resolve_mesh(plan, mesh, mesh_axis=mesh_axis,
                              backend=backend, dtype=dtype,
                              row_width=row_width,
                              devices=device_pool(dev))
    return [
        BucketWork(spec=bucket.spec,
                   patterns=tuple(plan.patterns[pos]
                                  for pos in bucket.members),
                   positions=bucket.members, backend=backend,
                   dtype=str(dtype).removeprefix("torch."),
                   row_width=row_width, mode=mode, runs=runs, seed=seed,
                   digest=digest,
                   device=str(pl.devices[0] if pl else dev), placement=pl)
        for bucket, pl in zip(plan.buckets, placements)
    ]


def launch(works: Sequence[BucketWork],
           cache: ExecutorCache | None = None) -> LaunchResult:
    """Run one bucket launch for one or more work units of one family.

    Their members are stacked into ONE padded launch; one warm-up call,
    then ``runs`` timed calls (a fresh zeroed dst per scatter run), all
    under the lock of every device the launch uses.  A placed launch
    (``BucketWork.placement``) runs every shard and the combine in each
    call (``Placement.run``), timed by the host clock between
    synchronisations of its devices.
    """
    if not works:
        raise ValueError("launch needs at least one work unit")
    w0 = works[0]
    fam, runs = w0.family, w0.runs
    for w in works[1:]:
        if (w.family != fam or w.runs != runs or w.device != w0.device
                or w.placement != w0.placement):
            raise ValueError(
                f"cannot share a launch: {fam}/r{runs}/{w0.device} vs "
                f"{w.family}/r{w.runs}/{w.device}")
    cache = cache if cache is not None else default_cache()
    placement = w0.placement
    dev = placement.devices[0] if placement else resolve_device(w0.device)
    spec = w0.spec
    n_members = sum(w.n_members for w in works)
    key = bucket_key(w0.backend, spec, w0.dtype, w0.row_width, w0.mode,
                     n_members, placement)
    fn, served, compiled = cache.serve_poly_info(
        key, lambda: build_bucket(w0.backend, spec.kind, key.mode, dev,
                                  cache.disk))
    lanes = pad_lanes(spec.idx_len,
                      placement.lane_shards if placement else 1)
    patterns = [p for w in works for p in w.patterns]
    seeds = [w.seed for w in works for _ in w.patterns]
    want_out = any(w.digest for w in works)
    t0 = time.perf_counter()
    host, real_lanes = _host_members(spec, patterns, w0.row_width, seeds,
                                     batch=served.batch, mode=w0.mode,
                                     lanes=lanes)
    host_s = time.perf_counter() - t0

    def warm(shards):
        """The warm-up that takes a new entry's census (None: not new);
        its operand bytes are the launch's global ones: the host buffers
        and, for a scatter, the dst."""
        if not compiled:
            return None
        nbytes = sum(a.nbytes for a in host)
        if spec.kind == "scatter":
            nbytes += (served.batch * (spec.footprint + 1) * w0.row_width
                       * getattr(torch, w0.dtype).itemsize)
        names = OPERAND_NAMES[spec.kind][-len(shards[0]):]
        held = {n: [sh[i] for sh in shards] for i, n in enumerate(names)}

        def warmup(call):
            from .analysis.census import take
            c, out = take(lambda wrap: call(wrap(fn)), device=dev,
                          operands=held, operand_bytes=nbytes)
            cache.set_census(served, c)
            return out
        return warmup

    t_wait = time.perf_counter()
    with device_locks(placement.devices if placement else (dev,)):
        lock_wait_s = time.perf_counter() - t_wait
        t0 = time.perf_counter()
        if placement is None:
            args = _to_device(spec, host, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            host_s += time.perf_counter() - t0
            t_bucket, out = timed_runs(fn, args, runs, dev,
                                       fresh_dst=spec.kind == "scatter",
                                       warmup=warm([args]))
        else:
            args = placement.place(spec.kind,
                                   [torch.from_numpy(a) for a in host])
            placement.synchronize()
            host_s += time.perf_counter() - t0
            t_bucket, out = _timed_placed(fn, placement, spec, w0.mode,
                                          args, runs, warmup=warm(args))
        out = out.cpu() if want_out else None
        del args
    return LaunchResult(key=served, t_bucket=t_bucket, host_s=host_s,
                        batch=served.batch, lanes=lanes,
                        n_members=n_members, real_lanes=tuple(real_lanes),
                        out=out, device=device_name(dev), compiled=compiled,
                        lock_wait_s=lock_wait_s)


def _timed_placed(fn: Callable, placement: Placement, spec: BucketSpec,
                  mode: str, shards: list, runs: int, warmup=None):
    """``timed_runs`` for a placed launch: one warm-up call, then ``runs``
    calls, each timed by the host clock from a synchronisation of every
    device of the placement to the next, so the region holds every
    shard's launch and the combine.  A scatter's dst and shard scratch
    are made fresh for each call, before its timed region.  ``warmup`` as
    for ``timed_runs``.  Returns ``(min seconds, output of the last
    call)``."""
    times = []
    out = None
    for i in range(runs + 1):
        out = dst = scratch = None
        if spec.kind == "scatter":
            b = shards[0][0].shape[0] * placement.batch_shards
            dst = torch.zeros((b, spec.footprint + 1, shards[0][1].shape[2]),
                              dtype=torch.float32,
                              device=placement.devices[0])
            scratch = placement.scratch(mode, dst)
        placement.synchronize()
        t0 = time.perf_counter()
        if i == 0 and warmup is not None:
            out = warmup(lambda f: placement.run(f, spec.kind, mode, shards,
                                                 scratch, dst))
        else:
            out = placement.run(fn, spec.kind, mode, shards, scratch, dst)
        placement.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times[1:]), out                         # paper §3.5


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
        sm = bw.h100_sector_model(p, elem_bytes)
        out.append((pos, RunResult(
            pattern=p, backend=work.backend, device=result.device,
            elem_bytes=elem_bytes, row_width=work.row_width, runs=work.runs,
            time_s=t_i,
            measured_gbs=bw.paper_bandwidth(p, t_i, elem_bytes) / 1e9,
            modeled_gbs=sm.modeled_gbs,
            sector_efficiency=sm.sector_efficiency,
            host_s=result.host_s * share, out_digest=dg)))
    return out


def run_plan(plan: SuitePlan, *, backend: str = "torch", dtype=None,
             row_width: int = 1, runs: int = 10, mode: str = "store",
             seed: int = 0, cache: ExecutorCache | None = None,
             digest: bool = False, device=None, mesh=None,
             mesh_axis: str = "data") -> list[RunResult]:
    """Execute a SuitePlan with paper-style timing (min over ``runs``).

    Returns one RunResult per pattern, in the suite's original order: a
    serial driver over ``make_work`` -> ``launch`` -> ``demux``.  With
    ``digest``, each result carries the sha256 of its trimmed output, a
    pure function of (pattern, seed, mode, row width): placements do not
    change it.  ``mesh`` places every bucket launch (``make_work``); the
    bandwidth reported is the launch's over all its shards.
    """
    cache = cache if cache is not None else default_cache()
    works = make_work(plan, backend=backend, dtype=dtype,
                      row_width=row_width, runs=runs, mode=mode, seed=seed,
                      digest=digest, device=device, mesh=mesh,
                      mesh_axis=mesh_axis)
    results: list[RunResult | None] = [None] * len(plan.patterns)
    for work in works:
        res = launch((work,), cache)
        for pos, r in demux(res, work):
            results[pos] = r
    return results  # type: ignore[return-value]
