"""Closed-form launch-parameter choice for the Hopper kernels.

The port of ``repro.kernels.autotune``: the reference picks each Pallas
kernel's tiles per kernel-visible geometry; this module picks each CUDA
kernel's launch parameters the same way.  A ``TileKey`` is the geometry a
launch sees (under a placement, one shard's local geometry) and the card
it runs on; a ``TileChoice`` holds Hopper's parameters:

    op              chooses                    legacy rule (``disabled()``)
    gather          smem: the regime (0/1)     ``gather_rows.ops.use_smem``
    gather_global   vecs: loads in flight a    the C rule (``csrc/common.cuh``
                    thread, 1 or deep          ``deep_for``) in Python
    gather_smem     lanes_per_cta              ``smem_lanes_per_cta``
    scatter_store   vecs, as the gather        the C rule
    scatter_add     smem: the hot-row route    the streaming route (0)
                    (0/1)
    paged_decode    splits of a row's pages    ``paged_splits``

Candidates are only launches the compiled kernels already take: the deep
and shallow instances (``vecs`` 1, or ``kVecs`` = 4 for a D = 1 row and
``kElems`` = 8 otherwise), any lanes a CTA, any split count.  Keys carry
the operands' dtype (``TileKey.dtype``), so a 16-bit bucket never takes a
float32 bucket's choice; its costs count its 2-byte elements (8 lanes to
a 16-byte vector), with the constants fitted on float32.  Each is
scored by a closed-form cost in seconds (no timing, no RNG) and the
cheapest wins; ties go to the first candidate in ascending order, so a
choice is the same in every process.  The cost constants were fitted to a
sweep on the card (``probes/autotune_probe.py``; see each constant).

The search reads the card from ``TileKey.platform``:
``cuda:sm90:132sm:2048t`` (compute capability, SMs, threads an SM), with
``:120cta`` appended for the two smem ops (the CTAs of the smem kernel
that fit at once for that (V, D), ``gather_rows.ops.smem_resident_ctas``),
so a choice written on one card is never seeded into another's.  On the
CPU the wrappers run the plain versions, which ignore every choice; keys
made there name the platform ``cpu`` and search as on an H100 SXM
(``CPU_FACTS``), so the CPU exercises the same search.

Choices are memoised process-wide (``choose``, ``lookup``, ``stats``) and
travel in a wire format (``to_wire``/``seed_wire``): ``DiskTier`` writes
the choices of each bucket callable into its entry's header and seeds
them back on restore, so a warm restart searches nothing.  The choice
stays out of ``ExecKey``: it is a pure function of the ``TileKey``, and a
key still holds one callable.  ``disabled()`` serves the legacy rules for
a before/after leg, without touching the memo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

from ..bandwidth import K_VECS, LOAD_LATENCY_S

OPS = ("gather", "gather_global", "gather_smem", "scatter_store",
       "scatter_add", "paged_decode")
K_ELEMS = 8           # csrc: kElems, elements a thread (D > 1)


@dataclasses.dataclass(frozen=True)
class TileKey:
    """The geometry a launch sees, and the card.

    For the Spatter kernels: ``batch`` patterns B, ``lanes`` N, ``rows`` V
    of the table or dst, ``width`` D.  Under a placement these are one
    shard's local dims, so a 2-way lane split of a 2^27-lane bucket
    chooses for 2^26 lanes.  For ``paged_decode``: ``batch`` the (row, KV
    head) pairs B x KVH, ``lanes`` the pages a row's table holds,
    ``rows`` the positions a page, ``width`` G x dh.  ``dtype`` is the
    operands' (``float32``, ``bfloat16``, ``float16``; ``itemsize``
    gives its bytes).  ``platform`` as in the module note.
    """
    op: str
    batch: int
    lanes: int
    rows: int
    width: int
    dtype: str
    platform: str


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """A launch's parameters; the fields an op does not use stay 0."""
    smem: int = 0           # gather, scatter_add: 1 = the shared-memory
                            # kernel (the add's hot-row route)
    lanes_per_cta: int = 0  # gather_smem
    vecs: int = 0           # gather_global, scatter_store
    splits: int = 0         # paged_decode

    def to_wire(self) -> list[int]:
        return [self.smem, self.lanes_per_cta, self.vecs, self.splits]

    @staticmethod
    def from_wire(v) -> "TileChoice":
        smem, lanes, vecs, splits = (int(x) for x in v)
        return TileChoice(smem=smem, lanes_per_cta=lanes, vecs=vecs,
                          splits=splits)


# -- the card -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CardFacts:
    sms: int
    threads_per_sm: int
    resident_ctas: int = 0   # smem CTAs at once (smem ops only)

    @property
    def threads(self) -> int:
        return self.sms * self.threads_per_sm


# What the CPU's keys search as: an H100 SXM (NVIDIA's data sheet: 132 SMs,
# 2,048 threads an SM; 15 clusters of 8 smem CTAs at once, what the CUDA
# runtime answered for demo's table on an NVIDIA H100 80GB HBM3, PERF.md)
CPU_FACTS = CardFacts(sms=132, threads_per_sm=2048, resident_ctas=120)
_CARDS: dict[int, str] = {}


def cuda_platform(index: int, resident_ctas: int | None = None) -> str:
    """The platform string of CUDA device ``index`` (asked once), with the
    smem kernel's resident CTAs appended where given."""
    base = _CARDS.get(index)
    if base is None:
        import torch
        p = torch.cuda.get_device_properties(index)
        base = _CARDS[index] = (
            f"cuda:sm{p.major}{p.minor}:{p.multi_processor_count}sm:"
            f"{p.max_threads_per_multi_processor}t")
    return base if resident_ctas is None else f"{base}:{resident_ctas}cta"


def facts(platform: str) -> CardFacts:
    """The card a platform string names (``cpu``: ``CPU_FACTS``)."""
    if platform == "cpu":
        return CPU_FACTS
    parts = platform.split(":")
    if len(parts) not in (4, 5) or parts[0] != "cuda":
        raise ValueError(f"bad platform {platform!r}")
    sms = int(parts[2].removesuffix("sm"))
    tps = int(parts[3].removesuffix("t"))
    cta = int(parts[4].removesuffix("cta")) if len(parts) == 5 else 0
    return CardFacts(sms=sms, threads_per_sm=tps, resident_ctas=cta)


# -- cost model ---------------------------------------------------------------
# Every constant comes from probes/autotune_probe.py's sweep on an NVIDIA
# H100 80GB HBM3 at 700.00 W (device time by torch.profiler; PERF.md), of
# float32 tables.  16-bit keys use them unchanged: the bytes and vectors
# each cost counts follow the key's element size; the rates were not
# fitted at 2 bytes.
#
# vecs (the global gather and the store; LOAD_LATENCY_S is bandwidth's):
# the deep instance took 2.42 us against the shallow one's 1.36 at 4,096
# lanes, so a thread's three extra vectors cost ~0.35 us each; the
# CLI gather (2^27 lanes, 12 bytes a lane) streamed at 3.1e12 B/s.
BYTES_PER_S = 3.1e12       # the global kernels' streaming rate
VEC_S = 3.5e-7             # a thread's time a vector or element it takes
# the regime (least squares over the sweep's 40 points of tables from 4 KiB
# to 227 KB, N / V from 1/2 to 64, contiguous and random lanes, D = 1):
# the global gather's fixed time and its time a lane, the mean of
# contiguous lanes' 1.55e-12 s and random lanes' 3.97e-12 s (the key does
# not say which a pattern has); the smem gather's fixed time, its time a
# wave of clusters, its staging rate, a CTA's time a lane and its
# streaming rate (rms error of the fit: 7% in log time)
GLOBAL_LAUNCH_S = 1.47e-6
GLOBAL_LANE_S = 2.76e-12
SMEM_LAUNCH_S = 3.1e-7
SMEM_WAVE_S = 2.02e-6
STAGE_BYTES_PER_S = 7.97e10
SMEM_LANE_S = 1.086e-10
SMEM_BYTES_PER_S = 2.59e12


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def itemsize(key: TileKey) -> int:
    """Bytes an element of the key's dtype."""
    from ._build import SPATTER_DTYPES
    return SPATTER_DTYPES[key.dtype]


def vec_lanes(key: TileKey) -> int:
    """Elements a 16-byte vector of the key's dtype: 4 floats, 8 16-bit
    values."""
    return 16 // itemsize(key)


def deep_vecs(width: int) -> int:
    """The deep instance's loads a thread: kVecs for a D = 1 row (16-byte
    vectors of 4 float32 or 8 16-bit lanes), kElems otherwise."""
    return K_VECS if width == 1 else K_ELEMS


def _work(key: TileKey) -> int:
    """Vectors (D = 1: ``vec_lanes`` lanes each) or elements (a 16-byte
    vector where D is a multiple of ``vec_lanes``, else one element) the
    global kernel's threads share, for operands in phase at a 16-byte
    boundary, as the planner's are."""
    total = key.batch * key.lanes
    lanes = vec_lanes(key)
    if key.width == 1:
        return total // lanes
    return total * (key.width // lanes if key.width % lanes == 0
                    else key.width)


def _global_bytes(key: TileKey) -> int:
    """Bytes a global gather or store moves: index, keep mask (store),
    row read, row written."""
    lanes = key.batch * key.lanes
    row = itemsize(key) * key.width
    if key.op == "scatter_store":
        return lanes * (4 + 1 + 2 * row)
    return lanes * (4 + 2 * row)


def vecs_cost(key: TileKey, vecs: int) -> float:
    """Seconds of a global gather or store with ``vecs`` vectors (or
    elements) a thread: the larger of its bytes at the streaming rate and
    the waves of the card's threads, each a load round trip
    (``bandwidth.LOAD_LATENCY_S``, the latency ``pipeline_model`` reads)
    plus the thread's time for its vectors."""
    card = facts(key.platform)
    threads = max(1, _ceil(_work(key), vecs))
    waves = _ceil(threads, card.threads)
    latency = waves * (LOAD_LATENCY_S + vecs * VEC_S)
    return max(_global_bytes(key) / BYTES_PER_S, latency)


def global_cost(key: TileKey) -> float:
    """Seconds of the global gather, for the regime: a fixed term and a
    time a lane."""
    return GLOBAL_LAUNCH_S + key.batch * key.lanes * key.width * GLOBAL_LANE_S


def smem_cost(key: TileKey, lanes_per_cta: int) -> float:
    """Seconds of the smem gather at ``lanes_per_cta``: a fixed term, then
    the waves of clusters the card holds at once, each staging the table
    and gathering its CTAs' lanes, or the lanes' bytes at the streaming
    rate if longer."""
    from .gather_rows.ops import SMEM_CLUSTER
    card = facts(key.platform)
    clusters = key.batch * _ceil(_ceil(key.lanes, lanes_per_cta),
                                 SMEM_CLUSTER)
    waves = _ceil(clusters, max(1, card.resident_ctas // SMEM_CLUSTER))
    table = key.rows * key.width * itemsize(key)
    per_wave = (SMEM_WAVE_S + table / STAGE_BYTES_PER_S
                + lanes_per_cta * key.width * SMEM_LANE_S)
    stream = (key.batch * key.lanes * (4 + itemsize(key) * key.width)
              / SMEM_BYTES_PER_S)
    return SMEM_LAUNCH_S + max(waves * per_wave, stream)


def smem_candidates(key: TileKey) -> list[int]:
    """Lanes a CTA the smem search weighs, ascending: powers of two from
    256 below one cluster a pattern, and one cluster a pattern."""
    from .gather_rows.ops import SMEM_CLUSTER
    whole = max(1, _ceil(key.lanes, SMEM_CLUSTER))
    out, lanes = [], 256
    while lanes < whole:
        out.append(lanes)
        lanes *= 2
    return out + [whole]


def smem_feasible(key: TileKey) -> bool:
    """Whether the smem kernel takes this gather: the legacy gate
    (``use_smem``: the table fits in 227 KB, V <= 2N) on a card where a
    cluster of its CTAs fits."""
    from .gather_rows.ops import SMEM_CLUSTER, use_smem
    return (use_smem(key.rows, key.lanes, key.width, itemsize(key))
            and facts(key.platform).resident_ctas >= SMEM_CLUSTER)


def _argmin(cands, cost: Callable) -> tuple:
    """(first candidate of least cost, its cost): ties go to the first."""
    best, best_cost = None, None
    for c in cands:
        v = cost(c)
        if best_cost is None or v < best_cost:
            best, best_cost = c, v
    return best, best_cost


def _search_vecs(key: TileKey) -> TileChoice:
    vecs, _ = _argmin((1, deep_vecs(key.width)), lambda v: vecs_cost(key, v))
    return TileChoice(vecs=vecs)


def _search_gather_smem(key: TileKey) -> TileChoice:
    lanes, _ = _argmin(smem_candidates(key), lambda n: smem_cost(key, n))
    return TileChoice(smem=1, lanes_per_cta=lanes)


def _search_gather(key: TileKey) -> TileChoice:
    """The regime: the smem kernel only where it is feasible and its best
    cost is below the global kernel's."""
    if not smem_feasible(key):
        return TileChoice(smem=0)
    s = min(smem_cost(key, n) for n in smem_candidates(key))
    return TileChoice(smem=int(s < global_cost(key)))


# the add's hot-row route (csrc/scatter_rows.cu, scatter_add_rows_hot_kernel),
# from probes/hot_row_add_probe.py's sweep (D = 1 tables of V rows taking K
# lanes a row in random order, V 1 to 16384, K 4 to 16384, B 1 and 8,
# float32 and bfloat16, both routes forced; CUDA events a call, an NVIDIA
# H100 80GB HBM3 at 700.00 W, PERF.md).  Below K = 256 the streaming route
# was as fast or faster, but at B = 8 with V >= 4096 (K = 64, V = 4096:
# 0.074 against 0.040 ms in bfloat16) and in a few calls of ~0.03 ms
# where both are launch-bound; from K = 256 the hot-row route won or
# tied (within 0.005 ms, calls of ~0.03-0.05 ms) up to V = 4096, and at V
# = 16384 (64 KB of accumulators) won from K = 1024 (0.127 against 0.284
# ms in bfloat16) and lost at K = 256, B = 1 (0.096 against 0.086); at K
# = 16384 it won by 2-40 x.  Past 64 KB it was not measured: there only a
# forced ``smem`` takes the route, up to the kernel's own limit (a block's
# 227 KB, ``kHotSmemMax``; past it the launch is refused).
HOT_SMEM_BYTES = 64 * 1024   # a pattern's V x D float32 sums, at most
HOT_MIN_LANES_A_ROW = 256    # K from which the rule takes the route
HOT_CTAS_PER_SM = 2          # blocks an SM of a grid that fills the card
HOT_LANES_PER_ACC = 4        # lanes a block takes an accumulator, least


def hot_ctas(key: TileKey) -> int:
    """Blocks a pattern on the hot-row route: enough to fill the card
    (``HOT_CTAS_PER_SM`` an SM over the key's B patterns), but no more than
    leave each block ``HOT_LANES_PER_ACC`` lanes an accumulator; at least
    one.  Each rounds its sums to the dtype once, so a row takes at most
    this many roundings (``ref.hot_row_rounds``)."""
    fill = _ceil(HOT_CTAS_PER_SM * facts(key.platform).sms, key.batch)
    work = key.lanes // (HOT_LANES_PER_ACC * max(1, key.rows))
    return max(1, min(fill, work))


def hot_min_lanes(key: TileKey) -> int:
    """The lanes a pattern from which the rule takes the hot-row route
    (``HOT_MIN_LANES_A_ROW`` a row)."""
    return HOT_MIN_LANES_A_ROW * key.rows


def _search_scatter_add(key: TileKey) -> TileChoice:
    return TileChoice(smem=int(
        0 < key.rows * key.width * 4 <= HOT_SMEM_BYTES
        and key.lanes >= hot_min_lanes(key)))


def paged_cost(key: TileKey, splits: int) -> float:
    """Relative cost of ``splits`` splits of each row's pages: the waves of
    CTAs over the card's slots (``CTAS_PER_SM`` an SM) times the pages a
    split walks, plus one page's worth for the merge."""
    from .paged_decode.ops import CTAS_PER_SM
    card = facts(key.platform)
    waves = _ceil(key.batch * splits, CTAS_PER_SM * card.sms)
    return waves * _ceil(key.lanes, splits) + (1 if splits > 1 else 0)


def _search_paged(key: TileKey) -> TileChoice:
    from .paged_decode.ops import MAX_SPLITS
    cands = range(1, max(1, min(key.lanes, MAX_SPLITS)) + 1)
    splits, _ = _argmin(cands, lambda s: paged_cost(key, s))
    return TileChoice(splits=splits)


_SEARCHERS: dict[str, Callable[[TileKey], TileChoice]] = {
    "gather": _search_gather,
    "gather_global": _search_vecs,
    "gather_smem": _search_gather_smem,
    "scatter_store": _search_vecs,
    "scatter_add": _search_scatter_add,
    "paged_decode": _search_paged,
}


# -- the legacy rules, as they were before the search -------------------------

def legacy_vecs(key: TileKey) -> int:
    """The C rule (``deep_for`` with vecs 0) written out: the deep instance
    once its threads would still fill the card, for operands in phase at
    a 16-byte boundary, as the planner's fresh tensors are.  (A caller's
    view out of phase takes the element kernel, whose own threshold
    differs: pass ``vecs=0`` for the kernel's rule there.)"""
    deep = deep_vecs(key.width)
    return deep if _work(key) >= facts(key.platform).threads * deep else 1


def _legacy_gather(key: TileKey) -> TileChoice:
    from .gather_rows.ops import SMEM_CLUSTER, use_smem
    return TileChoice(smem=int(
        use_smem(key.rows, key.lanes, key.width, itemsize(key))
        and facts(key.platform).resident_ctas >= SMEM_CLUSTER))


def _legacy_gather_smem(key: TileKey) -> TileChoice:
    from .gather_rows.ops import smem_lanes_per_cta
    return TileChoice(smem=1, lanes_per_cta=smem_lanes_per_cta(
        key.batch, key.lanes, key.rows, facts(key.platform).resident_ctas))


def _legacy_paged(key: TileKey) -> TileChoice:
    from .paged_decode.ops import paged_splits
    # paged_splits(bsz, kvh, pps, sms) reads B and KVH only as B x KVH
    return TileChoice(splits=paged_splits(key.batch, 1, key.lanes,
                                          facts(key.platform).sms))


LEGACY: dict[str, Callable[[TileKey], TileChoice]] = {
    "gather": _legacy_gather,
    "gather_global": lambda k: TileChoice(vecs=legacy_vecs(k)),
    "gather_smem": _legacy_gather_smem,
    "scatter_store": lambda k: TileChoice(vecs=legacy_vecs(k)),
    "scatter_add": lambda k: TileChoice(),
    "paged_decode": _legacy_paged,
}


# -- the memo -----------------------------------------------------------------

_LOCK = threading.Lock()
_MEMO: dict[TileKey, TileChoice] = {}
_STATS = {"searched": 0, "hits": 0, "seeded": 0}
_DISABLED = 0
_RECORDERS: list[dict] = []


def choose(key: TileKey) -> TileChoice:
    """The choice for ``key``: a memo hit, or one deterministic search.

    Under ``disabled()`` the legacy rule's, without touching the memo or
    the recorders (a disk header must not carry it as the search's).
    """
    if key.op not in _SEARCHERS:
        raise ValueError(f"unknown autotune op {key.op!r}")
    if _DISABLED:
        return LEGACY[key.op](key)
    with _LOCK:
        choice = _MEMO.get(key)
        if choice is None:
            choice = _MEMO[key] = _SEARCHERS[key.op](key)
            _STATS["searched"] += 1
        else:
            _STATS["hits"] += 1
        for rec in _RECORDERS:
            rec[key] = choice
        return choice


def lookup(key: TileKey) -> TileChoice | None:
    with _LOCK:
        return _MEMO.get(key)


def stats() -> dict:
    with _LOCK:
        return dict(_STATS)


def reset() -> None:
    """Drop the memo and zero the counters."""
    with _LOCK:
        _MEMO.clear()
        for k in _STATS:
            _STATS[k] = 0


@contextlib.contextmanager
def disabled():
    """Serve the legacy rules for the duration of the block."""
    global _DISABLED
    with _LOCK:
        _DISABLED += 1
    try:
        yield
    finally:
        with _LOCK:
            _DISABLED -= 1


@contextlib.contextmanager
def recording():
    """Collect every choice served inside the block, ``{TileKey: choice}``
    (``plan.build_bucket`` records what a bucket callable closes over)."""
    rec: dict[TileKey, TileChoice] = {}
    with _LOCK:
        _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        with _LOCK:
            for i, r in enumerate(_RECORDERS):   # by identity: may nest
                if r is rec:
                    del _RECORDERS[i]
                    break


# -- wire format (DiskTier header) --------------------------------------------

def key_to_wire(key: TileKey) -> str:
    return (f"{key.op}:{key.batch}:{key.lanes}:{key.rows}:{key.width}:"
            f"{key.dtype}:{key.platform}")


def key_from_wire(s: str) -> TileKey:
    op, batch, lanes, rows, width, dtype, platform = s.split(":", 6)
    if op not in OPS:
        raise ValueError(f"unknown autotune op {op!r}")
    facts(platform)                      # raises on a malformed platform
    return TileKey(op=op, batch=int(batch), lanes=int(lanes), rows=int(rows),
                   width=int(width), dtype=dtype, platform=platform)


def to_wire(entries: dict) -> dict:
    """``{TileKey: TileChoice}`` -> JSON-safe ``{str: [int, ...]}``."""
    return {key_to_wire(k): v.to_wire() for k, v in sorted(
        entries.items(), key=lambda kv: key_to_wire(kv[0]))}


def seed_wire(wire: dict | None) -> int:
    """Seed the memo from a wire dict (a disk restore); returns the
    entries adopted.  Memo entries win (the process's own choice is the
    one its callables closed over); malformed entries are skipped."""
    if not wire or not isinstance(wire, dict):
        return 0
    n = 0
    with _LOCK:
        for ks, v in wire.items():
            try:
                key = key_from_wire(ks)
                choice = TileChoice.from_wire(v)
            except (ValueError, TypeError, AttributeError):
                continue
            if key not in _MEMO:
                _MEMO[key] = choice
                _STATS["seeded"] += 1
                n += 1
    return n

