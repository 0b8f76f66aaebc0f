"""spatterlint rules on the port: the invariants behind every bandwidth
number it reports, as code.  The port of ``repro.analysis.rules``.

Three rule scopes, one registry:

``executable`` rules see an ``ExecUnit``: one ``ExecKey``, the placement
and device its launch runs on, and the census of one call of its bucket
callable (``census.Census``), taken lazily on zero operands at the key's
shapes or handed over (spatterd's live cache keeps the census of each
entry's first, untimed call).  ``plan`` rules see a ``PlanUnit``: the
``SuitePlan``, its placement grid and a re-runnable enumeration.
``serve`` rules see a ``ServeUnit``: the serving layer's source files.

Where the reference reads a jaxpr or lowered StableHLO, the port reads the
census.  Rules map one to one, but for three:

  single-pallas-call-per-bucket -> single-kernel-launch-per-bucket
  no-host-callback-or-device-put-in-timed-region
                                -> no-host-sync-in-timed-region
  donation-honored              -> held-operands-unchanged

The launch and host-sync rules bind units whose census ran on a card: on
the CPU the hopper backend runs its kernels' plain versions, which launch
nothing and index by masks.  Rules return ``list[Violation]`` (empty =
clean); a rule never runs a timed call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .report import Violation

# pad_waste budget of a suite x placement cell (the reference's)
PAD_WASTE_BUDGET = 0.90

# backends whose bucket call must not make the host wait for the card, and
# those exempt, each with its reason (the report names them)
SYNC_FREE_BACKENDS = ("hopper",)
SYNC_EXEMPT = {
    "torch": "its store compacts the kept lanes by a boolean mask, which "
             "synchronises on purpose (backends.scatter_torch)",
    "onehot": "torch.nn.functional.one_hot reads the largest index back "
              "to the host",
    "scalar": "it reads every index on the host, one row a step",
}

# rules that read the key alone: the only ones an entry without a census
# (restored from disk) gets
KEY_ONLY_RULES = ("canonical-exec-key", "cost-regression")

# the hand-written kernel each shard of a hopper launch may run (their
# float32 names: ``_instances`` names those of the key's dtype)
_HOPPER_KERNELS = {
    ("gather", ""): ("gather_rows", "gather_rows_smem"),
    ("scatter", "store"): ("scatter_store_rows",),
    ("scatter", "add"): ("scatter_add_rows",),
}
_LANE_SPLIT_STORE = ("scatter_store_rows_cov",)


def _instances(names, dtype: str) -> tuple:
    """The launch-count names of kernels ``names`` at ``dtype`` (a dtype
    no Spatter kernel takes: the names as they are)."""
    from ..kernels import _build
    if dtype not in _build.SPATTER_DTYPES:
        return tuple(names)
    return tuple(_build.spatter_instance(n, dtype)[0] for n in names)


def _adhoc(key) -> bool:
    """``lint.unit_for`` units: no planner geometry to hold a key to."""
    return key.idx_len == 0 and key.footprint == 0 and key.batch == 0


# units ----------------------------------------------------------------------

@dataclasses.dataclass
class ExecUnit:
    """One bucket callable under audit: its ``ExecKey``, where it runs,
    and the census of one call, taken on first use (``census.of_key``)
    unless handed over."""
    key: object                       # plan.ExecKey
    builder: Callable[[], Callable] | None = None
    placement: object = None          # plan.Placement | None
    device: object = None             # the unplaced launch's device
    fn: Callable | None = None
    _census: object = None

    @property
    def label(self) -> str:
        k = self.key
        place = k.placement or "single"
        mode = f" {k.mode}" if k.mode else ""
        return (f"{k.backend}/{k.kind} idx={k.idx_len} fp={k.footprint} "
                f"{k.dtype} r{k.row_width}{mode} b{k.batch} @{place}")

    @property
    def executable(self) -> Callable:
        if self.fn is None:
            self.fn = self.builder()
        return self.fn

    @property
    def census(self):
        if self._census is None:
            from .census import of_key
            self._census = of_key(self.key, self.executable,
                                  placement=self.placement,
                                  device=self.device)
        return self._census


@dataclasses.dataclass
class PlanUnit:
    """A suite-level audit unit: the plan, the grid it launches on, and a
    zero-arg re-enumeration of its keys.  A ``mesh="auto"`` cell carries
    its per-bucket ``placements`` instead of one grid."""
    plan: object                      # plan.SuitePlan
    grid: tuple[int, int]             # (batch_shards, lane_shards)
    label: str                        # e.g. "suites/demo.json @ 2x1"
    enumerate: Callable[[], list] | None = None  # -> [(key, builder, pl)]
    placements: list | None = None    # per-bucket [Placement | None]


@dataclasses.dataclass
class ServeUnit:
    """The serving layer's source files: [(path, source), ...]."""
    files: list


# registry -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    scope: str                        # "executable" | "plan" | "serve"
    doc: str
    fn: Callable

    def check(self, unit) -> list[Violation]:
        return self.fn(unit)


RULES: dict[str, Rule] = {}


def rule(name: str, scope: str):
    def deco(fn):
        if name in RULES:
            raise ValueError(f"duplicate rule {name!r}")
        RULES[name] = Rule(name=name, scope=scope,
                           doc=(fn.__doc__ or "").strip(), fn=fn)
        return fn
    return deco


def rules_for(scope: str, names=None) -> list[Rule]:
    picked = [r for r in RULES.values() if r.scope == scope]
    if names is not None:
        names = set(names)
        unknown = names - set(RULES)
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        picked = [r for r in picked if r.name in names]
    return picked


def _counts(d: dict) -> str:
    return ", ".join(f"{k} x{n}" for k, n in sorted(d.items()))


# executable-scope rules -----------------------------------------------------

@rule("no-sort-in-hot-path", scope="executable")
def _no_sort(unit: ExecUnit) -> list[Violation]:
    """No sort, argsort, unique or topk in a bucket call: store-mode dedup
    is the host's keep mask, never a sort on the device."""
    sorts = unit.census.sorts()
    if not sorts:
        return []
    return [Violation(
        rule="no-sort-in-hot-path", exec_key=unit.label,
        location=_counts(sorts),
        message=(f"{sum(sorts.values())} sort op(s) in a timed bucket "
                 f"call: index preprocessing belongs on the host (§4: the "
                 f"bandwidth number times only the gather/scatter)"))]


@rule("single-kernel-launch-per-bucket", scope="executable")
def _single_launch(unit: ExecUnit) -> list[Violation]:
    """On a card, a hopper bucket call launches exactly ONE hand-written
    kernel on each shard's device (a lane-split store: the store with its
    coverage map), and any other backend launches none.  Binds censuses
    taken on a card."""
    from ..plan import placement_grid
    c, k = unit.census, unit.key
    if not c.on_cuda:
        return []
    _, l, ndev = placement_grid(k.placement)
    hopper = k.backend == "hopper"
    want = ndev if hopper else 0
    allowed = _instances(
        _LANE_SPLIT_STORE if k.kind == "scatter" and k.mode == "store"
        and l > 1 else _HOPPER_KERNELS.get((k.kind, k.mode), ()), k.dtype)
    stray = sorted(set(c.launches) - set(allowed)) if hopper \
        else sorted(c.launches)
    shards = sorted(d for d, _ in c.calls)
    if c.n_launches == want and not stray and (
            not hopper or sorted(c.launch_devices) == shards):
        return []
    return [Violation(
        rule="single-kernel-launch-per-bucket", exec_key=unit.label,
        location=_counts(c.launches) or "no launch",
        message=(f"{c.n_launches} kernel launch(es) on "
                 f"{sorted(c.launch_devices)}, expected {want} for "
                 f"backend={k.backend!r}"
                 + (f" (one of {allowed} on each shard's device, "
                    f"{shards}): a bucket that launches more than once "
                    f"re-pays the launch in every timed call"
                    if hopper else "")
                 + (f"; stray kernels {stray}" if stray else "")))]


@rule("no-host-sync-in-timed-region", scope="executable")
def _no_host_sync(unit: ExecUnit) -> list[Violation]:
    """A hopper bucket call on a card never makes the host wait for the
    device: no scalar read, no op whose output size depends on the data,
    no index by a boolean mask, no copy to the host.  Binds
    ``SYNC_FREE_BACKENDS`` on a card; the backends in ``SYNC_EXEMPT``
    synchronise by design, and reports name them as exempt."""
    c = unit.census
    if unit.key.backend not in SYNC_FREE_BACKENDS or not c.on_cuda \
            or not c.syncs:
        return []
    return [Violation(
        rule="no-host-sync-in-timed-region", exec_key=unit.label,
        location=_counts(c.syncs),
        message=("the host waits for the card inside a timed bucket call: "
                 + _counts(c.syncs) + " (each is a round trip inside the "
                 "timed region)"))]


@rule("held-operands-unchanged", scope="executable")
def _held_operands(unit: ExecUnit) -> list[Violation]:
    """A bucket call writes only its dst (and a lane-split store's
    coverage map): the table, idx, vals and keep it is handed are held
    across the timed calls (a scatter's dst is fresh each run,
    ``timed_runs(fresh_dst=)``), so a write to one changes every later
    call's input."""
    held = ("table", "idx") if unit.key.kind == "gather" \
        else ("idx", "vals", "keep")
    hits = {n: unit.census.writes[n] for n in held
            if unit.census.writes.get(n)}
    if not hits:
        return []
    return [Violation(
        rule="held-operands-unchanged", exec_key=unit.label,
        location=_counts(hits),
        message=(f"in-place write(s) to held operand(s) {sorted(hits)}: "
                 f"the next timed call reads other inputs than the first"))]


@rule("no-f64-promotion-drift", scope="executable")
def _no_f64(unit: ExecUnit) -> list[Violation]:
    """No float64 tensor in the call unless the ExecKey says float64: a
    silent promotion doubles the bytes moved and falsifies the §3.5
    bandwidth arithmetic keyed on the declared dtype."""
    if unit.key.dtype == "float64":
        return []
    n = unit.census.dtypes.get("float64", 0)
    if not n:
        return []
    return [Violation(
        rule="no-f64-promotion-drift", exec_key=unit.label,
        location=f"float64 x{n}",
        message=(f"{n} float64 tensor(s) in a call keyed "
                 f"dtype={unit.key.dtype}: promotion drift breaks the "
                 f"useful-bytes bandwidth formula"))]


@rule("sharding-spec-consistency", scope="executable")
def _sharding_consistency(unit: ExecUnit) -> list[Violation]:
    """The ExecKey's placement string matches the launch: its grid
    multiplies to its device count, the call ran the bucket callable once
    a shard at the shard's shape (batch over the batch shards, padded
    lanes over the lane shards), and on a card a hopper call launched once
    on each shard's device."""
    from ..plan import pad_lanes, placement_grid
    k, c = unit.key, unit.census
    if _adhoc(k):
        return []
    b, l, ndev = placement_grid(k.placement)
    probs = []
    if b * l != ndev:
        probs.append(f"grid {b}x{l} does not make {ndev} devices")
    if len(c.calls) != ndev:
        probs.append(f"{len(c.calls)} shard call(s), the placement has "
                     f"{ndev}")
    want = (k.batch // b, pad_lanes(k.idx_len, l) // l)
    shapes = sorted({shapes[1] for _, shapes in c.calls if len(shapes) > 1})
    if shapes != [want]:
        probs.append(f"shard idx shapes {shapes}, the key promises "
                     f"{want}")
    if k.backend == "hopper" and c.on_cuda and \
            sorted(c.launch_devices) != sorted(d for d, _ in c.calls):
        probs.append(f"launches on {sorted(c.launch_devices)}, shards on "
                     f"{sorted(d for d, _ in c.calls)}")
    return [Violation(rule="sharding-spec-consistency", exec_key=unit.label,
                      location=f"placement {k.placement or 'single'!r}",
                      message=p + " (the key lies about where its launch "
                                  "runs)")
            for p in probs]


@rule("canonical-exec-key", scope="executable")
def _canonical_key(unit: ExecUnit) -> list[Violation]:
    """Every cached ExecKey is in the canonical ``bucket_key`` format:
    pow-2 geometry, bracket-stable batch, parseable placement string,
    canonical dtype name, kind-consistent mode.  The coalescing scheduler
    re-derives a launch key from a combined member count; a raw batch, a
    novel placement spelling or a dtype alias in the cache would split
    the family index ``best_batch`` coalesces through."""
    import torch

    from ..backends import BACKENDS, SCATTER_MODES
    from ..plan import next_pow2, pad_batch, placement_grid
    k = unit.key
    if _adhoc(k):
        return []
    probs = []
    if k.backend not in BACKENDS:
        probs.append(f"backend {k.backend!r} not in {sorted(BACKENDS)}")
    if k.kind not in ("gather", "scatter"):
        probs.append(f"kind {k.kind!r} not gather|scatter")
    try:
        b_shards, _, _ = placement_grid(k.placement)
    except (ValueError, IndexError):
        probs.append(f"placement {k.placement!r} is not a canonical "
                     f"placement string (placement_grid cannot parse it)")
        b_shards = 1
    for name in ("idx_len", "footprint"):
        v = getattr(k, name)
        if v < 1 or next_pow2(v) != v:
            probs.append(f"{name}={v} is not pow-2 bucketed")
    if k.batch < 1 or pad_batch(k.batch, b_shards) != k.batch:
        probs.append(f"batch={k.batch} is not bracket-stable for "
                     f"{b_shards} batch shard(s) (expected "
                     f"pad_batch(batch)==batch)")
    dt = getattr(torch, str(k.dtype), None)
    canon = (str(dt).removeprefix("torch.")
             if isinstance(dt, torch.dtype) else None)
    if canon != k.dtype:
        probs.append(f"dtype {k.dtype!r} is not the canonical dtype name"
                     + (f" ({canon!r})" if canon else ""))
    want_modes = SCATTER_MODES if k.kind == "scatter" else ("",)
    if k.kind in ("gather", "scatter") and k.mode not in want_modes:
        probs.append(f"mode {k.mode!r} invalid for kind={k.kind} "
                     f"(expected one of {want_modes})")
    return [Violation(rule="canonical-exec-key", exec_key=unit.label,
                      location=p.split(" ", 1)[0], message=p)
            for p in probs]


# plan-scope rules -----------------------------------------------------------

@rule("pad-waste-threshold", scope="plan")
def _pad_waste(unit: PlanUnit) -> list[Violation]:
    """``pad_waste`` of a suite x placement cell stays within budget: a
    cell that launches mostly scratch lanes is surfaced, not buried."""
    if unit.placements is not None:
        b, l = "auto", "auto"
        waste = unit.plan.pad_waste_for(unit.placements)
    else:
        b, l = unit.grid
        waste = unit.plan.pad_waste(b, l)
    if waste <= PAD_WASTE_BUDGET:
        return []
    return [Violation(
        rule="pad-waste-threshold", exec_key=unit.label,
        message=(f"pad_waste({b}, {l}) = {waste:.1%} exceeds the "
                 f"{PAD_WASTE_BUDGET:.0%} budget — "
                 f"{unit.plan.n_buckets} bucket(s), "
                 f"{len(unit.plan.patterns)} pattern(s); pick a smaller "
                 f"batch axis or lane-shard this suite"))]


@rule("cache-key-purity", scope="plan")
def _key_purity(unit: PlanUnit) -> list[Violation]:
    """ExecKeys are a pure function of pattern geometry + placement:
    re-enumerating the suite gives the same keys, and every key field is
    a plain str/int (an object identity in a key would split the cache
    and break the exact build count)."""
    if unit.enumerate is None:
        return []
    out = []
    keys1 = [k for k, _, _ in unit.enumerate()]
    keys2 = [k for k, _, _ in unit.enumerate()]
    if keys1 != keys2:
        drift = next((i for i, (a, b) in enumerate(zip(keys1, keys2))
                      if a != b), min(len(keys1), len(keys2)))
        out.append(Violation(
            rule="cache-key-purity", exec_key=unit.label,
            location=f"first drift at bucket {drift}",
            message=("re-enumerating the suite produced different "
                     "ExecKeys: warm lookups will miss and 'misses' stops "
                     "being an exact build count")))
    for k in keys1:
        for f in dataclasses.fields(k):
            v = getattr(k, f.name)
            if not isinstance(v, (str, int)):
                out.append(Violation(
                    rule="cache-key-purity", exec_key=unit.label,
                    location=f"{f.name}={v!r}",
                    message=(f"ExecKey.{f.name} is {type(v).__name__}, "
                             f"not str/int: identity-keyed fields "
                             f"fragment the cache")))
            elif isinstance(v, str) and "0x" in v:
                out.append(Violation(
                    rule="cache-key-purity", exec_key=unit.label,
                    location=f"{f.name}={v!r}",
                    message=(f"ExecKey.{f.name} embeds what looks like "
                             f"an object address")))
    return out


# cost rules -----------------------------------------------------------------

@rule("traffic-conservation", scope="executable")
def _traffic_conservation(unit: ExecUnit) -> list[Violation]:
    """Every byte the census saw cross the launch (its operands and its
    result) is accounted for by the key's traffic model, and vice versa:
    excess means a materialisation the planner does not know about,
    deficit a key that lies about its geometry (the keep mask alone may
    be missing)."""
    from . import cost as C
    k = unit.key
    if _adhoc(k):
        return []
    uc = C.key_cost(k)
    seen = unit.census.operand_bytes + unit.census.result_bytes
    floor = uc.io_bytes - uc.keep_bytes
    tol = max(C.TRAFFIC_TOL * uc.io_bytes, C.TRAFFIC_TOL_FLOOR)
    if floor - tol <= seen <= uc.io_bytes + tol:
        return []
    kind = ("unaccounted traffic (a redundant materialisation?)"
            if seen > uc.io_bytes else
            "the key's geometry overstates the launch")
    return [Violation(
        rule="traffic-conservation", exec_key=unit.label,
        location=f"census={seen}B predicted={uc.io_bytes}B",
        message=(f"the call moves {seen} B at its boundary but the key's "
                 f"traffic model predicts {uc.io_bytes} B (allowed "
                 f"deficit: the {uc.keep_bytes} B keep mask; tolerance "
                 f"{tol:.0f} B): {kind}"))]


@rule("auto-placement-sane", scope="plan")
def _auto_placement_sane(unit: PlanUnit) -> list[Violation]:
    """Where a calibration recorded a mesh sweep for the suite, the shape
    ``mesh="auto"`` picks is not dominated by a recorded cell (better on
    both pad waste and GB/s beyond tolerance).  Audits nothing without a
    recorded sweep."""
    from . import cost as C
    cal = C.Calibration.from_record()
    cells = cal.sweep.get(C.suite_stem(unit.label))
    if not cells:
        return []
    shape = C.select_shape(unit.plan, n_devices=cal.n_dev)
    name = "single" if shape == (1, 1) else f"{shape[0]}x{shape[1]}"
    chosen = cells.get(name)
    if chosen is None:
        return []
    out = []
    for other_name, other in cells.items():
        if other_name == name:
            continue
        if (other["pad_waste"] < chosen["pad_waste"] - C.PAD_WASTE_TOL
                and other["hmean_gbs"] > chosen["hmean_gbs"]
                * (1 + C.GBS_TOL)):
            out.append(Violation(
                rule="auto-placement-sane", exec_key=unit.label,
                location=f"auto={name} dominated-by={other_name}",
                message=(f"auto placement {name} (pad waste "
                         f"{chosen['pad_waste']:.3f}, "
                         f"{chosen['hmean_gbs']:.4g} GB/s) is dominated "
                         f"by recorded cell {other_name} "
                         f"({other['pad_waste']:.3f}, "
                         f"{other['hmean_gbs']:.4g} GB/s)")))
    return out


@rule("cost-regression", scope="executable")
def _cost_regression(unit: ExecUnit) -> list[Violation]:
    """Predicted I/O bytes of a key may not grow over the committed
    ``COST_baseline_torch.json`` (regenerate with ``python -m
    repro_torch.analysis --cost --write-baseline``).  Key geometry only,
    so it audits entries restored from disk too."""
    from . import cost as C
    k = unit.key
    if _adhoc(k):
        return []
    committed = C.load_baseline().get(C.key_id(k))
    if committed is None:
        return []
    predicted = C.key_cost(k).io_bytes
    if predicted <= committed:
        return []
    return [Violation(
        rule="cost-regression", exec_key=unit.label,
        location=f"baseline={committed}B predicted={predicted}B",
        message=(f"predicted I/O bytes grew {committed} -> {predicted} vs "
                 f"the committed baseline; update "
                 f"{C.BASELINE_NAME} (--write-baseline) if intended"))]


# serve-scope rules ----------------------------------------------------------

@rule("serve-lock-discipline", scope="serve")
def _serve_locks(unit: ServeUnit) -> list[Violation]:
    """Shared daemon state is mutated only under its lock (mostly-locked
    inference over repro_torch/serve)."""
    import ast as _ast

    from .ast_lint import check_lock_discipline
    out = []
    for path, src in unit.files:
        out.extend(check_lock_discipline(_ast.parse(src, filename=path),
                                         path))
    return out


@rule("serve-blocking-under-lock", scope="serve")
def _serve_blocking(unit: ServeUnit) -> list[Violation]:
    """No blocking I/O while holding a daemon lock."""
    import ast as _ast

    from .ast_lint import check_blocking_under_lock
    out = []
    for path, src in unit.files:
        out.extend(check_blocking_under_lock(
            _ast.parse(src, filename=path), path))
    return out
