"""Request schema of the port's spatterd: the reference's wire format.

A copy of the stdlib part of ``repro.serve.schema``, with the port's
choice sets.  One request = one JSON suite run.  The body is either the
bare suite format ``load_suite`` reads (a JSON list of ``{name, kernel,
pattern, delta, count}`` dicts, so every ``suites/*.json`` file POSTs
unmodified) or an envelope::

    {"patterns": [...],            # required, same entries as the bare list
     "backend": "torch",           # any of backends.BACKENDS
     "runs": 3,                    # min-of-K timing (paper §3.5)
     "mode": "store",              # scatter semantics: "store" | "add"
     "metric": "measured",         # table's uniform gbs column
     "row_width": 1,
     "mesh": 0,                    # N, [b, l], "auto", "auto-suite"
     "mesh_axis": "data",
     "seed": 0,                    # host-buffer RNG seed
     "stream_r": false,            # also time the STREAM-like reference
     "stream_n": 4194304,
     "digest": true,               # per-pattern sha256 of the output
     "deadline_ms": 0}             # >0: queue deadline -> 504 on expiry

Every field is validated HERE, before any device work, so a bad request
is a 400 with a one-line reason and never takes a queue slot; unknown
envelope keys are rejected too.  The metric is ``measured`` or
``modeled`` (or their column names ``measured_gbs``,
``modeled_h100_gbs``); the reference's ``modeled_v5e_gbs`` names a TPU
model the port does not have, and is a 400 like any unknown metric.

``MAX_SUITE_LANES`` bounds one request's assembled buffers AND how many
requests' work units the scheduler may stack into one launch, so a
coalesced launch never assembles more than a maximal single request.

Stdlib only at import: the client validates with this module and never
imports torch (``build_patterns`` imports the port's pattern module when
it runs, in the daemon).
"""
from __future__ import annotations

import dataclasses
import json

# upper bound on any single pattern's flattened lanes x row_width and
# table footprint x row_width (and on stream_n).  Each counted unit backs
# ~4-6 float32/int32 buffers (host idx/vals/table, their device copies,
# the output and its host copy), so a request at the full budget peaks at
# several GiB; the suite as a whole shares the same budget.
MAX_PATTERN_LANES = 1 << 28
MAX_SUITE_LANES = MAX_PATTERN_LANES
MAX_RUNS = 1000
# a mesh dim beyond this is a typo, not a machine
MAX_MESH_DIM = 1 << 16

# wire-level choice sets (the port's backends.BACKENDS, SCATTER_MODES and
# suite._METRIC_COLUMNS, copied to stay import-light; a test pins them)
WIRE_BACKENDS = ("torch", "onehot", "scalar", "hopper")
WIRE_MODES = ("store", "add")
WIRE_METRICS = ("measured", "measured_gbs", "modeled", "modeled_h100_gbs")
DEFAULT_BACKEND = "torch"          # the port CLI's default


def parse_mesh(spec: str) -> "int | str | tuple[int, int]":
    """CLI mesh spec -> wire value: ``"8"`` -> 8, ``"4x2"`` -> (4, 2),
    ``"auto"`` / ``"auto-suite"`` as themselves."""
    s = spec.strip().lower()
    if s in ("auto", "auto-suite"):
        return s
    try:
        if "x" in s:
            b, l = s.split("x")
            return int(b), int(l)
        return int(s)
    except ValueError:
        raise ValueError(f"mesh must be N, BxL, 'auto', or 'auto-suite' "
                         f"(e.g. 8 or 4x2), got {spec!r}") from None


# the declared index-buffer length is bounded much tighter than lanes:
# generate_index materializes it as a Python tuple (~36 bytes/element)
# while parsing.  Scale belongs on the count axis.
MAX_INDEX_LEN = 1 << 22


def _spec_index_len(spec) -> int:
    """Upper-bound a pattern spec's index-buffer length WITHOUT
    materializing it (mirrors ``pattern.generate_index``'s grammar).
    Fails closed: a generator-shaped spec with an unknown head reports
    oversized.  Malformed argument lists return 0 and
    ``Pattern.from_json`` raises the real error later."""
    if not isinstance(spec, str):
        try:
            return len(spec)
        except TypeError:
            return 0
    s = spec.strip()
    head, sep, rest = s.partition(":")
    args = [a for a in rest.split(":") if a]
    try:
        if head in ("UNIFORM", "MS1", "BROADCAST", "STREAM"):
            return int(args[0])
        if head == "LAPLACIAN":
            return 2 * int(args[0]) * int(args[1]) + 1
        if head == "CUSTOM":
            return rest.count(",") + 1
    except (IndexError, ValueError):
        return 0
    if sep and head.isupper():          # unknown generator head
        return MAX_INDEX_LEN + 1
    return s.count(",") + 1             # bare comma list


def _check_int(name: str, v, lo: int, hi: int) -> None:
    if not isinstance(v, int) or isinstance(v, bool) or not lo <= v <= hi:
        raise ValueError(f"{name} must be an int in [{lo}, {hi}], got {v!r}")


@dataclasses.dataclass(frozen=True)
class SuiteRequest:
    """A validated spatterd run request."""
    patterns: tuple[dict, ...]
    backend: str = DEFAULT_BACKEND
    runs: int = 3
    mode: str = "store"
    metric: str = "measured"
    row_width: int = 1
    mesh: int | str | list = 0  # N, [b, l], "auto" or "auto-suite";
                                # normalized to int | str | tuple
    mesh_axis: str = "data"
    seed: int = 0
    stream_r: bool = False
    stream_n: int = 2 ** 22
    digest: bool = True      # per-pattern sha256 of the output
    deadline_ms: int = 0     # 0 = none; else a queue deadline (504)

    def __post_init__(self):
        if not self.patterns:
            raise ValueError("request needs at least one pattern")
        for i, d in enumerate(self.patterns):
            if not isinstance(d, dict):
                raise ValueError(f"patterns[{i}] is not an object: {d!r}")
        if self.backend not in WIRE_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {sorted(WIRE_BACKENDS)}")
        if self.mode not in WIRE_MODES:
            raise ValueError(f"unknown mode {self.mode!r}; "
                             f"expected one of {WIRE_MODES}")
        if self.metric not in WIRE_METRICS:
            raise ValueError(f"unknown metric {self.metric!r}; "
                             f"expected one of {sorted(WIRE_METRICS)}")
        _check_int("runs", self.runs, 1, MAX_RUNS)
        _check_int("row_width", self.row_width, 1, 4096)
        # stream_reference is UNIFORM:8:1 with count = n // 8
        _check_int("stream_n", self.stream_n, 8, MAX_PATTERN_LANES)
        _check_int("deadline_ms", self.deadline_ms, 0, 86_400_000)
        if isinstance(self.mesh, list):
            object.__setattr__(self, "mesh", tuple(self.mesh))
        mesh = self.mesh
        mesh_ok = (isinstance(mesh, int) and not isinstance(mesh, bool)
                   and 0 <= mesh <= MAX_MESH_DIM) \
            or mesh in ("auto", "auto-suite")
        if isinstance(mesh, tuple):
            mesh_ok = (len(mesh) == 2 and all(
                isinstance(s, int) and not isinstance(s, bool)
                and 1 <= s <= MAX_MESH_DIM for s in mesh))
        if not mesh_ok:
            raise ValueError(f"mesh must be an int >= 0, a [batch, lane] "
                             f"pair of ints >= 1 (dims <= {MAX_MESH_DIM}), "
                             f"'auto', or 'auto-suite', got {self.mesh!r}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool) \
                or self.seed < 0:
            raise ValueError(f"seed must be an int >= 0, got {self.seed!r}")
        if not self.mesh_axis.isidentifier():
            raise ValueError(f"mesh_axis must be an identifier-like axis "
                             f"name, got {self.mesh_axis!r}")
        for name in ("stream_r", "digest"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} must be a bool, "
                                 f"got {getattr(self, name)!r}")

    @property
    def devices_needed(self) -> int:
        """Devices an explicit mesh asks for (``auto`` fits any count)."""
        if isinstance(self.mesh, tuple):
            return self.mesh[0] * self.mesh[1]
        return self.mesh if isinstance(self.mesh, int) else 1

    @staticmethod
    def from_json(doc) -> "SuiteRequest":
        """Parse a decoded request body (bare pattern list or envelope)."""
        if isinstance(doc, str):
            doc = json.loads(doc)
        if isinstance(doc, list):
            return SuiteRequest(patterns=tuple(doc))
        if not isinstance(doc, dict):
            raise ValueError(f"request must be a JSON list or object, "
                             f"got {type(doc).__name__}")
        if "patterns" not in doc:
            raise ValueError('request object needs a "patterns" list')
        unknown = set(doc) - set(_OPTION_FIELDS) - {"patterns"}
        if unknown:
            raise ValueError(f"unknown request fields {sorted(unknown)}; "
                             f"expected {sorted(_OPTION_FIELDS)}")
        kw = {}
        for name, ty in _OPTION_FIELDS.items():
            if name in doc:
                v = doc[name]
                ty_name = (ty.__name__ if isinstance(ty, type)
                           else " | ".join(t.__name__ for t in ty))
                # bool is an int subclass: keep the check strict both ways
                if ty is not bool and isinstance(v, bool):
                    raise ValueError(f"{name} must be {ty_name}, got {v!r}")
                if not isinstance(v, ty):
                    raise ValueError(f"{name} must be {ty_name}, "
                                     f"got {v!r}")
                kw[name] = v
        pats = doc["patterns"]
        if not isinstance(pats, list):
            raise ValueError('"patterns" must be a list')
        return SuiteRequest(patterns=tuple(pats), **kw)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["patterns"] = list(d["patterns"])
        if isinstance(d["mesh"], tuple):        # wire form is a JSON list
            d["mesh"] = list(d["mesh"])
        return d

    def build_patterns(self) -> list:
        """Materialize the suite (ValueError on malformed entries).

        Bounds the buffer geometry, per pattern AND summed over the suite,
        before any host buffer is allocated: a tiny body can declare an
        astronomically large ``count``.
        """
        for d in self.patterns:
            n = _spec_index_len(d.get("pattern", ()))
            if n > MAX_INDEX_LEN:
                raise ValueError(
                    f"pattern {d.get('name', '?')!r} declares a "
                    f">{MAX_INDEX_LEN}-element (or unrecognized-"
                    f"generator) index buffer; put scale in count=")
        from ..pattern import Pattern       # numpy: not on the client path
        try:
            pats = [Pattern.from_json(d) for d in self.patterns]
        except (IndexError, KeyError, TypeError, ValueError) as e:
            # IndexError: generator specs with too few args ("UNIFORM")
            raise ValueError(f"bad pattern entry: {e}") from e
        total = 0
        for p in pats:
            lanes = p.count * p.index_len
            size = max(lanes, p.footprint()) * self.row_width
            total += size
            if size > MAX_PATTERN_LANES:
                raise ValueError(
                    f"pattern {p.name!r} too large to serve: "
                    f"count*index_len={lanes}, footprint={p.footprint()}, "
                    f"row_width={self.row_width} (limit: lanes x "
                    f"row_width <= {MAX_PATTERN_LANES})")
        if total > MAX_SUITE_LANES:
            raise ValueError(
                f"suite too large to serve: {total} total lanes x "
                f"row_width > {MAX_SUITE_LANES} budget")
        return pats


# envelope option keys -> wire type, derived from the dataclass itself so
# the two can never drift; patterns is handled separately
_WIRE_TYPES = {"str": str, "int": int, "bool": bool,
               "int | str | list": (int, str, list, tuple)}
_OPTION_FIELDS: dict[str, type] = {
    f.name: _WIRE_TYPES[f.type]
    for f in dataclasses.fields(SuiteRequest) if f.name != "patterns"
}
