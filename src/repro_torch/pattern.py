"""Spatter pattern language (the port's own copy of ``repro.core.pattern``;
the port imports nothing from ``repro``).

A memory access pattern (paper §3.1, §3.3) is the triple

    (index buffer, delta, count)

meaning: for i in 0..count-1, perform one gather/scatter at base address
``delta * i`` using the offsets in the index buffer.  The *element* is a
table row of ``row_width`` values (float32, bfloat16 or float16);
``row_width=1`` is the paper's scalar element (DESIGN.md §2).

Built-in generators follow the released Spatter semantics:

    UNIFORM:N:S            -> [0, S, 2S, ..., (N-1)S]
    MS1:N:BREAKS:GAPS      -> stride-1 run with jumps of GAP at each break
    LAPLACIAN:D:L:SIZE     -> D-dim stencil, branch length L, grid side SIZE
    BROADCAST:N:R          -> [0,0,..(R times)..,1,1,..] length N
    STREAM:N               -> alias UNIFORM:N:1 (paper §3.4 STREAM-like)
    CUSTOM:i0,i1,...       -> verbatim buffer

(The paper's printed ``UNIFORM:8:4 -> [0,4,8,12]`` truncates; the Spatter
code generates length-N buffers.  We follow the code — DESIGN.md §9.)
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Iterable, Sequence

import numpy as np

_KINDS = ("gather", "scatter")


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A fully-specified Spatter pattern (paper §3.3)."""

    name: str
    kind: str                      # "gather" | "scatter"
    index: tuple[int, ...]         # the index buffer (offsets for one G/S)
    delta: int                     # base-address advance between G/S ops
    count: int                     # number of gathers/scatters to perform
    source: str = "custom"         # generator string or app name

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if len(self.index) == 0:
            raise ValueError("index buffer must be non-empty")
        if any(i < 0 for i in self.index):
            raise ValueError("index buffer entries must be >= 0")
        if self.delta < 0:
            raise ValueError("delta must be >= 0")
        if self.count < 1:
            raise ValueError("count must be >= 1")

    # -- derived geometry ---------------------------------------------------
    @property
    def index_len(self) -> int:
        return len(self.index)

    @property
    def span(self) -> int:
        """Extent touched by a single G/S op (max offset + 1)."""
        return max(self.index) + 1

    def footprint(self) -> int:
        """Number of addressable elements the whole pattern touches.

        This is how Spatter sizes its sparse buffer: the last base address is
        ``delta * (count - 1)`` and the largest offset from it is ``span - 1``.
        """
        return self.delta * (self.count - 1) + self.span

    def useful_elements(self) -> int:
        """Elements actually moved (paper §3.5 bandwidth numerator)."""
        return self.index_len * self.count

    def unique_elements(self) -> int:
        """Distinct addresses touched — measures reuse (< useful => reuse)."""
        idx = np.asarray(self.index, dtype=np.int64)
        deltas = np.arange(self.count, dtype=np.int64) * self.delta
        all_addr = (deltas[:, None] + idx[None, :]).ravel()
        return int(np.unique(all_addr).size)

    def reuse_factor(self) -> float:
        """useful / unique; 1.0 means no temporal reuse."""
        return self.useful_elements() / max(1, self.unique_elements())

    # -- materialization ----------------------------------------------------
    def absolute_indices(self) -> np.ndarray:
        """(count, index_len) int32 array of absolute element indices."""
        idx = np.asarray(self.index, dtype=np.int64)
        deltas = np.arange(self.count, dtype=np.int64) * self.delta
        out = deltas[:, None] + idx[None, :]
        if out.max(initial=0) >= np.iinfo(np.int32).max:
            raise ValueError("pattern footprint exceeds int32 index range")
        return out.astype(np.int32)

    # -- classification (paper Table 1 / Table 5 "Type" column) -------------
    def classify(self) -> str:
        idx = np.asarray(self.index, dtype=np.int64)
        if idx.size == 1:
            return "Stride-1"
        d = np.diff(idx)
        if np.all(d == d[0]) and d[0] > 0:
            return f"Stride-{int(d[0])}"
        if np.all(d >= 0) and np.max(idx) + 1 < idx.size:
            return "Broadcast"
        # broadcast: runs of repeated values
        if np.unique(idx).size < idx.size and np.all(np.diff(np.unique(idx)) == 1):
            return "Broadcast"
        ones = np.count_nonzero(d == 1)
        if ones >= 0.5 * d.size:
            return "Mostly Stride-1"
        return "Complex"

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> dict:
        return {
            "name": self.name, "kernel": self.kind,
            "pattern": list(self.index), "delta": self.delta,
            "count": self.count, "source": self.source,
        }

    @staticmethod
    def from_json(d: dict) -> "Pattern":
        index = d["pattern"]
        if isinstance(index, str):
            index = generate_index(index)
        return Pattern(
            name=d.get("name", "unnamed"),
            kind=d.get("kernel", "gather").lower(),
            index=tuple(int(i) for i in index),
            delta=int(d.get("delta", 1)),
            count=int(d.get("count", 1)),
            source=d.get("source", "json"),
        )


# ---------------------------------------------------------------------------
# Generators (paper §3.3.1-3.3.4)
# ---------------------------------------------------------------------------

def uniform(n: int, stride: int) -> tuple[int, ...]:
    """UNIFORM:N:STRIDE (§3.3.1): length-N buffer with a fixed stride."""
    if n < 1 or stride < 0:
        raise ValueError(f"bad UNIFORM args n={n} stride={stride}")
    return tuple(i * stride for i in range(n))


def ms1(n: int, breaks: int | Sequence[int], gaps: int | Sequence[int]) -> tuple[int, ...]:
    """MS1:N:BREAKS:GAPS (§3.3.2): mostly-stride-1 with jumps.

    ``breaks`` are positions (1-indexed into the buffer) where instead of +1
    the running index jumps by the corresponding ``gap``.  Paper example:
    MS1:8:4:20 -> [0,1,2,3,23,24,25,26]   (at position 4, jump by +20).
    """
    if isinstance(breaks, int):
        breaks = [breaks]
    if isinstance(gaps, int):
        gaps = [gaps] * len(breaks)
    if len(gaps) != len(breaks):
        raise ValueError("MS1 needs one gap per break")
    bset = {int(b): int(g) for b, g in zip(breaks, gaps)}
    out, cur = [0], 0
    for pos in range(1, n):
        cur += bset.get(pos, 1)
        out.append(cur)
    return tuple(out)


def laplacian(dim: int, length: int, size: int) -> tuple[int, ...]:
    """LAPLACIAN:D:L:SIZE (§3.3.3): D-dim stencil, branch length L, grid side SIZE.

    Offsets are {±k·SIZE^d : d<D, 1<=k<=L} ∪ {0}, shifted to zero base.
    LAPLACIAN:2:2:100 -> [0,100,198,199,200,201,202,300,400].
    """
    if dim < 1 or length < 1 or size < 1:
        raise ValueError(f"bad LAPLACIAN args {dim}:{length}:{size}")
    offs = {0}
    for d in range(dim):
        s = size ** d
        for k in range(1, length + 1):
            offs.add(k * s)
            offs.add(-k * s)
    base = -min(offs)
    return tuple(sorted(o + base for o in offs))


def broadcast(n: int, repeat: int) -> tuple[int, ...]:
    """BROADCAST:N:R — PENNANT-G4 style [0,0,0,0,1,1,1,1,...] (Table 5)."""
    if n < 1 or repeat < 1:
        raise ValueError(f"bad BROADCAST args n={n} repeat={repeat}")
    return tuple(i // repeat for i in range(n))


_GEN_RE = re.compile(r"^([A-Z0-9_]+)(:.*)?$")


def generate_index(spec: str | Sequence[int]) -> tuple[int, ...]:
    """Parse a pattern-buffer spec string (paper §3.3) into an index buffer."""
    if not isinstance(spec, str):
        return tuple(int(i) for i in spec)
    spec = spec.strip()
    m = _GEN_RE.match(spec)
    if not m:
        # bare comma-separated custom buffer:  "0,4,8,12"
        return tuple(int(t) for t in spec.split(","))
    head, rest = m.group(1), (m.group(2) or "")
    args = [a for a in rest.split(":") if a != ""]
    if head == "UNIFORM":
        n, s = int(args[0]), int(args[1])
        return uniform(n, s)
    if head == "MS1":
        n = int(args[0])
        brk = [int(x) for x in args[1].split(",")]
        gap = [int(x) for x in args[2].split(",")]
        return ms1(n, brk, gap if len(gap) > 1 else gap[0])
    if head == "LAPLACIAN":
        return laplacian(int(args[0]), int(args[1]), int(args[2]))
    if head == "BROADCAST":
        return broadcast(int(args[0]), int(args[1]))
    if head == "STREAM":
        return uniform(int(args[0]), 1)
    if head == "CUSTOM":
        return tuple(int(t) for t in ":".join(args).split(","))
    # fall back: maybe a custom buffer that starts with a digit
    try:
        return tuple(int(t) for t in spec.split(","))
    except ValueError as e:
        raise ValueError(f"unrecognized pattern spec {spec!r}") from e


def make_pattern(spec: str | Sequence[int], *, kind: str = "gather",
                 delta: int = 1, count: int = 1, name: str | None = None,
                 source: str | None = None) -> Pattern:
    """One-stop constructor mirroring the CLI (§3.4):

        make_pattern("UNIFORM:8:1", kind="gather", delta=8, count=2**24)
    """
    index = generate_index(spec)
    return Pattern(
        name=name or (spec if isinstance(spec, str) else "custom"),
        kind=kind, index=index, delta=delta, count=count,
        source=source or (spec if isinstance(spec, str) else "custom"),
    )


# ---------------------------------------------------------------------------
# JSON suite files (paper §3.3 "JSON Specification")
# ---------------------------------------------------------------------------

def load_suite(path_or_text: str) -> list[Pattern]:
    """Load a JSON suite: a list of {name, kernel, pattern, delta, count}."""
    text = path_or_text
    if not path_or_text.lstrip().startswith(("[", "{")):
        with open(path_or_text) as f:
            text = f.read()
    data = json.loads(text)
    if isinstance(data, dict):
        data = data.get("patterns", [data])
    return [Pattern.from_json(d) for d in data]


def dump_suite(patterns: Iterable[Pattern]) -> str:
    return json.dumps([p.to_json() for p in patterns], indent=2)
