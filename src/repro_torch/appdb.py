"""Table 5 — the paper's application-derived G/S pattern database (the
port's own copy of ``repro.core.appdb``).

Every pattern from Appendix A, verbatim: PENNANT (hydro), LULESH (shock
hydrodynamics), Nekbone (spectral elements), AMG (algebraic multigrid).
Counts are not given in Table 5; the paper's experimental setup (§4) sizes
app-pattern runs to read/write >= 2 GB, so ``count`` below is chosen per
pattern to move ~2**25 useful elements (~256 MB of doubles) by default and is
scalable via ``scale_counts``.
"""
from __future__ import annotations

from .pattern import Pattern

_TARGET_ELEMENTS = 2 ** 25  # useful elements per pattern at scale=1.0


def _p(name: str, kind: str, index: list[int], delta: int) -> Pattern:
    count = max(1, _TARGET_ELEMENTS // len(index))
    return Pattern(name=name, kind=kind, index=tuple(index), delta=delta,
                   count=count, source=name.split("-")[0])


# --- Gather patterns (Table 5, upper block) --------------------------------
PENNANT_GATHERS = [
    _p("PENNANT-G0", "gather", [2, 484, 482, 0, 4, 486, 484, 2, 6, 488, 486, 4, 8, 490, 488, 6], 2),
    _p("PENNANT-G1", "gather", [0, 2, 484, 482, 2, 4, 486, 484, 4, 6, 488, 486, 6, 8, 490, 488], 2),
    _p("PENNANT-G2", "gather", [0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52, 56, 60], 2),
    _p("PENNANT-G3", "gather", [4, 8, 12, 0, 20, 24, 28, 16, 36, 40, 44, 32, 52, 56, 60, 48], 2),
    _p("PENNANT-G4", "gather", [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3], 4),
    _p("PENNANT-G5", "gather", [4, 8, 12, 0, 20, 24, 28, 16, 36, 40, 44, 32, 52, 56, 60, 48], 4),
    _p("PENNANT-G6", "gather", [482, 0, 2, 484, 484, 2, 4, 486, 486, 4, 6, 488, 488, 6, 8, 490], 480),
    _p("PENNANT-G7", "gather", [482, 0, 2, 484, 484, 2, 4, 486, 486, 4, 6, 488, 488, 6, 8, 490], 482),
    _p("PENNANT-G8", "gather", [2, 0, 0, 0, 2, 0, 0, 0, 2, 0, 0, 2, 0, 0, 0], 129608),
    _p("PENNANT-G9", "gather", [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3], 388852),
    _p("PENNANT-G10", "gather", [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3], 388848),
    _p("PENNANT-G11", "gather", [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3], 388848),
    _p("PENNANT-G12", "gather", [6, 0, 2, 4, 14, 8, 10, 12, 22, 16, 18, 20, 30, 24, 26, 28], 518408),
    _p("PENNANT-G13", "gather", [6, 0, 2, 4, 14, 8, 10, 12, 22, 16, 18, 20, 30, 24, 26, 28], 518408),
    _p("PENNANT-G14", "gather", [6, 0, 2, 4, 14, 8, 10, 12, 22, 16, 18, 20, 30, 24, 26, 28], 1036816),
    _p("PENNANT-G15", "gather", [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3], 1882384),
]

LULESH_GATHERS = [
    _p("LULESH-G0", "gather", list(range(16)), 1),
    _p("LULESH-G1", "gather", list(range(16)), 8),
    _p("LULESH-G2", "gather", [8 * i for i in range(16)], 1),
    _p("LULESH-G3", "gather", [24 * i for i in range(16)], 8),
    _p("LULESH-G4", "gather", [24 * i for i in range(16)], 4),
    _p("LULESH-G5", "gather", [24 * i for i in range(16)], 1),
    _p("LULESH-G6", "gather", [24 * i for i in range(16)], 8),
    _p("LULESH-G7", "gather", list(range(16)), 41),
]

NEKBONE_GATHERS = [
    _p("NEKBONE-G0", "gather", [6 * i for i in range(16)], 3),
    _p("NEKBONE-G1", "gather", [6 * i for i in range(16)], 8),
    _p("NEKBONE-G2", "gather", [6 * i for i in range(16)], 8),
]

AMG_GATHERS = [
    _p("AMG-G0", "gather",
       [1333, 0, 1, 36, 37, 72, 73, 1296, 1297, 1332, 1368, 1369, 2592, 2593, 2628, 2629], 1),
    _p("AMG-G1", "gather",
       [1333, 0, 1, 2, 36, 37, 38, 72, 73, 74, 1296, 1297, 1298, 1332, 1334, 1368], 1),
]

# --- Scatter patterns (Table 5, lower block) -------------------------------
PENNANT_SCATTERS = [
    _p("PENNANT-S0", "scatter", [0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52, 56, 60], 1),
]

LULESH_SCATTERS = [
    _p("LULESH-S0", "scatter", [8 * i for i in range(16)], 1),
    _p("LULESH-S1", "scatter", [24 * i for i in range(16)], 8),
    _p("LULESH-S2", "scatter", [24 * i for i in range(16)], 1),
    # LULESH-S3: the delta-0 broadcast scatter discussed at length in §5.4
    # (cache-invalidation pathology; only TX2 handles it well).  Table 5 omits
    # its row but §5.4.1/§5.4.2 define it: a scatter with delta 0.
    _p("LULESH-S3", "scatter", list(range(16)), 0),
]

ALL_GATHERS = PENNANT_GATHERS + LULESH_GATHERS + NEKBONE_GATHERS + AMG_GATHERS
ALL_SCATTERS = PENNANT_SCATTERS + LULESH_SCATTERS
ALL_PATTERNS = ALL_GATHERS + ALL_SCATTERS

BY_APP: dict[str, list[Pattern]] = {}
for _pat in ALL_PATTERNS:
    BY_APP.setdefault(_pat.source, []).append(_pat)


def get(name: str) -> Pattern:
    for p in ALL_PATTERNS:
        if p.name == name:
            return p
    raise KeyError(name)


def scale_counts(patterns: list[Pattern], scale: float,
                 max_footprint: int = 1 << 27) -> list[Pattern]:
    """Scale every pattern's count (e.g. tiny counts for CPU-container runs).

    Counts are additionally capped so the sparse buffer stays below
    ``max_footprint`` elements (PENNANT's delta-1.8M patterns would exceed
    int32 indexing at full count on a scaled-down host).
    """
    out = []
    for p in patterns:
        count = max(1, int(p.count * scale))
        if p.delta > 0:
            count = min(count, max(1, (max_footprint - p.span) // p.delta))
        out.append(Pattern(name=p.name, kind=p.kind, index=p.index,
                           delta=p.delta, count=count, source=p.source))
    return out
