"""Bandwidth accounting: the paper's §3.5 formula and an H100 sector model.

    BW = sizeof(elem) * len(index) * count / time

The useful-bytes rate: data the pattern requests, cache reuse allowed.
Every run reports two numbers under two names, never mixed (DESIGN.md
§9):

  * ``measured_gbs``      the paper formula over a time measured on the
    device the run used (the result names it);
  * ``modeled_h100_gbs``  the paper formula over a *modeled* H100 time,
    from ``h100_sector_model``: the port's counterpart of the reference's
    ``tpu_tile_model``.  An H100 moves device memory to L2 in 32-byte
    sectors, so a pattern costs the sectors it touches; "sector
    efficiency" (useful / fetched) plays the cache-line-utilisation role
    of paper Fig 3, and an LRU the size of L2 plays the role of the cache
    that lets app patterns beat STREAM (paper Table 4).  It is a model: no
    number of it was measured.

The reference's ``pipeline_model`` (paper Fig 4) has no counterpart yet.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict

import numpy as np

from .pattern import Pattern

# -- H100 SXM constants ------------------------------------------------------
# device memory rate: NVIDIA H100 Tensor Core GPU datasheet (SXM, 3.35 TB/s)
HBM_BW = 3.35e12                  # bytes/s
# L2 capacity: the same datasheet (50 MB); the card reports it as
# ``torch.cuda.get_device_properties(0).L2_cache_size`` (chip_smoke.py
# checks the two agree)
L2_BYTES = 50 * 1024 * 1024
# unit of a device-memory access: the 32-byte sector (NVIDIA Hopper Tuning
# Guide and CUDA C++ Best Practices Guide, "coalesced access to global
# memory": requests are served in 32-byte sectors)
SECTOR_BYTES = 32
# rate at which the SMs take sectors from L2: a model parameter, not a
# published rate (NVIDIA publishes none for the H100's L2); it only sets
# where an L2-resident pattern's modeled rate saturates
L2_BW = 10e12                     # bytes/s


def useful_bytes(p: Pattern, elem_bytes: int) -> int:
    """Paper §3.5 numerator: data actually requested."""
    return p.index_len * p.count * elem_bytes


def paper_bandwidth(p: Pattern, time_s: float, elem_bytes: int) -> float:
    """The paper's bandwidth formula, in bytes/s."""
    return useful_bytes(p, elem_bytes) / time_s


@dataclasses.dataclass(frozen=True)
class SectorModelResult:
    useful_bytes: int
    touched_bytes: int            # sectors the ops request, L2 hits included
    fetched_bytes: int            # sectors fetched from HBM under the LRU
    sector_efficiency: float      # useful / fetched (> 1 with reuse)
    hbm_time_s: float
    l2_time_s: float
    modeled_time_s: float         # the larger of the two (a roofline)
    modeled_gbs: float            # paper formula over the modeled time


def op_sectors(index, delta: int, op: int, elem_bytes: int,
               sector_bytes: int = SECTOR_BYTES) -> np.ndarray:
    """Sorted distinct sectors that G/S op ``op`` touches: element ``e =
    delta * op + index[j]`` spans bytes ``[e * elem_bytes, (e + 1) *
    elem_bytes)`` (a row of ``row_width`` floats is one element)."""
    e = delta * op + np.asarray(index, dtype=np.int64)
    first = e * elem_bytes // sector_bytes
    last = ((e + 1) * elem_bytes - 1) // sector_bytes
    spans = first[:, None] + np.arange(int((last - first).max()) + 1)
    return np.unique(spans[spans <= last[:, None]])


@functools.lru_cache(maxsize=4096)
def _sectors(index: tuple, delta: int, n_sim: int, elem_bytes: int,
             sector_bytes: int, capacity: int) -> tuple[int, int]:
    """``(touched, fetched)`` sectors of G/S ops ``0 .. n_sim - 1`` under
    an LRU of ``capacity`` sectors, in op order and, within an op, in
    address order (bounded memo: the planner models every pattern of
    every launch)."""
    per_op = [op_sectors(index, delta, i, elem_bytes, sector_bytes)
              for i in range(n_sim)]
    touched = sum(len(s) for s in per_op)
    distinct = len(np.unique(np.concatenate(per_op)))
    if distinct <= capacity:
        # nothing is ever evicted: each sector misses once, at first touch
        return touched, distinct
    cache: OrderedDict[int, None] = OrderedDict()
    fetched = 0
    for sectors in per_op:
        for s in sectors.tolist():
            if s in cache:
                cache.move_to_end(s)
            else:
                fetched += 1
                cache[s] = None
                if len(cache) > capacity:
                    cache.popitem(last=False)
    return touched, fetched


def h100_sector_model(p: Pattern, elem_bytes: int, *, sim_ops: int = 256,
                      sector_bytes: int = SECTOR_BYTES,
                      l2_bytes: int = L2_BYTES) -> SectorModelResult:
    """Count the 32-byte sectors a pattern fetches from HBM under an LRU
    the size of L2, then take the larger of the HBM and the L2 time.

    Simulates ``min(count, sim_ops)`` consecutive G/S ops exactly and
    extrapolates linearly, as the reference's ``tpu_tile_model`` does
    (patterns are periodic in the base address, so the per-op traffic
    settles within a few ops).
    """
    n_sim = min(p.count, sim_ops)
    touched, fetched = _sectors(tuple(p.index), p.delta, n_sim, elem_bytes,
                                sector_bytes, max(1, l2_bytes // sector_bytes))
    total_fetched = int(fetched / n_sim * p.count) * sector_bytes
    total_touched = int(touched / n_sim * p.count) * sector_bytes
    useful = useful_bytes(p, elem_bytes)
    hbm_t = total_fetched / HBM_BW
    l2_t = total_touched / L2_BW
    modeled_t = max(hbm_t, l2_t, 1e-30)
    return SectorModelResult(
        useful_bytes=useful, touched_bytes=total_touched,
        fetched_bytes=total_fetched,
        sector_efficiency=useful / max(1, total_fetched),
        hbm_time_s=hbm_t, l2_time_s=l2_t, modeled_time_s=modeled_t,
        modeled_gbs=useful / modeled_t / 1e9)
