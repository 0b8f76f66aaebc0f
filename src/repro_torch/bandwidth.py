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

``pipeline_model`` is paper Fig 4's (multi-buffering on and off) on
Hopper: the loads a thread of the global gather keeps in flight, one or
``kVecs``, the choice ``kernels.autotune`` makes for each launch.
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
# threads the card holds at once: 132 SMs x 2,048 threads an SM (the same
# data sheet; what csrc/common.cuh card_threads asks of the runtime)
CARD_THREADS = 132 * 2048
# the time a wave of dependent loads takes, the latency a thread with one
# load in flight waits out: this repository's own measurement, a
# parameter.  The shallow global gather took 1.36 us of device time at
# 4,096 lanes (one wave, launch included), of which ~0.35 us is its
# threads' own vector (probes/autotune_probe.py on an NVIDIA H100 80GB
# HBM3 at 700.00 W; PERF.md)
LOAD_LATENCY_S = 1.0e-6
K_VECS = 4                        # csrc: kVecs, 16-byte vectors a thread


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


def pipeline_model(p: Pattern, elem_bytes: int, *, vecs: int = K_VECS,
                   load_latency_s: float = LOAD_LATENCY_S,
                   card_threads: int = CARD_THREADS) -> dict:
    """Paper Fig 4's analogue on Hopper: loads in flight a thread.

    The global gather's threads each keep ``vecs`` 16-byte vectors in
    flight (the deep instance ``kVecs``, or 1).  The card holds
    ``card_threads`` threads, so a pattern's lanes, ``16 // elem_bytes``
    to a vector (4 float32 lanes, 8 16-bit ones; 1 where a row fills 16
    bytes or more), take ``ceil(lanes / (per_vec * vecs * card_threads))``
    waves, each waiting out ``load_latency_s``.
    With one vector a thread, each wave waits out its latency before its
    bytes move (serialised: prefetch off); with more, the latency overlaps
    the bytes (prefetch on).  The bytes' time is ``h100_sector_model``'s.
    Returns the reference's keys, with ``vecs`` in place of ``buffers``.
    """
    if vecs < 1:
        raise ValueError(f"vecs must be >= 1, got {vecs}")
    sm = h100_sector_model(p, elem_bytes)
    lanes = p.index_len * p.count
    per_vec = max(1, 16 // elem_bytes)
    waves = -(-lanes // (per_vec * vecs * card_threads))
    lat_time = waves * load_latency_s
    bw_time = sm.modeled_time_s
    total = bw_time + lat_time if vecs == 1 else max(bw_time, lat_time)
    return {
        "vecs": vecs,
        "modeled_time_s": total,
        "modeled_gbs": sm.useful_bytes / total / 1e9,
        "bw_time_s": bw_time,
        "latency_time_s": lat_time,
    }
