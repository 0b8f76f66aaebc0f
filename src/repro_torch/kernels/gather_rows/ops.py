"""Wrappers of the Hopper row-gather kernels (``csrc/gather_rows.cu``).

Replace ``repro/kernels/gather_rows/kernel.py``: ``gather_rows_global``
launches the global-memory kernel (for ``gather_rows_dma``),
``gather_rows_smem`` the shared-memory kernel (for ``gather_rows_vmem``),
and ``gather_rows`` picks between them from the shapes, as the reference's
``ops.gather_rows_batched`` picks by table size.

The switch point.  The reference stages a table in VMEM up to 4 MiB, a TPU
figure.  On the H100 the on-chip store is shared memory, at most 227 KB
(232,448 bytes) for one block, so a pattern's (V, D) float32 table is
staged only when ``V * D * 4 <= SMEM_TABLE_BYTES``, and only where the
pattern reads at least half as many rows as it stages (``V <= 2 * N``).
``suites/demo.json`` reaches this kernel through its UNIFORM:8:1 gather
bucket: V = 32,769 rows of 4 bytes (128 KiB) for N = 32,768 lanes.

Lanes per CTA (``smem_lanes_per_cta``).  The kernel runs in clusters of
``SMEM_CLUSTER`` = 8 CTAs, one pattern a cluster: the cluster reads its
table from L2 once (multicast to its 8 shared memories), and each CTA
gathers one run of lanes.  Three terms set the run:

- fill: the batch's lanes spread over the CTAs the card holds at once
  (``smem_resident_ctas``: the clusters that the CUDA runtime's
  ``cudaOccupancyMaxActiveClusters`` says fit, times 8; 15 clusters, 120
  CTAs on an H100 SXM, a cluster's SMs being drawn from one GPC), so a
  large batch stages each table once per SM and streams its lanes in one
  wave;
- at least ``max(256, ceil(V / 8))`` lanes, so a cluster gathers at least
  V lanes for each staging it reads from L2;
- at most ``ceil(N / 8)``: one cluster covers a pattern.

The grid is ``B`` patterns times ``ceil(N / lanes)`` CTAs rounded up to a
whole cluster (``smem_grid``); a CTA past the last lane stages and exits.
Demo's bucket takes one cluster of 4,096 lanes a CTA; 2^24 lanes on the
same table take 15 clusters of 139,811 on an H100 SXM.

On CPU tensors the wrappers run the plain version (``ref``); on CUDA
tensors they launch the kernel or raise.  Float32 tables and int32
indices only.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from .ref import gather_rows_ref

SMEM_TABLE_BYTES = 232448        # 227 KB: the H100's shared memory per block
SMEM_CLUSTER = 8                 # CTAs a cluster (csrc: kCluster)


def use_smem(v: int, n: int, d: int) -> bool:
    """Whether a (V, D) table gathered at N lanes takes the smem regime."""
    return v * d * 4 <= SMEM_TABLE_BYTES and v <= 2 * n


@functools.lru_cache(maxsize=256)
def smem_lanes_per_cta(bsz: int, n: int, v: int, resident: int) -> int:
    """Lanes one CTA of the smem kernel gathers, on a card that holds
    ``resident`` of its CTAs at once (see the module note)."""
    fill = -(-bsz * n // resident)
    least = max(256, -(-v // SMEM_CLUSTER))
    return max(1, min(max(fill, least), -(-n // SMEM_CLUSTER)))


def smem_grid(bsz: int, n: int, v: int, resident: int) -> int:
    """CTAs the smem kernel launches: whole clusters, one pattern each."""
    runs = -(-n // smem_lanes_per_cta(bsz, n, v, resident))
    return bsz * -(-runs // SMEM_CLUSTER) * SMEM_CLUSTER


@functools.lru_cache(maxsize=256)
def smem_resident_ctas(v: int, d: int, index: int) -> int:
    """CTAs of the smem kernel that card ``index`` holds at once for a
    (V, D) table: the clusters the CUDA runtime says fit, times
    ``SMEM_CLUSTER``.  Asked once per card and shape (builds the kernel);
    raises where no cluster fits."""
    import ctypes
    clusters = ctypes.c_int(0)
    fn = _build.c_function("gather_rows", "gather_rows_smem_clusters")
    with torch.cuda.device(index):
        err = fn(v, d, ctypes.addressof(clusters))
    if err != 0:
        raise RuntimeError(f"gather_rows_smem_clusters: CUDA error {err}")
    if clusters.value < 1:
        raise RuntimeError(f"no cluster of {SMEM_CLUSTER} CTAs of the "
                           f"shared-memory gather fits on cuda:{index} for "
                           f"a ({v}, {d}) table")
    return clusters.value * SMEM_CLUSTER


def _checked(table: torch.Tensor, idx: torch.Tensor):
    _build.check_operand("table", table, torch.float32, 3)
    _build.check_operand("idx", idx, torch.int32, 2)
    if table.shape[0] != idx.shape[0]:
        raise ValueError(f"batch mismatch: table {tuple(table.shape)} vs "
                         f"idx {tuple(idx.shape)}")
    return _build.common_device(table=table, idx=idx)


def gather_rows_global(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather from global memory: (B, V, D), (B, N) -> (B, N, D)."""
    dev = _checked(table, idx)
    if dev.type == "cpu":
        return gather_rows_ref(table, idx)
    bsz, v, d = table.shape
    n = idx.shape[1]
    out = torch.empty((bsz, n, d), dtype=table.dtype, device=dev)
    if out.numel():
        _build.launch("gather_rows", dev, "gather_rows", "gather_rows_f32",
                      table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                      bsz, n, v, d)
    return out


def gather_rows_smem(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather with each pattern's table staged in shared memory:
    (B, V, D), (B, N) -> (B, N, D).  Raises if a table exceeds 227 KB."""
    dev = _checked(table, idx)
    bsz, v, d = table.shape
    if v * d * 4 > SMEM_TABLE_BYTES:
        raise ValueError(f"table of {v * d * 4} bytes exceeds the "
                         f"{SMEM_TABLE_BYTES}-byte shared-memory limit")
    if dev.type == "cpu":
        return gather_rows_ref(table, idx)
    n = idx.shape[1]
    out = torch.empty((bsz, n, d), dtype=table.dtype, device=dev)
    if out.numel():
        lanes = smem_lanes_per_cta(bsz, n, v,
                                   smem_resident_ctas(v, d, dev.index))
        _build.launch("gather_rows_smem", dev, "gather_rows",
                      "gather_rows_smem_f32", table.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), bsz, n, v, d, lanes)
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather, (B, V, D), (B, N) -> (B, N, D), in the regime
    ``use_smem`` picks: one kernel launch for the whole batch."""
    _, v, d = table.shape
    if use_smem(v, idx.shape[-1], d):
        return gather_rows_smem(table, idx)
    return gather_rows_global(table, idx)
