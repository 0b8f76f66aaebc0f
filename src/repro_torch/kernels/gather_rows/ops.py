"""Wrappers of the Hopper row-gather kernels (``csrc/gather_rows.cu``).

Replace ``repro/kernels/gather_rows/kernel.py``: ``gather_rows_global``
launches the global-memory kernel (for ``gather_rows_dma``),
``gather_rows_smem`` the shared-memory kernel (for ``gather_rows_vmem``),
and ``gather_rows`` picks between them from the shapes, as the reference's
``ops.gather_rows_batched`` picks by table size.

The switch point.  The reference stages a table in VMEM up to 4 MiB, a TPU
figure.  On the H100 the on-chip store is shared memory, at most 227 KB
(232,448 bytes) for one block, so a pattern's (V, D) float32 table is
staged only when ``V * D * 4 <= SMEM_TABLE_BYTES``.  Every CTA restages its
table, so the regime must also gather enough to pay for that: it is taken
only where the pattern reads at least half as many rows as it stages
(``V <= 2 * N``), and each CTA gathers at least ``V`` lanes
(``smem_lanes_per_cta``), so restaging reads at most as many bytes as the
CTA writes, and those reads come from L2, which holds every such table.
Where that rule would leave SMs idle (fewer CTAs than the card's 132 SMs),
the runs are cut shorter, down to 256 lanes, to fill the card.
``suites/demo.json`` reaches this kernel through its UNIFORM:8:1 gather
bucket: V = 32,769 rows of 4 bytes (128 KiB) for N = 32,768 lanes.

On CPU tensors the wrappers run the plain version (``ref``); on CUDA
tensors they launch the kernel or raise.  Float32 tables and int32
indices only.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import gather_rows_ref

SMEM_TABLE_BYTES = 232448        # 227 KB: the H100's shared memory per block
N_SMS = 132                      # streaming multiprocessors of an H100 SXM


def use_smem(v: int, n: int, d: int) -> bool:
    """Whether a (V, D) table gathered at N lanes takes the smem regime."""
    return v * d * 4 <= SMEM_TABLE_BYTES and v <= 2 * n


def smem_lanes_per_cta(bsz: int, n: int, v: int) -> int:
    """Lanes one CTA of the smem kernel gathers (see the module note)."""
    fill = -(-bsz * n // N_SMS)          # lanes per CTA with one CTA per SM
    return max(256, min(max(v, 1024), fill))


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
        _build.launch("gather_rows_smem", dev, "gather_rows",
                      "gather_rows_smem_f32", table.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), bsz, n, v, d,
                      smem_lanes_per_cta(bsz, n, v))
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather, (B, V, D), (B, N) -> (B, N, D), in the regime
    ``use_smem`` picks: one kernel launch for the whole batch."""
    _, v, d = table.shape
    if use_smem(v, idx.shape[-1], d):
        return gather_rows_smem(table, idx)
    return gather_rows_global(table, idx)
