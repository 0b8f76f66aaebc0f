"""Wrappers of the Hopper row-scatter kernels (``csrc/scatter_rows.cu``).

Replace ``repro/kernels/scatter_rows/kernel.py``: ``scatter_store_rows_``
launches the last-write-wins store (for ``scatter_store_rows_kernel``) and
``scatter_add_rows_`` the atomic sum-scatter (for
``scatter_add_rows_kernel``).  Both write in place into the ``dst`` they
are given and return it, as the reference's engine donates its dst: a
caller that times them hands in a fresh zeroed dst for every run.  The
store takes the host keep mask as an operand and drops ``!keep`` and
out-of-range lanes itself, so a bucket is one launch.  Given a ``cov``
operand the store launches its coverage instance instead (for the
reference's ``with_cov=True``): the same pass also marks each row it wrote
in ``cov``, the ballot of the lane-sharded store combine
(``plan.Placement``).

On CPU tensors the wrappers run the plain versions (``ref``); on CUDA
tensors they launch the kernel or raise.  Float32 rows, int32 indices and
a bool keep mask only.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import scatter_add_rows_ref_, scatter_store_rows_ref_


def _checked(dst, idx, vals, keep=None):
    _build.check_operand("dst", dst, torch.float32, 3)
    _build.check_operand("idx", idx, torch.int32, 2)
    _build.check_operand("vals", vals, torch.float32, 3)
    if keep is not None:
        _build.check_operand("keep", keep, torch.bool, 2)
        if keep.shape != idx.shape:
            raise ValueError(f"keep {tuple(keep.shape)} vs idx "
                             f"{tuple(idx.shape)}")
    if (vals.shape[:2] != idx.shape or dst.shape[0] != idx.shape[0]
            or dst.shape[2] != vals.shape[2]):
        raise ValueError(f"bad shapes dst={tuple(dst.shape)} "
                         f"idx={tuple(idx.shape)} vals={tuple(vals.shape)}")
    ops = dict(dst=dst, idx=idx, vals=vals)
    if keep is not None:
        ops["keep"] = keep
    return _build.common_device(**ops)


def scatter_store_rows_(dst: torch.Tensor, idx: torch.Tensor,
                        keep: torch.Tensor, vals: torch.Tensor,
                        cov: torch.Tensor | None = None) -> torch.Tensor:
    """In place: dst[b, idx[b, n]] = vals[b, n] for every lane with
    keep[b, n] and idx[b, n] in [0, V).  dst (B, V, D), idx (B, N) int32,
    keep (B, N) bool, vals (B, N, D).  Contract: at most one such lane per
    row (the host keep mask's), so the result is independent of order.
    With ``cov`` ((B, V) int32, zeroed by the caller) the same launch also
    sets cov[b, row] = 1 for every row it stored."""
    dev = _checked(dst, idx, vals, keep)
    if cov is not None:
        _build.check_operand("cov", cov, torch.int32, 2)
        if cov.shape != dst.shape[:2]:
            raise ValueError(f"cov {tuple(cov.shape)} vs dst "
                             f"{tuple(dst.shape)}")
        _build.common_device(dst=dst, cov=cov)
    if dev.type == "cpu":
        return scatter_store_rows_ref_(dst, idx, keep, vals, cov)
    bsz, v, d = dst.shape
    if idx.numel() and d:
        if cov is None:
            _build.launch("scatter_store_rows", dev, "scatter_rows",
                          "scatter_store_rows_f32", dst.data_ptr(),
                          idx.data_ptr(), keep.data_ptr(), vals.data_ptr(),
                          bsz, idx.shape[1], v, d)
        else:
            _build.launch("scatter_store_rows_cov", dev, "scatter_rows",
                          "scatter_store_rows_cov_f32", dst.data_ptr(),
                          idx.data_ptr(), keep.data_ptr(), vals.data_ptr(),
                          cov.data_ptr(), bsz, idx.shape[1], v, d)
    return dst


def scatter_add_rows_(dst: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """In place: dst[b, idx[b, n]] += vals[b, n] for every lane with
    idx[b, n] in [0, V); duplicates add in no fixed order.  dst (B, V, D),
    idx (B, N) int32, vals (B, N, D)."""
    dev = _checked(dst, idx, vals)
    if dev.type == "cpu":
        return scatter_add_rows_ref_(dst, idx, vals)
    bsz, v, d = dst.shape
    if idx.numel() and d:
        _build.launch("scatter_add_rows", dev, "scatter_rows",
                      "scatter_add_rows_f32", dst.data_ptr(), idx.data_ptr(),
                      vals.data_ptr(), bsz, idx.shape[1], v, d)
    return dst
