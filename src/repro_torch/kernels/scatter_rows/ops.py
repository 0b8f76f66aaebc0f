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

Element types.  dst and vals of float32, bfloat16 or float16 (one dtype
for both), int32 indices, a bool keep mask.  A store moves bits, so one
instance on 2-byte words serves both 16-bit types
(``scatter_store_rows_b16``, ``scatter_store_rows_cov_b16``); the add
sums in its operands' type, by native atomics, so it has an instance a
type (``scatter_add_rows_bf16``, ``scatter_add_rows_f16``).  float32
takes the ``_f32`` instances, each counted under its float32 name.
Nothing converts a 16-bit operand to float32 and back.

The store's loads in flight a thread (``vecs``: its deep or shallow
instance) are chosen by ``kernels.autotune`` for the geometry and the
card unless the caller passes them; ``autotune.disabled()`` serves the
kernel's legacy rule.  The add has no launch parameter.

On CPU tensors the wrappers run the plain versions (``ref``), in the
operands' dtype, which ignore ``vecs``; on CUDA tensors they launch the
kernel of that dtype or raise.
"""
from __future__ import annotations

import torch

from .. import _build, autotune
from .ref import scatter_add_rows_ref_, scatter_store_rows_ref_


def _checked(dst, idx, vals, keep=None):
    _build.check_operand("dst", dst, _build.DTYPES, 3)
    _build.check_operand("idx", idx, torch.int32, 2)
    _build.check_operand("vals", vals, dst.dtype, 3)
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


def tile_key(op: str, bsz: int, n: int, v: int, d: int, platform: str,
             dtype) -> autotune.TileKey:
    """The ``autotune`` key of a (B, V, D) scatter of N lanes of ``dtype``
    (a ``torch.dtype`` or its name)."""
    return autotune.TileKey(op=op, batch=bsz, lanes=n, rows=v, width=d,
                            dtype=str(dtype).removeprefix("torch."),
                            platform=platform)


def scatter_store_rows_(dst: torch.Tensor, idx: torch.Tensor,
                        keep: torch.Tensor, vals: torch.Tensor,
                        cov: torch.Tensor | None = None, *,
                        vecs: int | None = None) -> torch.Tensor:
    """In place: dst[b, idx[b, n]] = vals[b, n] for every lane with
    keep[b, n] and idx[b, n] in [0, V).  dst (B, V, D), idx (B, N) int32,
    keep (B, N) bool, vals (B, N, D).  Contract: at most one such lane per
    row (the host keep mask's), so the result is independent of order.
    With ``cov`` ((B, V) int32, zeroed by the caller) the same launch also
    sets cov[b, row] = 1 for every row it stored.  ``vecs``: loads in
    flight a thread (1, or 4 for D = 1 and 8 otherwise: the deep instance;
    0: the kernel's own rule); None: ``autotune``'s."""
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
    n = idx.shape[1]
    if idx.numel() and d:
        if vecs is None:
            vecs = autotune.choose(tile_key(
                "scatter_store", bsz, n, v, d,
                autotune.cuda_platform(dev.index), dst.dtype)).vecs
        if cov is None:
            name, fn = _build.spatter_instance("scatter_store_rows",
                                               dst.dtype)
            _build.launch(name, dev, "scatter_rows", fn, dst.data_ptr(),
                          idx.data_ptr(), keep.data_ptr(), vals.data_ptr(),
                          bsz, n, v, d, vecs)
        else:
            name, fn = _build.spatter_instance("scatter_store_rows_cov",
                                               dst.dtype)
            _build.launch(name, dev, "scatter_rows", fn, dst.data_ptr(),
                          idx.data_ptr(), keep.data_ptr(), vals.data_ptr(),
                          cov.data_ptr(), bsz, n, v, d, vecs)
    return dst


def scatter_add_rows_(dst: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """In place: dst[b, idx[b, n]] += vals[b, n] for every lane with
    idx[b, n] in [0, V); duplicates add in no fixed order.  dst (B, V, D),
    idx (B, N) int32, vals (B, N, D).

    The kernel adds in the operands' dtype (at 16 bits, each atomic's sum
    is rounded to 16 bits).  It skips a lane whose payload is +0.0 or -0.0
    before it reads the lane's index: adding either changes no value of a
    dst that holds
    no -0.0, and a zeroed dst never does (no sum that starts at +0.0 is
    -0.0).  The planner's padding lanes and scratch patterns carry +0.0
    onto its scratch row (``plan._host_members``), so they cost a read of
    their payload, not an atomic each on one row.  The plain version adds
    every lane."""
    dev = _checked(dst, idx, vals)
    if dev.type == "cpu":
        return scatter_add_rows_ref_(dst, idx, vals)
    bsz, v, d = dst.shape
    if idx.numel() and d:
        name, fn = _build.spatter_instance("scatter_add_rows", dst.dtype)
        _build.launch(name, dev, "scatter_rows", fn, dst.data_ptr(),
                      idx.data_ptr(), vals.data_ptr(), bsz, idx.shape[1], v,
                      d)
    return dst
