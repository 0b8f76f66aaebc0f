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
sums in its operands' type, by the card's float32, packed 16-bit and
16-byte vector reductions, so it has an instance a type
(``scatter_add_rows_bf16``, ``scatter_add_rows_f16``).  float32
takes the ``_f32`` instances, each counted under its float32 name.
Nothing converts a 16-bit operand to float32 and back, except the add's
hot-row route, which sums in float32 shared memory.

The store's loads in flight a thread (``vecs``: its deep or shallow
instance) and the add's route (``smem``: streaming, or the hot-row route
through shared memory, ``add_tiles``) are chosen by ``kernels.autotune``
for the geometry and the card unless the caller passes them;
``autotune.disabled()`` serves the kernel's legacy rule (the add: always
streaming).  Both routes of an add count under one launch name.

On CPU tensors the wrappers run the plain versions (``ref``), in the
operands' dtype, which ignore ``vecs`` and ``smem``; on CUDA tensors they
launch the kernel of that dtype or raise.
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


def _platform(device) -> str:
    return ("cpu" if device.type == "cpu"
            else autotune.cuda_platform(device.index))


def add_tiles(bsz: int, n: int, v: int, d: int, device, dtype
              ) -> autotune.TileChoice:
    """The route a (B, V, D) add of N lanes of ``dtype`` takes on
    ``device`` (``smem`` 1: the hot-row route), as ``scatter_add_rows_``
    chooses it (on the CPU, for ``autotune.CPU_FACTS``)."""
    return autotune.choose(tile_key("scatter_add", bsz, n, v, d,
                                    _platform(device), dtype))


def hot_ctas(bsz: int, n: int, v: int, d: int, device, dtype) -> int:
    """Blocks a pattern that the hot-row route launches for that add
    (``autotune.hot_ctas``): each rounds its sums once."""
    return autotune.hot_ctas(tile_key("scatter_add", bsz, n, v, d,
                                      _platform(device), dtype))


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
                      vals: torch.Tensor, *,
                      smem: int | None = None) -> torch.Tensor:
    """In place: dst[b, idx[b, n]] += vals[b, n] for every lane with
    idx[b, n] in [0, V); duplicates add in no fixed order.  dst (B, V, D),
    idx (B, N) int32, vals (B, N, D).

    Contract: dst holds no -0.0, as a dst zeroed by the caller does (no
    sum that starts at +0.0 is -0.0).  On it the kernel skips a lane whose
    payload is +0.0 or -0.0 before it reads the lane's index (adding
    either changes no value), so the planner's padding lanes and scratch
    patterns, which carry +0.0 onto its scratch row
    (``plan._host_members``), cost a read of their payload, not an atomic
    each on one row; and at 16 bits it adds a lane through the packed
    reduction on the 4-byte word that holds it, with +0.0 in the word's
    other half, which leaves that half as it was.

    Two routes, ``smem`` (None: ``add_tiles``'s choice): 0 streams the
    lanes into dst by atomics in the operands' dtype (at 16 bits each
    sum is rounded to 16 bits: 16-byte vector reductions where 8 lanes
    land on 8 consecutive aligned rows, packed ones otherwise); 1, the
    hot-row route, has each of ``hot_ctas`` blocks a pattern sum its lanes
    in float32 copies of the pattern's rows in shared memory and add each
    row to dst once, so a row takes at most min(ctas, K - 1) roundings to
    the dtype (``ref.hot_row_rounds``), not K.  Its kernel refuses a
    pattern whose V x D float32 sums pass a block's 227 KB of shared
    memory (the launch raises); the choice takes it only within
    ``autotune.HOT_SMEM_BYTES``.  The plain version adds every lane."""
    dev = _checked(dst, idx, vals)
    if dev.type == "cpu":
        return scatter_add_rows_ref_(dst, idx, vals)
    bsz, v, d = dst.shape
    n = idx.shape[1]
    if idx.numel() and d:
        key = tile_key("scatter_add", bsz, n, v, d, _platform(dev),
                       dst.dtype)
        if smem is None:
            smem = autotune.choose(key).smem
        ctas = autotune.hot_ctas(key) if smem else 0
        name, fn = _build.spatter_instance("scatter_add_rows", dst.dtype)
        _build.launch(name, dev, "scatter_rows", fn, dst.data_ptr(),
                      idx.data_ptr(), vals.data_ptr(), bsz, n, v, d, ctas)
    return dst
