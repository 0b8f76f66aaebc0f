"""Gather / scatter backends: the port of ``repro.core.backends``.

    torch   index_select / index_put_ / index_add_: what the framework does
            on its own (the role ``xla`` plays in the JAX package)
    onehot  gather and scatter as one-hot matrix products
    scalar  one row per Python step: the no-vector baseline, for tests only
    hopper  the hand-written CUDA kernels (``kernels/``), the role
            ``pallas`` plays: the paper's hand-tuned backend

One contract, batched: the leading dim is the pattern batch of a planner
bucket, so one call runs a whole bucket.

    gather_batched(src, idx)              src (B, F, R), idx (B, N)
                                          -> (B, N, R)
    scatter_batched(dst, idx, vals, ...)  vals (B, N, R); writes dst (B, F, R)
                                          IN PLACE and returns it

Scatters update ``dst`` in place, where the JAX package returns a new
array and donates the old one; the engine and planner hand every timed run
a fresh zeroed dst.  ``mode="store"`` is last-write-wins: ``keep`` (B, N)
is the host-computed keep mask (``host.keep_last_mask``), True on at most
one lane per destination row, and lanes it drops write nothing; nothing
sorts inside a timed call (DESIGN.md §2.1).  A store given ``cov`` ((B, F)
int32, zeroed) also marks the rows it wrote there: the hopper backend in
its kernel's launch, the others through the plain version
(``store_coverage_``); the lane-sharded combine selects by it
(``plan.Placement``).  ``mode="add"`` sums
duplicates into ``dst``.  The per-pattern ``gather``/``scatter`` are the
B = 1 case.  Indices must lie in [0, F): the planner sends padding lanes
to its scratch row.  Tables and payloads are float32, bfloat16 or float16
(``DTYPES``); every backend runs in their dtype (hopper through its
kernels' instance of that dtype).
"""
from __future__ import annotations

from typing import Callable

import torch

from .kernels._build import DTYPES   # float32, bfloat16, float16
from .kernels.gather_rows import ops as gather_ops
from .kernels.scatter_rows import ops as scatter_ops
from .kernels.scatter_rows.ref import store_coverage_

BACKENDS = ("torch", "onehot", "scalar", "hopper")
SCATTER_MODES = ("store", "add")

# a (B, N, F) one-hot with F beyond this is a mistake, not a benchmark
_ONEHOT_MAX_FOOTPRINT = 1 << 22


def _flat_rows(idx: torch.Tensor, f: int) -> torch.Tensor:
    """(B, N) int32 row indices -> (B*N,) int64 rows of the (B*F, R) view."""
    base = torch.arange(idx.shape[0], device=idx.device,
                        dtype=torch.int64)[:, None] * f
    return (idx.to(torch.int64) + base).reshape(-1)


# -- torch --------------------------------------------------------------------

def gather_torch(src, idx):
    b, f, r = src.shape
    out = src.reshape(b * f, r).index_select(0, _flat_rows(idx, f))
    return out.reshape(b, idx.shape[1], r)


def scatter_torch(dst, idx, vals, mode, keep):
    b, f, r = dst.shape
    rows, flat_vals = _flat_rows(idx, f), vals.reshape(-1, r)
    flat_dst = dst.view(b * f, r)
    if mode == "add":
        flat_dst.index_add_(0, rows, flat_vals)
    else:
        # compacting the kept lanes is a boolean index: it synchronises
        # with the host, which the hopper kernel avoids
        k = keep.reshape(-1)
        flat_dst.index_put_((rows[k],), flat_vals[k])
    return dst


# -- onehot -------------------------------------------------------------------

def _onehot(idx, f, dtype):
    if f > _ONEHOT_MAX_FOOTPRINT:
        raise ValueError(f"onehot backend: footprint {f} too large")
    return torch.nn.functional.one_hot(idx.to(torch.int64), f).to(dtype)


def gather_onehot(src, idx):
    return torch.bmm(_onehot(idx, src.shape[1], src.dtype), src)


def scatter_onehot(dst, idx, vals, mode, keep):
    oh = _onehot(idx, dst.shape[1], vals.dtype)              # (B, N, F)
    if mode == "add":
        return dst.add_(torch.bmm(oh.transpose(1, 2), vals))
    oh = oh * keep[..., None].to(vals.dtype)
    covered = oh.sum(dim=1).clamp(0, 1)[..., None]           # (B, F, 1)
    return dst.copy_(dst * (1 - covered) + torch.bmm(oh.transpose(1, 2), vals))


# -- scalar -------------------------------------------------------------------

def gather_scalar(src, idx):
    out = torch.zeros(idx.shape + (src.shape[2],), dtype=src.dtype,
                      device=src.device)
    for b in range(idx.shape[0]):
        for i, row in enumerate(idx[b].tolist()):
            out[b, i] = src[b, row]
    return out


def scatter_scalar(dst, idx, vals, mode, keep):
    # lanes in order: the last write to a row wins without any mask
    del keep
    for b in range(idx.shape[0]):
        for i, row in enumerate(idx[b].tolist()):
            if mode == "add":
                dst[b, row] += vals[b, i]
            else:
                dst[b, row] = vals[b, i]
    return dst


# -- hopper -------------------------------------------------------------------

def gather_hopper(src, idx, tiles=None):
    return gather_ops.gather_rows(src, idx, tiles)


def scatter_hopper(dst, idx, vals, mode, keep, tiles=None, cov=None):
    if mode == "add":
        return scatter_ops.scatter_add_rows_(
            dst, idx, vals, smem=None if tiles is None else tiles.smem)
    return scatter_ops.scatter_store_rows_(
        dst, idx, keep, vals, cov, vecs=None if tiles is None else tiles.vecs)


GATHER_FNS: dict[str, Callable] = {
    "torch": gather_torch, "onehot": gather_onehot,
    "scalar": gather_scalar, "hopper": gather_hopper,
}
SCATTER_FNS: dict[str, Callable] = {
    "torch": scatter_torch, "onehot": scatter_onehot,
    "scalar": scatter_scalar, "hopper": scatter_hopper,
}


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {BACKENDS}")


def check_mode(mode: str) -> None:
    if mode not in SCATTER_MODES:
        raise ValueError(f"unknown mode {mode!r}; "
                         f"expected one of {SCATTER_MODES}")


def check_dtype(dtype) -> torch.dtype:
    """The run's dtype: one of ``DTYPES`` (None: float32); anything else,
    float64 included, raises."""
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype} not supported: one of "
                        f"{', '.join(str(d) for d in DTYPES)}")
    return dtype


def _check_tiles(backend: str, tiles) -> None:
    if tiles is not None and backend != "hopper":
        raise ValueError(f"launch parameters are the hopper backend's, "
                         f"not {backend!r}'s")


def gather_batched(src: torch.Tensor, idx: torch.Tensor, *,
                   backend: str = "torch", tiles=None) -> torch.Tensor:
    """src (B, F, R), idx (B, N) int32 -> (B, N, R); one call per bucket.
    ``tiles``: the hopper kernel's launch parameters
    (``autotune.TileChoice``; None: its wrapper chooses)."""
    _check_tiles(backend, tiles)
    if tiles is not None:
        return gather_hopper(src, idx, tiles)
    return GATHER_FNS[backend](src, idx)


def scatter_batched(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    *, mode: str = "store", backend: str = "torch",
                    keep: torch.Tensor | None = None,
                    cov: torch.Tensor | None = None,
                    tiles=None) -> torch.Tensor:
    """dst (B, F, R), idx (B, N), vals (B, N, R): writes dst in place and
    returns it.  Store mode needs the (B, N) host keep mask; with ``cov``
    ((B, F) int32, zeroed) a store also marks the rows it wrote.
    ``tiles`` as for ``gather_batched``."""
    if mode == "store" and keep is None:
        raise ValueError("store mode needs the host keep mask "
                         "(host.keep_last_mask)")
    _check_tiles(backend, tiles)
    if cov is not None:
        if mode != "store":
            raise ValueError("coverage is a store's: mode must be 'store'")
        if backend == "hopper":
            return scatter_hopper(dst, idx, vals, mode, keep, tiles, cov)
        store_coverage_(cov, idx, keep)
    if tiles is not None:
        return scatter_hopper(dst, idx, vals, mode, keep, tiles)
    return SCATTER_FNS[backend](dst, idx, vals, mode, keep)


def gather(src: torch.Tensor, idx: torch.Tensor, *,
           backend: str = "torch") -> torch.Tensor:
    """src (F, R), idx (N,) -> (N, R): the B = 1 case."""
    return gather_batched(src[None], idx[None], backend=backend)[0]


def scatter(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, *,
            mode: str = "store", backend: str = "torch",
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """dst (F, R), idx (N,), vals (N, R), keep (N,): the B = 1 case, in
    place."""
    scatter_batched(dst[None], idx[None], vals[None], mode=mode,
                    backend=backend,
                    keep=None if keep is None else keep[None])
    return dst
