"""Plain PyTorch versions of the row scatter kernels (in place, like them),
and the error bounds their adds are held to."""
import math

import torch


def in_range(idx: torch.Tensor, v: int) -> torch.Tensor:
    """Which int32 indices name a row of a table of ``v`` rows: [0, v).
    Past INT32_MAX rows every index >= 0 does (``idx < v`` would compare
    with a ``v`` that no int32 holds)."""
    ok = idx >= 0
    if v <= torch.iinfo(torch.int32).max:
        ok &= idx < v
    return ok


def _rows(idx: torch.Tensor, v: int, sel: torch.Tensor) -> torch.Tensor:
    """Flat (B*V)-row numbers of the selected lanes."""
    base = torch.arange(idx.shape[0], device=idx.device,
                        dtype=torch.int64)[:, None] * v
    return (idx.to(torch.int64) + base)[sel]


def scatter_store_rows_ref_(dst: torch.Tensor, idx: torch.Tensor,
                            keep: torch.Tensor, vals: torch.Tensor,
                            cov: torch.Tensor | None = None) -> torch.Tensor:
    """dst[b, idx[b, n]] = vals[b, n] for kept lanes with idx in [0, V).

    The caller's keep mask leaves at most one such lane per row (the
    last-write-wins contract), so the order of the stores does not matter.
    dst (B, V, D), idx (B, N) int32, keep (B, N) bool, vals (B, N, D).
    With ``cov`` ((B, V) int32) also store_coverage_(cov, idx, keep).
    """
    bsz, v, d = dst.shape
    sel = keep & in_range(idx, v)
    dst.view(bsz * v, d)[_rows(idx, v, sel)] = vals[sel]
    if cov is not None:
        store_coverage_(cov, idx, keep)
    return dst


def store_coverage_(cov: torch.Tensor, idx: torch.Tensor,
                    keep: torch.Tensor) -> torch.Tensor:
    """cov[b, idx[b, n]] = 1 for kept lanes with idx in [0, V): the rows a
    store with this keep mask writes (the reference's ``with_covered``
    map).  cov (B, V) int32, in place."""
    bsz, v = cov.shape
    sel = keep & in_range(idx, v)
    cov.view(bsz * v)[_rows(idx, v, sel)] = 1
    return cov


def scatter_add_rows_ref_(dst: torch.Tensor, idx: torch.Tensor,
                          vals: torch.Tensor) -> torch.Tensor:
    """dst[b, idx[b, n]] += vals[b, n] for lanes with idx in [0, V).

    dst (B, V, D), idx (B, N) int32, vals (B, N, D).
    """
    bsz, v, d = dst.shape
    sel = in_range(idx, v)
    dst.view(bsz * v, d).index_add_(0, _rows(idx, v, sel), vals[sel])
    return dst


# unit roundoff of each type the add runs in: 2^-(significand bits)
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
                 torch.float16: 2.0 ** -11}


def _row_sums(idx: torch.Tensor, vals: torch.Tensor, v: int):
    """(sum |v_i| of each row and element, (B*V, D) float64; lanes K of
    each row, (B*V,) float64) over the in-range lanes."""
    bsz, n, d = vals.shape
    sel = in_range(idx, v)
    rows = _rows(idx, v, sel)
    absum = torch.zeros(bsz * v, d, dtype=torch.float64, device=vals.device)
    absum.index_add_(0, rows, vals[sel].abs().to(torch.float64))
    k = torch.zeros(bsz * v, dtype=torch.float64, device=vals.device)
    k.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float64))
    return absum, k


def add_error_bound(idx: torch.Tensor, vals: torch.Tensor,
                    v: int) -> torch.Tensor:
    """Per-element bound on |a - b| for two sum-scatters of ``vals`` into
    zeros that add in different orders (the kernel's atomics reorder the
    additions from run to run), each rounding every sum to ``vals``'
    dtype.

    A row that receives K values sums them with error at most
    gamma_K * sum|v_i| in any order, gamma_K = K*u / (1 - K*u), where u is
    the dtype's unit roundoff (``UNIT_ROUNDOFF``: 2^-24 for float32, 2^-8
    for bfloat16, 2^-11 for float16; Higham, Accuracy and Stability of
    Numerical Algorithms, §4.2), so two orders differ by at most twice
    that.  gamma_K is defined only for K*u < 1, and is no use past 1: a row
    with K*u >= 1/2 gets ``inf`` (a 16-bit sum of that many values has no
    useful bound; LULESH-S3's 2^21 lanes a row at bfloat16, say).  A sum
    that accumulates in float32 and rounds once is within the same bound,
    and so is the hot-row route's (``hot_row_error_bound``) wherever this
    one is finite.  Returns a (B, V, D) float64 tensor; rows nothing is
    added to get 0.
    """
    bsz, _, d = vals.shape
    absum, k = _row_sums(idx, vals, v)
    u = UNIT_ROUNDOFF[vals.dtype]
    ku = k * u
    gamma = torch.where(ku < 0.5, ku / (1 - ku), torch.inf)
    # a row of zeros sums to 0 in any order, whatever its K
    bound = torch.where(absum > 0, 2 * gamma[:, None] * absum, 0.0)
    return bound.reshape(bsz, v, d)


def hot_row_rounds(k: torch.Tensor, ctas: int, dtype) -> torch.Tensor:
    """Roundings to ``dtype`` on a lane's path through the add's hot-row
    route, for rows of K lanes over ``ctas`` blocks a pattern, besides
    the float32 additions in shared memory and in the flushes (at most
    K - 1 of those on any path).  At 16 bits a block rounds its float32
    sum once when it flushes it, and each later flush into the row rounds
    the row's sum once more; fewer than K blocks take lanes of the row, a
    block of one lane flushes a value of the dtype unrounded, so a path
    takes at most min(ctas, K - 1).  float32's flushes are float32
    additions: 0."""
    if dtype == torch.float32:
        return torch.zeros_like(k)
    return torch.clamp(torch.minimum(k - 1, torch.full_like(k, ctas)),
                       min=0)


def hot_row_error_bound(idx: torch.Tensor, vals: torch.Tensor, v: int,
                        ctas: int) -> torch.Tensor:
    """Per-element bound on |hot-row route's sum - exact sum| for the
    sum-scatter of ``vals`` into zeros over ``ctas`` blocks a pattern:
    ((1 + u)^m (1 + 2^-24)^(K - 1) - 1) * sum|v_i|, with m =
    ``hot_row_rounds`` and u the dtype's unit roundoff (each rounding of a
    value multiplies it by at most 1 + u; Higham §3.1).  Finite wherever
    the sums are; for float32 it is the float32 sum's own.  Returns a
    (B, V, D) float64 tensor; rows nothing is added to get 0."""
    bsz, _, d = vals.shape
    absum, k = _row_sums(idx, vals, v)
    m = hot_row_rounds(k, ctas, vals.dtype)
    u = UNIT_ROUNDOFF[vals.dtype]
    rel = torch.expm1(m * math.log1p(u)
                      + (k - 1).clamp(min=0) * math.log1p(2.0 ** -24))
    bound = torch.where(absum > 0, rel[:, None] * absum, 0.0)
    return bound.reshape(bsz, v, d)


def add_rms_error(idx: torch.Tensor, vals: torch.Tensor, v: int,
                  ctas: int | None = None) -> torch.Tensor:
    """A model, not a bound: the size, one standard deviation, of the
    rounding error of a sum-scatter of ``vals`` into zeros, per element:
    sqrt((m + 1) u^2 + f 2^-48) * sqrt((sum v_i)^2 + sum v_i^2).  Each
    rounding errs by at most u times the value it rounds, in either
    direction; m + 1 of them land on a row's sums in the dtype, f on its
    float32 sums, each sum of a size the second factor gives (the largest
    a random order of the lanes reaches, as a root mean square).  On the
    streaming route (``ctas`` None) every lane's atomic rounds in the
    dtype: m = K - 1, f = 0.  On the hot-row route over ``ctas`` blocks a
    pattern, m = ``hot_row_rounds``, f = K - 1.  Where the worst-case
    bounds are too wide to tell a sum from none (``add_error_bound`` is
    inf from K u >= 1/2, ``hot_row_error_bound`` grows as K u sum|v_i|),
    an error a few of these wide is a sum that went wrong.  Returns a
    (B, V, D) float64 tensor; rows nothing is added to get 0."""
    bsz, n, d = vals.shape
    sel = in_range(idx, v)
    rows = _rows(idx, v, sel)
    x = vals[sel].to(torch.float64)
    tot = torch.zeros(bsz * v, d, dtype=torch.float64, device=vals.device)
    sq = torch.zeros_like(tot)
    tot.index_add_(0, rows, x)
    sq.index_add_(0, rows, x * x)
    _, k = _row_sums(idx, vals, v)
    u = UNIT_ROUNDOFF[vals.dtype]
    if ctas is None:
        m, f = (k - 1).clamp(min=0), torch.zeros_like(k)
    else:
        m, f = hot_row_rounds(k, ctas, vals.dtype), (k - 1).clamp(min=0)
    rel = torch.sqrt((m + 1) * u * u + f * 2.0 ** -48)
    sigma = rel[:, None] * torch.sqrt(tot * tot + sq)
    return torch.where(k[:, None] > 0, sigma, 0.0).reshape(bsz, v, d)
