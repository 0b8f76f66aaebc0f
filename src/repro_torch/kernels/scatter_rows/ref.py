"""Plain PyTorch versions of the row scatter kernels (in place, like them)."""
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


def add_error_bound(idx: torch.Tensor, vals: torch.Tensor,
                    v: int) -> torch.Tensor:
    """Per-element bound on |a - b| for two sum-scatters of ``vals`` into
    zeros that add in different orders (the kernel's atomics reorder the
    additions from run to run).

    A row that receives K values sums them in float32 with error at most
    gamma_K * sum|v_i| in any order, gamma_K = K*u / (1 - K*u) with
    u = 2^-24 (Higham, Accuracy and Stability of Numerical Algorithms,
    §4.2), so two orders differ by at most twice that.  Returns a
    (B, V, D) tensor; rows nothing is added to get 0.
    """
    bsz, n, d = vals.shape
    sel = in_range(idx, v)
    rows = _rows(idx, v, sel)
    absum = torch.zeros(bsz * v, d, dtype=torch.float64, device=vals.device)
    absum.index_add_(0, rows, vals[sel].abs().to(torch.float64))
    k = torch.zeros(bsz * v, dtype=torch.float64, device=vals.device)
    k.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float64))
    u = 2.0 ** -24
    gamma = k * u / (1 - k * u)
    return (2 * gamma[:, None] * absum).reshape(bsz, v, d)
