"""Plain PyTorch version of the row gather kernels."""
import torch


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, n, :] = table[b, idx[b, n], :]; indices outside [0, V) read 0.

    table (B, V, D), idx (B, N) int32 -> (B, N, D).
    """
    bsz, v, d = table.shape
    n = idx.shape[1]
    valid = (idx >= 0) & (idx < v)
    base = torch.arange(bsz, device=idx.device, dtype=torch.int64)[:, None] * v
    rows = torch.where(valid, idx, 0).to(torch.int64) + base
    out = table.reshape(bsz * v, d).index_select(0, rows.reshape(-1))
    return out.reshape(bsz, n, d).masked_fill_(~valid[..., None], 0.0)
