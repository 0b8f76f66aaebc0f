"""Plain PyTorch version of the selective-scan kernel."""
import torch


def selective_scan_ref(u, dt, b, c, a, d_skip):
    """The sequential recurrence, with a (B, N, D) float32 state.

    u, dt (B, L, D); b, c (B, L, N); a (N, D) float32, negative; d_skip
    (1, D) float32.  Returns y (B, L, D) in u's dtype and h_final (B, N, D)
    float32.  All arithmetic is float32.
    """
    bsz, l, d = u.shape
    u32, dt32, b32, c32 = (t.to(torch.float32) for t in (u, dt, b, c))
    h = torch.zeros((bsz, b.shape[2], d), dtype=torch.float32,
                    device=u.device)
    y = torch.empty((bsz, l, d), dtype=torch.float32, device=u.device)
    for t in range(l):
        da = torch.exp(dt32[:, t, None, :] * a[None])              # (B,N,D)
        h = h * da + (dt32[:, t] * u32[:, t])[:, None, :] * b32[:, t, :, None]
        y[:, t] = (h * c32[:, t, :, None]).sum(1) + d_skip[0] * u32[:, t]
    return y.to(u.dtype), h
