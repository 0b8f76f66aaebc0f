"""Plain PyTorch versions of the selective-scan kernels, forward and
backward."""
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


def selective_scan_ckpt_ref(u, dt, b, a, chunk):
    """The states that the checkpointing forward writes for the backward:
    the state before every ``chunk``-th step (``ops.CHUNK`` on the card),
    by ``selective_scan_ref``'s recurrence in float32.  u, dt (B, L, D); b
    (B, L, N); a (N, D) float32.  Returns (B, ceil(L / chunk), N, D)
    float32, the kernel's layout: entry k is the state before step k
    chunk (entry 0 the zero state)."""
    bsz, l, d = u.shape
    n = b.shape[2]
    u32, dt32, b32 = (t.to(torch.float32) for t in (u, dt, b))
    h = torch.zeros((bsz, n, d), dtype=torch.float32, device=u.device)
    out = torch.empty((bsz, -(-l // chunk), n, d), dtype=torch.float32,
                      device=u.device)
    for t in range(l):
        if t % chunk == 0:
            out[:, t // chunk] = h
        da = torch.exp(dt32[:, t, None, :] * a[None])              # (B,N,D)
        h = h * da + (dt32[:, t] * u32[:, t])[:, None, :] * b32[:, t, :, None]
    return out


def selective_scan_bwd_ref(u, dt, b, c, a, d_skip, dy, dh_final=None):
    """The gradient of ``selective_scan_ref`` by the backward kernel's
    equations, in float32: the forward's states kept whole, then, with g_t
    the state's cotangent (g_{L-1} = dy C + dh_final), walking t back:

        g_t = dy_t C_t + g_{t+1} dA_{t+1},  dA_t = exp(dt_t a)
        dC_t = sum_d dy_t h_t,   dB_t = sum_d g_t dt_t u_t
        du_t = dy_t D + dt_t sum_n g_t B_t
        ddt_t = sum_n g_t (u_t B_t + h_{t-1} a dA_t)
        da = sum_{b,t} g_t h_{t-1} dt_t dA_t,   dD = sum_{b,t} dy_t u_t

    Returns (du, ddt, db, dc) in u's dtype, rounded once, and da (N, D),
    dd_skip (1, D) float32.
    """
    f32 = torch.float32
    bsz, l, d = u.shape
    n = b.shape[2]
    u32, dt32, b32, c32, dy32 = (t.to(f32) for t in (u, dt, b, c, dy))
    hs = torch.empty((bsz, l + 1, n, d), dtype=f32, device=u.device)
    hs[:, 0] = 0.0                                       # h_{-1}
    for t in range(l):
        da_t = torch.exp(dt32[:, t, None, :] * a[None])
        hs[:, t + 1] = (hs[:, t] * da_t + (dt32[:, t] * u32[:, t])[:, None, :]
                        * b32[:, t, :, None])
    g = (torch.zeros((bsz, n, d), dtype=f32, device=u.device)
         if dh_final is None else dh_final.to(f32).clone())
    du, ddt = (torch.empty((bsz, l, d), dtype=f32, device=u.device)
               for _ in range(2))
    db, dc = (torch.empty((bsz, l, n), dtype=f32, device=u.device)
              for _ in range(2))
    da = torch.zeros((n, d), dtype=f32, device=u.device)
    for t in reversed(range(l)):
        gy = dy32[:, t]                                   # (B, D)
        uu, dd = u32[:, t], dt32[:, t]
        bt, ct = b32[:, t, :, None], c32[:, t, :, None]   # (B, N, 1)
        hp, h = hs[:, t], hs[:, t + 1]
        e = torch.exp(dd[:, None, :] * a[None])           # dA_t (B, N, D)
        g = gy[:, None, :] * ct + g
        dc[:, t] = (gy[:, None, :] * h).sum(2)
        db[:, t] = (g * (dd * uu)[:, None, :]).sum(2)
        du[:, t] = gy * d_skip[0] + dd * (g * bt).sum(1)
        ddt[:, t] = (g * (uu[:, None, :] * bt + hp * a[None] * e)).sum(1)
        da += (g * hp * dd[:, None, :] * e).sum(0)
        g = g * e
    dd_skip = (dy32 * u32).sum((0, 1))[None]
    return (du.to(u.dtype), ddt.to(dt.dtype), db.to(b.dtype), dc.to(c.dtype),
            da, dd_skip)
