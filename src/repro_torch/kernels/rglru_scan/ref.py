"""Plain PyTorch version of the RG-LRU recurrence kernel."""
import math

import torch


def fma_f32(a, b, c):
    """a b + c for float32 tensors, rounded once to float32: what ``fmaf``
    gives.  The product is exact in float64; the sum's rounding error comes
    from TwoSum, and an inexact sum whose last bit is even moves one ulp
    toward the exact value (round to odd), after which the one rounding to
    float32 (53 >= 24 + 2 bits) is the correctly rounded fused result."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def rglru_scan_ref(a, beta, gx, h0):
    """The per-step loop h_t = a_t h_{t-1} + beta_t gx_t over t, in the
    kernel's order: beta_t gx_t rounded to float32 first, then a_t h_{t-1}
    added to it with one rounding (``fma_f32``).

    a, beta, gx (B, S, W) float32; h0 (B, W) float32.  Returns every h_t
    (B, S, W) and h_S (B, W), float32.
    """
    hs = torch.empty_like(a)
    h = h0.to(torch.float32)
    for t in range(a.shape[1]):
        h = fma_f32(a[:, t], h, beta[:, t] * gx[:, t])
        hs[:, t] = h
    return hs, h.clone()


def rglru_scan_bwd_ref(a, beta, gx, h0, hs, dhs, dh_last=None):
    """The gradient of the recurrence in the backward kernel's order: with
    g the cotangent of h_t, from g = dh_last (0 without) and a_S = 1,
    walking t back, g = a_{t+1} g + dhs_t with one rounding (``fma_f32``),
    then da_t = g h_{t-1} (h0 at t = 0, else ``hs``), dbeta_t = g gx_t,
    dgx_t = g beta_t; dh0 = a_0 g_0.

    All float32: a, beta, gx, hs, dhs (B, S, W); h0, dh_last (B, W).
    Returns (da, dbeta, dgx, dh0).
    """
    g = (torch.zeros_like(h0, dtype=torch.float32) if dh_last is None
         else dh_last.to(torch.float32))
    a_next = torch.ones_like(g)
    da, dbeta, dgx = (torch.empty_like(a) for _ in range(3))
    for t in reversed(range(a.shape[1])):
        g = fma_f32(a_next, g, dhs[:, t])
        da[:, t] = g * (hs[:, t - 1] if t > 0 else h0)
        dbeta[:, t] = g * gx[:, t]
        dgx[:, t] = g * beta[:, t]
        a_next = a[:, t]
    return da, dbeta, dgx, a_next * g
