"""Shared model machinery: declared parameters and their init, the RMS norm,
the MLPs (SwiGLU, GeGLU and plain GELU), the causal conv of the mamba and
RG-LRU blocks, RoPE over the whole head or its first half, query-chunked
attention.

The port of ``repro/models/common.py:24-229``.  A module declares its
parameters as ``ParamDef``s (shape, init, scale) in the JAX package's
names and layouts (weights are (in, out), so a layer is ``x @ w``);
``make_params`` allocates them, uninitialised, on a device (``meta``
allocates nothing), and ``init_params`` draws them from an explicit
``torch.Generator``, leaf by leaf, in the working dtype: ``normal`` draws
N(0, 1) times ``scale`` (``None`` -> 1/sqrt(fan_in)), ``zeros`` and
``ones`` fill.  Parameters are registered holding no gradient, for
serving; ``zoo.Model.init(trainable=True)`` turns it on for training.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # None -> 1/sqrt(fan_in)


def fan_in(shape: tuple[int, ...]) -> int:
    return shape[0] if len(shape) > 1 else max(1, shape[0])


def make_params(module: nn.Module, defs: dict, device, dtype) -> None:
    """Register one uninitialised parameter per ``ParamDef`` of ``defs``."""
    for name, d in defs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(d.shape, device=device, dtype=dtype),
            requires_grad=False))


@torch.no_grad()
def init_params(module: nn.Module, defs: dict,
                generator: torch.Generator) -> None:
    """Draw ``module``'s declared parameters, in declaration order."""
    for name, d in defs.items():
        p = getattr(module, name)
        if d.init == "zeros":
            p.zero_()
        elif d.init == "ones":
            p.fill_(1.0)
        else:
            scale = d.scale if d.scale is not None else 1.0 / math.sqrt(
                fan_in(d.shape))
            p.normal_(generator=generator).mul_(scale)


class RMSNorm(nn.Module):
    """``{"scale": (d,)}``, init ones."""

    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__()
        self.defs = {"scale": ParamDef((d,), init="ones")}
        make_params(self, self.defs, device, dtype)


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Float32 inside, as the JAX package's ``rms_norm``."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)


# block kinds and families of the JAX package that the port does not run yet
_NOT_PORTED = "ROADMAP A7 (the model side)"


def mlp_def(cfg, d_in: int, d_ff: int) -> dict:
    """``wi``, ``wg`` (d_in, d_ff) and ``wo`` (d_ff, d_in) for the gated
    MLPs, SwiGLU and GeGLU; ``wi`` and ``wo`` alone for the plain GELU
    MLP (``gelu``)."""
    if cfg.mlp_kind not in ("swiglu", "geglu", "gelu"):
        raise NotImplementedError(
            f"mlp_kind {cfg.mlp_kind!r} is not ported: {_NOT_PORTED}")
    if cfg.mlp_kind == "gelu":
        return {"wi": ParamDef((d_in, d_ff)), "wo": ParamDef((d_ff, d_in))}
    return {"wi": ParamDef((d_in, d_ff)), "wg": ParamDef((d_in, d_ff)),
            "wo": ParamDef((d_ff, d_in))}


class MLP(nn.Module):
    def __init__(self, cfg, d_in: int, d_ff: int, *, device=None,
                 dtype=None):
        super().__init__()
        self.defs = mlp_def(cfg, d_in, d_ff)
        make_params(self, self.defs, device, dtype)


def mlp_apply(cfg, p: MLP, x: torch.Tensor) -> torch.Tensor:
    """act(x wg) * (x wi), then wo: SiLU for ``swiglu``; for ``geglu`` the
    tanh approximation of GELU, as ``jax.nn.gelu`` defaults to (the exact
    erf GELU differs by up to a few 1e-4).  ``gelu``: that GELU of x wi,
    then wo."""
    h = x @ p.wi
    if cfg.mlp_kind == "gelu":
        return F.gelu(h, approximate="tanh") @ p.wo
    g = x @ p.wg
    act = (F.silu(g) if cfg.mlp_kind == "swiglu"
           else F.gelu(g, approximate="tanh"))
    return (act * h) @ p.wo


def causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                conv_state=None):
    """Depthwise causal conv of x (B,S,C) with K taps ``conv_w`` (K, C) and
    ``conv_b`` (C,), after ``conv_state`` (the previous K-1 inputs; zeros
    when None): the sum of the K shifted products in tap order, then the
    bias, as the JAX package's mamba and RG-LRU blocks compute it.
    Returns (y, the last K-1 inputs)."""
    k = conv_w.shape[0]
    pad = (x.new_zeros((x.shape[0], k - 1, x.shape[2]))
           if conv_state is None else conv_state)
    xp = torch.cat([pad, x], dim=1)                         # (B,S+K-1,C)
    y = sum(xp[:, i:i + x.shape[1]] * conv_w[i] for i in range(k))
    # a copy, not a view: a view would keep the whole (B,S,C) xp alive
    new_state = xp[:, -(k - 1):].clone() if k > 1 else pad
    return y + conv_b, new_state


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mode: str = "full") -> torch.Tensor:
    """x (..., S, H, dh); positions (..., S).  mode: full | none, or any
    other (``2d``, ``partial``) for half the head: as the JAX package's
    ``apply_rope`` computes it, the first rot = dh // 2 columns are
    rotated as two split halves (not interleaved pairs), at frequencies
    over rot, and the last dh - rot pass through.  Float32 inside, rounded
    once to x's dtype."""
    if mode == "none":
        return x
    dh = x.shape[-1]
    rot = dh if mode == "full" else dh // 2
    freqs = rope_freqs(rot, theta, x.device)                 # (rot/2,)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                        dim=-1).to(x.dtype)
    if rot == dh:
        return rotated
    return torch.cat([rotated, x[..., rot:]], dim=-1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      chunk: int, causal: bool = True, window: int = 0,
                      attn_softcap: float = 0.0, q_offset: int = 0,
                      scale: float | None = None) -> torch.Tensor:
    """Query-chunked attention, plain torch: the port of the JAX package's
    ``chunked_attention`` (``repro/models/common.py:166-229``), which is
    plain ``jnp`` there too (no Pallas kernel).

    q (B, S, KVH, G, dh); k (B, T, KVH, dh); v (B, T, KVH, dv), dv may
    differ from dh (MLA) -> (B, S, KVH, G, dv) in q's dtype.  Scores in
    float32, masked at -1e30, softmax.  Chunking the queries keeps the
    scores at (B, KVH, G, chunk, T); where S is no multiple of ``chunk``
    one chunk takes all S queries, as there.
    """
    b, s, kvh, g, dh = q.shape
    t = k.shape[1]
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # ragged: fall back to a single chunk
    k32 = k.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]  # B,KVH,1,dh,T
    v32 = v.to(torch.float32).transpose(1, 2)[:, :, None]      # B,KVH,1,T,dv
    kv_pos = torch.arange(t, device=q.device)
    out = torch.empty((b, s, kvh, g, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, s, chunk):
        qc = q[:, q0:q0 + chunk].to(torch.float32).permute(0, 2, 3, 1, 4)
        scores = softcap((qc @ k32) * scale, attn_softcap)  # B,KVH,G,c,T
        q_pos = q0 + q_offset + torch.arange(chunk, device=q.device)
        mask = torch.ones((chunk, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        p = torch.softmax(scores.masked_fill_(~mask, -1e30), dim=-1)
        del scores
        out[:, q0:q0 + chunk] = (p @ v32).permute(0, 3, 1, 2, 4).to(q.dtype)
    return out
