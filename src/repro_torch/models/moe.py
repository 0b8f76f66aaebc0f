"""Mixture-of-Experts with the sort-based gather/scatter dispatch.

The port of ``repro/models/moe.py`` (``moe_defs``, ``_capacity`` and
``moe_apply_gspmd``, the ``gspmd_sort`` implementation), with its
parameter names and layouts: ``router`` (d, E); ``experts.wi`` and
``experts.wg`` (E, d, ff), ``experts.wo`` (E, ff, d); the shared SwiGLU
``shared`` at ``d_ff_expert * n_shared_experts``.

The dispatch is the paper's workload on the model side: top-k routing
turns into (token, expert) assignments; a stable sort by expert gives
each assignment a slot in its expert's run, and assignments past the
capacity are dropped; a gather of token rows and a scatter-add into
(E * cap, d) expert buffers (``fill``) feed the experts' batched FFN; a
gather back and a weighted scatter-add into the tokens (``combine``)
return their outputs.  All four go through
``repro_torch.backends`` with the caller's ``backend``: ``hopper`` runs
the hand-written row kernels (``gather_rows``, ``scatter_add_rows``),
``torch`` ``index_select`` / ``index_add_``, as ``xla`` runs ``jnp.take``
and ``.at[].add`` in the JAX package.

Dropped assignments.  The JAX package sends them to index INT32_MAX and
drops them (``mode="drop"``); the port's backends take only indices in
[0, F), so the fill sends them to a scratch row at E * cap of buffers
one row longer, which is sliced off (as the planner sends padding lanes
to its scratch row).  The gather back clips them to E * cap - 1, as
there, and their weight is 0, so the combine adds +0.0 (which the add
kernel skips).  The buffers start zeroed, as the add kernel's contract
asks, and each kept slot receives exactly one row, so they are the
gathered rows bit for bit on every backend.

``moe_impl="ep_shardmap"`` (expert parallelism over a device axis)
raises: one card has no expert axis (ROADMAP A7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import backends as gs_backends
from .common import MLP, ParamDef, make_params, mlp_apply


def moe_defs(cfg) -> dict:
    """``router`` (d, E) at scale 0.02; the experts are ``Experts``'s."""
    return {"router": ParamDef((cfg.d_model, cfg.n_experts), scale=0.02)}


def experts_defs(cfg) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {"wi": ParamDef((e, d, ff)), "wg": ParamDef((e, d, ff)),
            "wo": ParamDef((e, ff, d))}


class Experts(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.defs = experts_defs(cfg)
        make_params(self, self.defs, device, dtype)


class MoE(nn.Module):
    """``router``, ``experts`` and, where the config has shared experts,
    ``shared``."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.defs = moe_defs(cfg)
        make_params(self, self.defs, device, dtype)
        self.experts = Experts(cfg, device=device, dtype=dtype)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, cfg.d_model,
                              cfg.d_ff_expert * cfg.n_shared_experts,
                              device=device, dtype=dtype)


def capacity(cfg, n_tokens: int) -> int:
    """Slots an expert, the JAX package's ``_capacity``: capacity_factor x
    n x top_k / E, rounded up to a multiple of 4, at least top_k."""
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cfg.top_k, (c + 3) // 4 * 4)


def route(cfg, p: MoE, xt: torch.Tensor):
    """xt (N, d) -> (top-k experts (N, k) int64, their weights (N, k)
    float32, the load-balance aux loss).  Float32 softmax over the router
    logits, top-k, the weights normalised (deepseek) and scaled by
    ``router_scale``."""
    n = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax((xt @ p.router).to(torch.float32), dim=-1)
    topw, tope = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    topw = topw * cfg.router_scale
    # Switch-style aux loss: a scatter-add of scalars, plain index_add_
    ce = torch.zeros(e, dtype=torch.float32, device=xt.device).index_add_(
        0, tope.reshape(-1), torch.full((n * k,), 1.0 / (n * k),
                                        device=xt.device))
    return tope, topw, e * (probs.mean(0) * ce).sum()


def dispatch_plan(cfg, tope: torch.Tensor, topw: torch.Tensor, cap: int):
    """The dispatch's indices, from (N, k) top-k experts and weights:
    ``tok`` (N k,) int32, the token of each assignment in expert order;
    ``slot`` (N k,) int32, its buffer row (E * cap for a dropped one: the
    scratch row); ``back`` (N k,) int32, the row the gather back reads
    (clipped to E * cap - 1); ``weight`` (N k,) float32, 0 where dropped;
    ``keep`` (N k,) bool.  The sort is stable, as ``jnp.argsort`` is, so
    an expert's assignments keep token order and capacity drops the
    latest tokens."""
    n, k = tope.shape
    e = cfg.n_experts
    dev = tope.device
    flat_e = tope.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    tok = torch.arange(n, device=dev).repeat_interleave(k)[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(n * k, device=dev) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)
    return dict(tok=tok.to(torch.int32), slot=slot.to(torch.int32),
                back=slot.clamp(max=e * cap - 1).to(torch.int32),
                weight=topw.reshape(-1)[order] * keep, keep=keep)


def fill(cfg, xt: torch.Tensor, plan: dict, cap: int,
         backend: str = "torch"):
    """Gather token rows in expert order and scatter-add them into zeroed
    (E * cap + 1, d) buffers.  Returns (gathered (N k, d), buffers): row
    ``slot`` of the buffers holds its one gathered row, the last row (the
    scratch row) the sum of the dropped ones, which callers slice off."""
    d = xt.shape[1]
    gathered = gs_backends.gather(xt, plan["tok"], backend=backend)
    buffers = torch.zeros((cfg.n_experts * cap + 1, d), dtype=xt.dtype,
                          device=xt.device)
    gs_backends.scatter(buffers, plan["slot"], gathered, mode="add",
                        backend=backend)
    return gathered, buffers


def experts_ffn(p: Experts, buffers: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its buffer: (E, cap, d) -> (E, cap, d),
    three batched matrix products."""
    return (F.silu(buffers @ p.wg) * (buffers @ p.wi)) @ p.wo


def combine(out: torch.Tensor, plan: dict, n: int, backend: str = "torch"):
    """Gather the experts' rows back, weight them, and scatter-add them
    into zeroed (N, d) tokens."""
    e, cap, d = out.shape
    back = gs_backends.gather(out.reshape(e * cap, d), plan["back"],
                              backend=backend)
    back = back * plan["weight"][:, None].to(back.dtype)
    y = torch.zeros((n, d), dtype=out.dtype, device=out.device)
    return gs_backends.scatter(y, plan["tok"], back, mode="add",
                               backend=backend)


def moe_apply(cfg, p: MoE, x: torch.Tensor, backend: str = "torch"):
    """x (B,S,d) -> (y (B,S,d), aux): the ``gspmd_sort`` dispatch
    (``repro/models/moe.py:59-118``), its gathers and scatter-adds through
    ``backend``."""
    if cfg.moe_impl == "ep_shardmap":
        raise NotImplementedError(
            "moe_impl 'ep_shardmap' needs an expert axis over devices, which "
            "one card has no; it is not ported: ROADMAP A7")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    cap = capacity(cfg, b * s)
    tope, topw, aux = route(cfg, p, xt)
    plan = dispatch_plan(cfg, tope, topw, cap)
    _, buffers = fill(cfg, xt, plan, cap, backend)
    e = cfg.n_experts
    out = experts_ffn(p.experts, buffers[:e * cap].view(e, cap, d))
    y = combine(out, plan, b * s, backend)
    if cfg.n_shared_experts:
        y = y + mlp_apply(cfg, p.shared, xt)
    return y.reshape(b, s, d), aux
