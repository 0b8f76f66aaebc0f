"""GQA attention (llama3-8b; gemma2-27b's local and global layers with its
softcap; kimi-k2-1t-a32b at head size 112; whisper-base's encoder, not
causal, and its decoder's cross-attention over K/V from ``gqa_kv``) over a
paged KV cache, and MLA (deepseek-v2) over a contiguous latent cache.

The port of ``repro/models/attention.py``, with its parameter names and
layouts.  GQA: ``wq`` (d, H, dh), ``wk`` and
``wv`` (d, KVH, dh), ``wo`` (H, dh, d).  The projections, RoPE and the cache
writes are plain torch, as they are plain ``jnp`` there.  Prefill attention
runs the Hopper flash-attention kernel (``kernels/flash_attention``), decode
attention the paged-decode kernel (``kernels/paged_decode``), on every
device: on CPU tensors their wrappers run the plain versions.

The cache.  The JAX package keeps a contiguous (B, max_len, KVH, dh) K and V
per layer and attends over all of it every step; its docstring says the
serving path should run that through ``paged_decode``.  Here that is the
only path: a layer's cache is ``{"k_pages", "v_pages": (KVH, P, PAGE_SIZE,
dh), "page_table": (B, pages_per_seq) int32}`` with ``pages_per_seq =
ceil(max_len / PAGE_SIZE)`` and ``P = B * pages_per_seq``.  The table is
shared by all layers and is a permutation of the pool drawn from a seed, so
each sequence's pages lie scattered through it and the kernel gathers
through the table for real.  Position t of row b is slot t % PAGE_SIZE of
page ``page_table[b, t // PAGE_SIZE]``.  Prefill and decode write the pages
in place (a cache is updated, not copied, which saves a pool per step).

Local layers (gemma2: ``window`` > 0, the JAX package's ``_block_window``)
and the attention softcap.  Prefill passes the window and
``cfg.attn_softcap`` to the flash kernel, decode to the paged-decode
kernel.  A local layer's paged cache keeps every position, as a global
layer's does, and only the kernel's range is windowed (the last
``window`` positions).  The JAX package instead keeps a ring of
``window`` slots for a local layer (``gqa_init_cache``), written at ``pos
% window``: the two attend to the same keys at every step, kept in other
places (``convert``'s cache carriers know only the contiguous layout).

MLA (``mla_*``, the port of ``:141-252``) keeps the JAX package's cache:
contiguous, ``{"c_kv": (B, max_len, kv_lora_rank), "k_pe": (B, max_len,
qk_rope_dim)}`` a layer, written in place.  Its prefill materialises each
head's K and V from the latent and attends through ``chunked_attention``
(q.k over qk_nope + qk_rope = 192 dims, v over 128 at deepseek-v2's
width), plain torch as it is plain ``jnp`` there: the flash kernel takes
one head size of 64 or 128.  Its decode is the absorbed form, scores
against the compressed cache in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_decode.ops import paged_decode_attention
from .common import (_NOT_PORTED, ParamDef, RMSNorm, apply_rope,
                     chunked_attention, make_params, rms_norm)

PAGE_SIZE = 16


def gqa_defs(cfg) -> dict:
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {"wq": ParamDef((d, h, dh)), "wk": ParamDef((d, kvh, dh)),
            "wv": ParamDef((d, kvh, dh)), "wo": ParamDef((h, dh, d))}


class GQA(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        if cfg.attn_kind not in ("full", "local_global"):
            raise NotImplementedError(
                f"attention {cfg.attn_kind!r} is not ported: {_NOT_PORTED}")
        self.defs = gqa_defs(cfg)
        make_params(self, self.defs, device, dtype)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).reshape(*x.shape[:2], h, e)


def _q(cfg, p: GQA, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,d) -> q (B,S,KVH,G,dh), RoPE applied."""
    kvh, dh = cfg.n_kv_heads, cfg.dh
    q = apply_rope(project(x, p.wq), positions, cfg.rope_theta, cfg.rope)
    b, s = x.shape[:2]
    return q.reshape(b, s, kvh, cfg.n_heads // kvh, dh)


def _qkv(cfg, p: GQA, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,d) -> q (B,S,KVH,G,dh), k and v (B,S,KVH,dh), RoPE applied."""
    return (_q(cfg, p, x, positions),) + gqa_kv(cfg, p, x, positions)


def out_proj(p: nn.Module, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,e) -> einsum("bshe,hed->bsd", o, wo)."""
    h, e, d = p.wo.shape
    return o.reshape(*o.shape[:2], h * e) @ p.wo.reshape(h * e, d)


def gqa_kv(cfg, p: GQA, src: torch.Tensor, positions: torch.Tensor):
    """K/V (B,T,KVH,dh) each from an external source sequence src (B,T,d)
    (cross-attention: whisper's decoder over the encoder states), RoPE on
    K as the config has it."""
    if positions.dim() == 1:
        positions = positions[None, :]
    k = apply_rope(project(src, p.wk), positions, cfg.rope_theta, cfg.rope)
    return k, project(src, p.wv)


def gqa_apply(cfg, p: GQA, x: torch.Tensor, positions: torch.Tensor, *,
              cache: dict | None = None, window: int = 0,
              causal: bool = True, kv: tuple | None = None):
    """Prefill attention. x (B,S,d); positions (S,) or (B,S); ``window``
    > 0 for a local layer; ``causal=False`` for an encoder.  ``kv``
    replaces the self-attention K/V with (B,T,KVH,dh) ones from
    ``gqa_kv`` (cross-attention, T may differ from S).  With a ``cache``,
    its pages receive this sequence's K/V at positions 0..S-1.  Returns (y
    (B,S,d), cache)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    if kv is None:
        q, k, v = _qkv(cfg, p, x, positions)
    else:
        q, (k, v) = _q(cfg, p, x, positions), kv
    b, s, kvh, g, dh = q.shape
    o = flash_attention(q.permute(0, 2, 3, 1, 4).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=causal,
                        window=window, softcap=cfg.attn_softcap)
    y = out_proj(p, o.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, dh))
    if cache is not None:
        write_prefill(cache, k, v)
    return y, cache


def n_pages(length: int) -> int:
    """Pages that hold ``length`` positions."""
    return -(-length // PAGE_SIZE)


def page_table(batch: int, pages_per_seq: int, seed: int,
               device) -> torch.Tensor:
    """(batch, pages_per_seq) int32: a permutation of the pool's pages,
    drawn from ``seed`` (numpy, the same on every device)."""
    perm = np.random.default_rng(seed).permutation(batch * pages_per_seq)
    return torch.from_numpy(perm.astype(np.int32).reshape(
        batch, pages_per_seq)).to(device)


def gqa_init_cache(cfg, table: torch.Tensor, dtype, device) -> dict:
    """Zeroed pages for one layer, addressed through ``table`` (shared by
    all layers, from ``page_table``)."""
    shape = (cfg.n_kv_heads, table.numel(), PAGE_SIZE, cfg.dh)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device),
            "page_table": table}


def write_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k, v (B,S,KVH,dh) into the cache's pages at positions 0..S-1
    (the rest of the last page gets zeros, which decode overwrites)."""
    b, s, kvh, dh = k.shape
    table = cache["page_table"]
    n = n_pages(s)
    if n > table.shape[1]:
        raise ValueError(f"{s} positions do not fit the cache's "
                         f"{table.shape[1] * PAGE_SIZE}")
    idx = table[:, :n].reshape(-1).to(torch.int64)
    for name, x in (("k_pages", k), ("v_pages", v)):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n * PAGE_SIZE - s))
        x = x.reshape(b, n, PAGE_SIZE, kvh, dh).permute(3, 0, 1, 2, 4)
        cache[name].index_copy_(1, idx, x.reshape(kvh, b * n, PAGE_SIZE, dh)
                                .to(cache[name].dtype))


def gqa_decode(cfg, p: GQA, x: torch.Tensor, pos: int, cache: dict, *,
               window: int = 0):
    """Single-token decode. x (B,1,d); pos: the position of this token;
    ``window`` > 0 for a local layer.

    Writes its K/V at slot ``pos`` and attends over positions 0..pos of
    every row through the paged-decode kernel (lengths pos + 1, as
    ``repro/models/attention.py:128`` keeps ``kv_pos <= pos``), over the
    last ``window`` of them for a local layer (``:122-127``: the ring's
    slots after the write).  Returns (y (B,1,d), cache).
    """
    b = x.shape[0]
    table = cache["page_table"]
    if not 0 <= pos < table.shape[1] * PAGE_SIZE:
        raise ValueError(f"position {pos} outside the cache's "
                         f"{table.shape[1] * PAGE_SIZE}")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    page = table[:, pos // PAGE_SIZE].to(torch.int64)           # (B,)
    cache["k_pages"][:, page, pos % PAGE_SIZE] = k[:, 0].transpose(0, 1)
    cache["v_pages"][:, page, pos % PAGE_SIZE] = v[:, 0].transpose(0, 1)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    o = paged_decode_attention(q[:, 0].contiguous(), cache["k_pages"],
                               cache["v_pages"], table, lengths,
                               softcap=cfg.attn_softcap, window=window)
    return out_proj(p, o.reshape(b, 1, cfg.n_heads, cfg.dh)), cache


def contiguous_kv(cache: dict, length: int):
    """The cache's K and V gathered through its table: (B, length, KVH, dh)
    each, the JAX package's contiguous layout."""
    table = cache["page_table"]
    b, pps = table.shape
    if length > pps * PAGE_SIZE:
        raise ValueError(f"length {length} > the cache's {pps * PAGE_SIZE}")
    idx = table.reshape(-1).to(torch.int64)
    out = []
    for name in ("k_pages", "v_pages"):
        pages = cache[name]
        x = pages.index_select(1, idx).reshape(pages.shape[0], b,
                                               pps * PAGE_SIZE, -1)
        out.append(x.permute(1, 2, 0, 3)[:, :length])
    return tuple(out)


# -- MLA (deepseek-v2 multi-head latent attention) ----------------------------

def mla_defs(cfg) -> dict:
    """The matrices of ``repro/models/attention.py:141-155``; its two norms
    (``q_norm`` over q_lora_rank, ``kv_norm`` over kv_lora_rank) are
    ``RMSNorm`` submodules of ``MLA``."""
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {"w_dq": ParamDef((d, r_q)), "w_uq": ParamDef((r_q, h, dn + dr)),
            "w_dkv": ParamDef((d, r_kv)), "w_kr": ParamDef((d, dr)),
            "w_uk": ParamDef((r_kv, h, dn)), "w_uv": ParamDef((r_kv, h, dv)),
            "wo": ParamDef((h, dv, d))}


class MLA(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.defs = mla_defs(cfg)
        make_params(self, self.defs, device, dtype)
        self.q_norm = RMSNorm(cfg.q_lora_rank, device=device, dtype=dtype)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, device=device, dtype=dtype)


def _mla_q(cfg, p: MLA, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,d) -> q_nope (B,S,H,dn), q_rope (B,S,H,dr), RoPE applied."""
    dn = cfg.qk_nope_dim
    cq = rms_norm(p.q_norm, x @ p.w_dq, cfg.norm_eps)
    q = project(cq, p.w_uq)                                  # (B,S,H,dn+dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta,
                                   "full")


def _mla_ckv(cfg, p: MLA, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,d) -> the latent c_kv (B,S,r_kv) and k_pe (B,S,dr)."""
    c_kv = rms_norm(p.kv_norm, x @ p.w_dkv, cfg.norm_eps)
    k_pe = apply_rope((x @ p.w_kr)[:, :, None, :], positions, cfg.rope_theta,
                      "full")[:, :, 0]
    return c_kv, k_pe


def mla_apply(cfg, p: MLA, x: torch.Tensor, positions: torch.Tensor, *,
              cache: dict | None = None):
    """Prefill MLA: each head's K/V materialised from the latent.  x
    (B,S,d); positions (S,) or (B,S).  With a ``cache`` (``mla_init_cache``)
    its positions 0..S-1 receive this sequence's c_kv and k_pe (the JAX
    package's ``mla_apply_cache``).  Returns (y (B,S,d), cache)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_pe = _mla_ckv(cfg, p, x, positions)
    k_nope = project(c_kv, p.w_uk)
    v = project(c_kv, p.w_uv)
    # every MLA head has its own K: KVH = H groups of G = 1
    q = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    o = chunked_attention(q, k, v, chunk=cfg.attn_chunk, causal=True,
                          scale=1.0 / math.sqrt(dn + dr))
    y = out_proj(p, o.reshape(b, s, h, dv))
    if cache is not None:
        if s > cache["c_kv"].shape[1]:
            raise ValueError(f"{s} positions do not fit the cache's "
                             f"{cache['c_kv'].shape[1]}")
        cache["c_kv"][:, :s] = c_kv
        cache["k_pe"][:, :s] = k_pe
    return y, cache


def mla_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    """Zeroed latent cache of one layer, contiguous as in the JAX
    package."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                dtype=dtype, device=device)}


def mla_decode(cfg, p: MLA, x: torch.Tensor, pos: int, cache: dict):
    """Absorbed-matrix MLA decode (``repro/models/attention.py:220-252``).
    x (B,1,d); pos: this token's position.  Writes its c_kv and k_pe at
    ``pos`` and scores q against the compressed cache (W_uk folded into
    q), float32, positions 0..pos valid; o_c is cast back to the model
    dtype before W_uv.  Returns (y (B,1,d), cache)."""
    b = x.shape[0]
    t = cache["c_kv"].shape[1]
    if not 0 <= pos < t:
        raise ValueError(f"position {pos} outside the cache's {t}")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)           # (B,1,H,*)
    c_new, kpe_new = _mla_ckv(cfg, p, x, positions)
    cache["c_kv"][:, pos] = c_new[:, 0]
    cache["k_pe"][:, pos] = kpe_new[:, 0]
    c_kv = cache["c_kv"].to(torch.float32)
    k_pe = cache["k_pe"].to(torch.float32)
    q_c = torch.einsum("bshe,rhe->bshr", q_nope, p.w_uk)
    scores = (torch.einsum("bshr,btr->bhst", q_c.to(torch.float32), c_kv)
              + torch.einsum("bshe,bte->bhst", q_rope.to(torch.float32),
                             k_pe))
    scores *= 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    valid = torch.arange(t, device=x.device) <= pos
    prob = torch.softmax(scores.masked_fill_(~valid, -1e30), dim=-1)
    o_c = torch.einsum("bhst,btr->bshr", prob, c_kv)
    o = torch.einsum("bshr,rhe->bshe", o_c.to(x.dtype), p.w_uv)
    return out_proj(p, o), cache
