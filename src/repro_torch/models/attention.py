"""GQA attention (llama3-8b) over a paged KV cache.

The port of ``repro/models/attention.py:29-134`` (GQA only; MLA is not
ported), with its parameter names and layouts: ``wq`` (d, H, dh), ``wk`` and
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
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_decode.ops import paged_decode_attention
from .common import _NOT_PORTED, ParamDef, apply_rope, make_params

PAGE_SIZE = 16


def gqa_defs(cfg) -> dict:
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {"wq": ParamDef((d, h, dh)), "wk": ParamDef((d, kvh, dh)),
            "wv": ParamDef((d, kvh, dh)), "wo": ParamDef((h, dh, d))}


class GQA(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        if cfg.attn_kind != "full" or cfg.attn_softcap:
            raise NotImplementedError(
                f"attention {cfg.attn_kind!r} (softcap {cfg.attn_softcap}) "
                f"is not ported: {_NOT_PORTED}")
        self.defs = gqa_defs(cfg)
        make_params(self, self.defs, device, dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).reshape(*x.shape[:2], h, e)


def _qkv(cfg, p: GQA, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,d) -> q (B,S,KVH,G,dh), k and v (B,S,KVH,dh), RoPE applied."""
    kvh, dh = cfg.n_kv_heads, cfg.dh
    q = apply_rope(_proj(x, p.wq), positions, cfg.rope_theta, cfg.rope)
    k = apply_rope(_proj(x, p.wk), positions, cfg.rope_theta, cfg.rope)
    v = _proj(x, p.wv)
    b, s = x.shape[:2]
    return q.reshape(b, s, kvh, cfg.n_heads // kvh, dh), k, v


def _out(p: GQA, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,dh) -> einsum("bshe,hed->bsd", o, wo)."""
    h, e, d = p.wo.shape
    return o.reshape(*o.shape[:2], h * e) @ p.wo.reshape(h * e, d)


def gqa_apply(cfg, p: GQA, x: torch.Tensor, positions: torch.Tensor, *,
              cache: dict | None = None):
    """Prefill attention. x (B,S,d); positions (S,) or (B,S).  With a
    ``cache``, its pages receive this sequence's K/V at positions 0..S-1.
    Returns (y (B,S,d), cache)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    q, k, v = _qkv(cfg, p, x, positions)
    b, s, kvh, g, dh = q.shape
    o = flash_attention(q.permute(0, 2, 3, 1, 4).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=True)
    y = _out(p, o.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, dh))
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


def gqa_decode(cfg, p: GQA, x: torch.Tensor, pos: int, cache: dict):
    """Single-token decode. x (B,1,d); pos: the position of this token.

    Writes its K/V at slot ``pos`` and attends over positions 0..pos of
    every row through the paged-decode kernel (lengths pos + 1, as
    ``repro/models/attention.py:128`` keeps ``kv_pos <= pos``).  Returns (y (B,1,d), cache).
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
                               cache["v_pages"], table, lengths)
    return _out(p, o.reshape(b, 1, cfg.n_heads, cfg.dh)), cache


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
