"""Decoder-LM assembly: embedding (a Spatter gather), blocks, decode.

The port of ``repro/models/transformer.py`` for the families ported so far
(``ssm``: falcon-mamba-7b; ``dense``: llama3-8b, and gemma2-27b with its
alternating local and global layers, tied table and softcaps; ``moe``
with MLA: deepseek-v2-236b, with GQA: kimi-k2-1t-a32b (the JAX package's
config: GQA at head size 112, not the published model's MLA); ``hybrid``:
recurrentgemma-9b, RG-LRU blocks
and local attention in its (rec, rec, attn) pattern).  The JAX package
scan-stacks each stage's layers on a leading axis; here each layer is its
own ``Block`` in an ``nn.ModuleList``, in ``stage_layout`` order, and a
cache is a list with one entry per layer (a GQA layer's is paged, an MLA
layer's contiguous, ``attention.py``; a mamba or RG-LRU layer's a state
that does not grow).  ``gs_backend`` (default
``torch``, the counterpart of the JAX package's ``xla``) selects the
``repro_torch.backends`` implementation of the indexed ops: the embedding
gather and the MoE dispatch's gathers and scatter-adds.  Other block
kinds and families raise, naming the ROADMAP item that will port them.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import backends as gs_backends
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import (_NOT_PORTED, MLP, ParamDef, RMSNorm, init_params,
                     make_params, mlp_apply, rms_norm, softcap)


def embed_defs(cfg) -> dict:
    """The (vocab, d) table and, unless the config ties them (gemma2), the
    (d, vocab) unembedding."""
    defs = {"table": ParamDef((cfg.vocab, cfg.d_model), scale=1.0)}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab))
    return defs


class Embed(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.defs = embed_defs(cfg)
        make_params(self, self.defs, device, dtype)


def embed_lookup(cfg, p: Embed, tokens: torch.Tensor,
                 backend: str = "torch") -> torch.Tensor:
    """(B,S) int -> (B,S,d): a row gather over the vocab table, through the
    port's gather backends (``torch`` is the framework's own, as ``xla``
    is the JAX package's default), with int32 indices as there."""
    b, s = tokens.shape
    flat = gs_backends.gather(p.table, tokens.reshape(-1).to(torch.int32),
                              backend=backend)
    return flat.reshape(b, s, cfg.d_model)


def unembed_logits(cfg, p: Embed, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> logits (..., vocab): through the table itself where it
    is tied (``x @ table.T``), then the logit softcap where the config has
    one."""
    logits = x @ (p.table.T if cfg.tie_embeddings else p.unembed)
    return softcap(logits, cfg.logit_softcap)


def stage_layout(cfg) -> list[tuple[int, tuple[str, ...]]]:
    """[(n_groups, kinds_per_group), ...] — total layers must match."""
    if cfg.family == "ssm":
        return [(cfg.n_layers, ("mamba",))]
    if cfg.family == "hybrid":
        # the pattern with its attention local, repeated; the remainder of
        # the layers takes the pattern's first kinds as one more group
        pat = tuple("attn_local" if k == "attn" else k
                    for k in cfg.block_pattern or ("rec", "rec", "attn"))
        full, rem = divmod(cfg.n_layers, len(pat))
        return [(full, pat)] + ([(1, pat[:rem])] if rem else [])
    if cfg.family == "dense" and cfg.attn_kind == "local_global":
        if cfg.n_layers % 2:
            raise ValueError("local/global alternation needs an even "
                             f"n_layers, not {cfg.n_layers}")
        return [(cfg.n_layers // 2, ("local", "global"))]
    if cfg.family == "dense" and cfg.attn_kind == "full":
        return [(cfg.n_layers, ("dense",))]
    if cfg.family == "moe":
        out = []
        if cfg.n_dense_layers:
            out.append((cfg.n_dense_layers, ("dense",)))
        out.append((cfg.n_layers - cfg.n_dense_layers, ("moe",)))
        return out
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.arch_id}) is not ported: {_NOT_PORTED}")


class Block(nn.Module):
    """ln1 -> mixer (GQA, or MLA where ``attn_kind`` is ``mla``, or the
    RG-LRU block for ``rec``) -> residual, then ln2 -> channel mixer ->
    residual: the gated MLP (``dense``, ``local``, ``global``, ``rec``,
    ``attn_local``; at ``d_ff_dense`` in a model with leading dense
    layers) or the ``MoE`` (``moe``).  A ``local`` or ``attn_local``
    block attends over the last ``cfg.window`` positions.  A ``mamba``
    block has no channel mixer."""

    def __init__(self, cfg, kind: str, *, device=None, dtype=None):
        super().__init__()
        if kind not in ("mamba", "dense", "local", "global", "moe", "rec",
                        "attn_local"):
            raise NotImplementedError(
                f"block kind {kind!r} is not ported: {_NOT_PORTED}")
        self.kind = kind
        self.window = cfg.window if kind in ("local", "attn_local") else 0
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        if kind == "mamba":
            self.mixer = ssm_mod.Mamba(cfg, device=device, dtype=dtype)
            return
        if kind == "rec":
            mixer = rglru_mod.RGLRU
        else:
            mixer = attn.MLA if cfg.attn_kind == "mla" else attn.GQA
        self.mixer = mixer(cfg, device=device, dtype=dtype)
        self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        if kind == "moe":
            self.mlp = moe_mod.MoE(cfg, device=device, dtype=dtype)
        else:
            d_ff = (cfg.d_ff_dense if cfg.n_dense_layers and cfg.d_ff_dense
                    else cfg.d_ff)
            self.mlp = MLP(cfg, cfg.d_model, d_ff, device=device, dtype=dtype)


class LM(nn.Module):
    """Embedding, one ``Block`` per layer, final norm."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.embed = Embed(cfg, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            Block(cfg, kind, device=device, dtype=dtype)
            for kind in layer_kinds(cfg))
        self.ln_f = RMSNorm(cfg.d_model, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> "LM":
        """Draw every parameter, module by module, layer by layer."""
        for m in self.modules():
            if hasattr(m, "defs"):
                init_params(m, m.defs, generator)
        return self


def _channel_mix(cfg, blk: Block, h: torch.Tensor, gs_backend: str):
    if blk.kind == "moe":
        return moe_mod.moe_apply(cfg, blk.mlp, h, gs_backend)[0]
    return mlp_apply(cfg, blk.mlp, h)


def block_apply(cfg, blk: Block, x: torch.Tensor, positions: torch.Tensor,
                cache=None, gs_backend: str = "torch"):
    """Returns (x', cache).  Given a ``cache`` entry (from ``init_cache``),
    the block writes into it what decode continues from: a mamba or rec
    block its final state, a GQA block its K/V into the pages, an MLA
    block its latent.  (A ``moe`` block's aux loss is ``moe.moe_apply``'s;
    the port serves, so nothing sums it.)"""
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    if blk.kind in ("mamba", "rec"):
        prefill = (ssm_mod.mamba_prefill if blk.kind == "mamba"
                   else rglru_mod.rglru_prefill)
        y, state = prefill(cfg, blk.mixer, h)
        if cache is not None:
            for k, v in state.items():
                cache[k].copy_(v)
        if blk.kind == "mamba":
            return x + y, cache
    elif cfg.attn_kind == "mla":
        y, cache = attn.mla_apply(cfg, blk.mixer, h, positions, cache=cache)
    else:
        y, cache = attn.gqa_apply(cfg, blk.mixer, h, positions, cache=cache,
                                  window=blk.window)
    x = x + y
    return x + _channel_mix(cfg, blk, rms_norm(blk.ln2, x, cfg.norm_eps),
                            gs_backend), cache


def block_decode(cfg, blk: Block, x: torch.Tensor, pos: int, cache,
                 gs_backend: str = "torch"):
    """Single-token decode through one block. Returns (x', cache')."""
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    if blk.kind == "mamba":  # a mamba block keeps no positions
        y, cache = ssm_mod.mamba_decode(cfg, blk.mixer, h, cache)
        return x + y, cache
    if blk.kind == "rec":
        y, cache = rglru_mod.rglru_decode(cfg, blk.mixer, h, cache)
    elif cfg.attn_kind == "mla":
        y, cache = attn.mla_decode(cfg, blk.mixer, h, pos, cache)
    else:
        y, cache = attn.gqa_decode(cfg, blk.mixer, h, pos, cache,
                                   window=blk.window)
    x = x + y
    return x + _channel_mix(cfg, blk, rms_norm(blk.ln2, x, cfg.norm_eps),
                            gs_backend), cache


def forward(cfg, lm: LM, tokens: torch.Tensor, *, caches: list | None = None,
            gs_backend: str = "torch"):
    """tokens (B,S) -> hidden (B,S,d).  Given ``caches`` (from
    ``init_cache``), also returns the per-layer caches that ``decode_step``
    continues from at position S."""
    x = embed_lookup(cfg, lm.embed, tokens, backend=gs_backend)
    x = x * math.sqrt(cfg.d_model)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    out = []
    for i, blk in enumerate(lm.layers):
        x, c = block_apply(cfg, blk, x, positions,
                           None if caches is None else caches[i], gs_backend)
        out.append(c)
    x = rms_norm(lm.ln_f, x, cfg.norm_eps)
    return x if caches is None else (x, out)


def layer_kinds(cfg) -> list[str]:
    """Each layer's block kind, in layer order."""
    return [kind for count, ks in stage_layout(cfg)
            for _ in range(count) for kind in ks]


def init_cache(cfg, batch: int, max_len: int, dtype, device,
               seed: int = 0) -> list:
    """Zeroed per-layer caches.  GQA layers share one page table, drawn
    from ``seed``, of ceil(max_len / PAGE_SIZE) pages a row; an MLA
    layer's latent cache is contiguous, (B, max_len, ...); a mamba or
    RG-LRU cache does not grow with the context."""
    kinds = layer_kinds(cfg)
    if cfg.attn_kind == "mla":
        return [attn.mla_init_cache(cfg, batch, max_len, dtype, device)
                for _ in kinds]
    states = {"mamba": ssm_mod.mamba_init_cache,
              "rec": rglru_mod.rglru_init_cache}
    table = None
    if any(kind not in states for kind in kinds):
        table = attn.page_table(batch, attn.n_pages(max_len), seed, device)
    return [states[kind](cfg, batch, dtype, device) if kind in states else
            attn.gqa_init_cache(cfg, table, dtype, device) for kind in kinds]


def decode_step(cfg, lm: LM, caches: list, tokens: torch.Tensor, pos, *,
                gs_backend: str = "torch"):
    """One decode step: tokens (B,1) + caches -> (logits (B,V), caches')."""
    x = embed_lookup(cfg, lm.embed, tokens, backend=gs_backend)
    x = x * math.sqrt(cfg.d_model)
    new_caches = []
    for blk, cache in zip(lm.layers, caches):
        x, c = block_decode(cfg, blk, x, pos, cache, gs_backend)
        new_caches.append(c)
    x = rms_norm(lm.ln_f, x, cfg.norm_eps)
    return unembed_logits(cfg, lm.embed, x)[:, 0], new_caches
