"""Decoder-LM assembly: embedding (a Spatter gather), blocks, decode.

The port of ``repro/models/transformer.py`` for the families ported so far
(``ssm``: falcon-mamba-7b; ``dense``: llama3-8b, and gemma2-27b with its
alternating local and global layers, tied table and softcaps; ``moe``
with MLA: deepseek-v2-236b, with GQA: kimi-k2-1t-a32b (the JAX package's
config: GQA at head size 112, not the published model's MLA); ``hybrid``:
recurrentgemma-9b, RG-LRU blocks
and local attention in its (rec, rec, attn) pattern; ``vlm``:
internvl2-26b, the dense stack after precomputed image embeddings, its
InternViT frontend a stub as in the JAX package).  The JAX package
scan-stacks each stage's layers on a leading axis; here each layer is its
own ``Block`` in an ``nn.ModuleList``, in ``stage_layout`` order, and a
cache is a list with one entry per layer (a GQA layer's is paged, an MLA
layer's contiguous, ``attention.py``; a mamba or RG-LRU layer's a state
that does not grow).  ``gs_backend`` (default
``torch``, the counterpart of the JAX package's ``xla``) selects the
``repro_torch.backends`` implementation of the indexed ops: the embedding
gather and the MoE dispatch's gathers and scatter-adds.  Other block
kinds and families raise, naming the ROADMAP item that will port them.

The loss (``lm_loss``, the port of ``repro/models/transformer.py:291-327``)
is the mean token cross-entropy over chunks of 512 positions, each chunk's
logits recomputed in backward (``torch.utils.checkpoint``), so no (B, S,
V) logits tensor is kept; a MoE model adds 0.01 x its load-balance aux
loss; a ``vlm`` model scores its text positions only.  Where grad is on
and ``cfg.remat`` is ``block`` (or ``full``), each block is checkpointed:
its input is kept and its insides are recomputed in backward, as the JAX
package's scan body saves only the block outputs.  The hand-written
kernels that have no backward (the scans, the row gathers and adds of
``gs_backend="hopper"``) raise where a gradient would have to pass them.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    if cfg.family in ("dense", "vlm") and cfg.attn_kind == "full":
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
    """(y, aux): a ``moe`` block's load-balance aux loss, 0 elsewhere."""
    if blk.kind == "moe":
        return moe_mod.moe_apply(cfg, blk.mlp, h, gs_backend)
    return mlp_apply(cfg, blk.mlp, h), 0.0


def block_apply(cfg, blk: Block, x: torch.Tensor, positions: torch.Tensor,
                cache=None, gs_backend: str = "torch"):
    """Returns (x', cache, aux).  Given a ``cache`` entry (from
    ``init_cache``), the block writes into it what decode continues from: a
    mamba or rec block its final state, a GQA block its K/V into the
    pages, an MLA block its latent.  ``aux`` is a ``moe`` block's
    load-balance aux loss (``moe.moe_apply``'s), 0 for the others."""
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    if blk.kind in ("mamba", "rec"):
        prefill = (ssm_mod.mamba_prefill if blk.kind == "mamba"
                   else rglru_mod.rglru_prefill)
        y, state = prefill(cfg, blk.mixer, h)
        if cache is not None:
            for k, v in state.items():
                cache[k].copy_(v)
        if blk.kind == "mamba":
            return x + y, cache, 0.0
    elif cfg.attn_kind == "mla":
        y, cache = attn.mla_apply(cfg, blk.mixer, h, positions, cache=cache)
    else:
        y, cache = attn.gqa_apply(cfg, blk.mixer, h, positions, cache=cache,
                                  window=blk.window)
    x = x + y
    y, aux = _channel_mix(cfg, blk, rms_norm(blk.ln2, x, cfg.norm_eps),
                          gs_backend)
    return x + y, cache, aux


def _block_remat(cfg, blk: Block, x, positions, gs_backend):
    """One block with no cache, for ``checkpoint``: (x', aux) as tensors."""
    x, _, aux = block_apply(cfg, blk, x, positions, None, gs_backend)
    return x, torch.as_tensor(aux, dtype=torch.float32, device=x.device)


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
                            gs_backend)[0], cache


def trunk(cfg, lm: LM, tokens: torch.Tensor, *, caches: list | None = None,
          gs_backend: str = "torch", img_embeds: torch.Tensor | None = None):
    """(hidden (B,S,d), aux loss, per-layer caches or None): the embedding
    (after ``img_embeds`` (B, n_img, d) for a ``vlm`` model, so S counts
    the image positions, and before the sqrt(d_model) scale, as
    ``repro/models/transformer.py:266-269``), every block, the final
    norm.  With grad on, no caches and ``cfg.remat`` not ``none``, each
    block is checkpointed."""
    x = embed_lookup(cfg, lm.embed, tokens, backend=gs_backend)
    if cfg.family == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    x = x * math.sqrt(cfg.d_model)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    remat = (caches is None and cfg.remat != "none"
             and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = []
    for i, blk in enumerate(lm.layers):
        if remat:
            x, a = checkpoint(_block_remat, cfg, blk, x, positions,
                              gs_backend, use_reentrant=False)
            c = None
        else:
            x, c, a = block_apply(cfg, blk, x, positions,
                                  None if caches is None else caches[i],
                                  gs_backend)
        aux = aux + a
        out.append(c)
    x = rms_norm(lm.ln_f, x, cfg.norm_eps)
    return x, aux, (None if caches is None else out)


def forward(cfg, lm: LM, tokens: torch.Tensor, *, caches: list | None = None,
            gs_backend: str = "torch", img_embeds: torch.Tensor | None = None):
    """tokens (B,S) -> hidden (B,S,d), after ``img_embeds`` (B, n_img, d)
    for a ``vlm`` model (then (B, n_img + S, d)).  Given ``caches`` (from
    ``init_cache``), also returns the per-layer caches that ``decode_step``
    continues from at position n_img + S."""
    x, _, out = trunk(cfg, lm, tokens, caches=caches, gs_backend=gs_backend,
                      img_embeds=img_embeds)
    return x if caches is None else (x, out)


def chunked_xent(cfg, lm: LM, hidden: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy of ``labels`` (B,S) under the logits of
    ``hidden`` (B,S,d), a chunk of ``chunk`` positions at a time (all S in
    one where S is no multiple of it, as there): each chunk's float32
    logits are recomputed in backward, never kept."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s

    def one(h, lab):
        logits = unembed_logits(cfg, lm.embed, h).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lab[..., None].to(torch.int64))[..., 0]
        return (lse - gold).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        total = total + (checkpoint(one, h, lab, use_reentrant=False)
                         if torch.is_grad_enabled() else one(h, lab))
    return total / (b * s)


def lm_loss(cfg, lm: LM, batch: dict, *, aux_weight: float = 0.01,
            gs_backend: str = "torch") -> torch.Tensor:
    """The training loss of ``batch`` (``tokens``, ``labels`` (B,S) and,
    for a ``vlm`` model, optionally ``img_embeds``): ``chunked_xent`` over
    the text positions plus ``aux_weight`` x the MoE aux loss."""
    img = batch.get("img_embeds")
    hidden, aux, _ = trunk(cfg, lm, batch["tokens"], gs_backend=gs_backend,
                           img_embeds=img)
    if cfg.family == "vlm" and img is not None:
        hidden = hidden[:, img.shape[1]:]      # text positions only
    return chunked_xent(cfg, lm, hidden, batch["labels"]) + aux_weight * aux


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
