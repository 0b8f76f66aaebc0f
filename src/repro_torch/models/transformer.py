"""Decoder-LM assembly: embedding (a Spatter gather), blocks, decode.

The port of ``repro/models/transformer.py`` for the families ported so far
(``ssm``: falcon-mamba-7b).  The JAX package scan-stacks each stage's
layers on a leading axis; here each layer is its own ``Block`` in an
``nn.ModuleList``, in ``stage_layout`` order, and a cache is a list with
one entry per layer.  Other block kinds and families raise, naming the
ROADMAP item that will port them.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import backends as gs_backends
from . import ssm as ssm_mod
from .common import ParamDef, RMSNorm, init_params, make_params, rms_norm

# block kinds and families of the JAX package that the port does not run yet
_NOT_PORTED = "ROADMAP A12 (model-side consumers)"


def embed_defs(cfg) -> dict:
    """Untied table and unembedding, no logit softcap: the ported
    architectures have neither a tied table nor a softcap."""
    return {"table": ParamDef((cfg.vocab, cfg.d_model), scale=1.0),
            "unembed": ParamDef((cfg.d_model, cfg.vocab))}


class Embed(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.defs = embed_defs(cfg)
        make_params(self, self.defs, device, dtype)


def embed_lookup(cfg, p: Embed, tokens: torch.Tensor,
                 backend: str = "torch") -> torch.Tensor:
    """(B,S) int -> (B,S,d): a row gather over the vocab table, through the
    port's gather backends (``torch`` is the framework's own, as ``xla``
    is the JAX package's default)."""
    b, s = tokens.shape
    flat = gs_backends.gather(p.table, tokens.reshape(-1), backend=backend)
    return flat.reshape(b, s, cfg.d_model)


def unembed_logits(cfg, p: Embed, x: torch.Tensor) -> torch.Tensor:
    del cfg
    return x @ p.unembed


def stage_layout(cfg) -> list[tuple[int, tuple[str, ...]]]:
    """[(n_groups, kinds_per_group), ...] — total layers must match."""
    if cfg.family == "ssm":
        return [(cfg.n_layers, ("mamba",))]
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.arch_id}) is not ported: {_NOT_PORTED}")


class Block(nn.Module):
    """ln1 -> mixer -> residual (a mamba block has no channel MLP)."""

    def __init__(self, cfg, kind: str, *, device=None, dtype=None):
        super().__init__()
        if kind != "mamba":
            raise NotImplementedError(
                f"block kind {kind!r} is not ported: {_NOT_PORTED}")
        self.kind = kind
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mixer = ssm_mod.Mamba(cfg, device=device, dtype=dtype)


class LM(nn.Module):
    """Embedding, one ``Block`` per layer, final norm."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.embed = Embed(cfg, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            Block(cfg, kind, device=device, dtype=dtype)
            for count, kinds in stage_layout(cfg)
            for _ in range(count) for kind in kinds)
        self.ln_f = RMSNorm(cfg.d_model, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> "LM":
        """Draw every parameter, module by module, layer by layer."""
        for m in self.modules():
            if hasattr(m, "defs"):
                init_params(m, m.defs, generator)
        return self


def block_apply(cfg, blk: Block, x: torch.Tensor):
    """Returns (x', cache entry)."""
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    y, cache = ssm_mod.mamba_prefill(cfg, blk.mixer, h)
    return x + y, cache


def block_decode(cfg, blk: Block, x: torch.Tensor, pos, cache):
    """Single-token decode through one block. Returns (x', cache')."""
    del pos                  # a mamba block keeps no positions
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    y, cache = ssm_mod.mamba_decode(cfg, blk.mixer, h, cache)
    return x + y, cache


def forward(cfg, lm: LM, tokens: torch.Tensor, *,
            collect_cache: bool = False):
    """tokens (B,S) -> hidden (B,S,d), and with ``collect_cache`` the
    per-layer caches that ``decode_step`` continues from."""
    x = embed_lookup(cfg, lm.embed, tokens)
    x = x * math.sqrt(cfg.d_model)
    caches = []
    for blk in lm.layers:
        x, c = block_apply(cfg, blk, x)
        if collect_cache:
            caches.append(c)
    x = rms_norm(lm.ln_f, x, cfg.norm_eps)
    return (x, caches) if collect_cache else x


def init_cache(cfg, batch: int, max_len: int, dtype, device) -> list:
    del max_len              # a mamba cache does not grow with the context
    return [ssm_mod.mamba_init_cache(cfg, batch, dtype, device)
            for count, kinds in stage_layout(cfg)
            for _ in range(count) for _kind in kinds]


def decode_step(cfg, lm: LM, caches: list, tokens: torch.Tensor, pos):
    """One decode step: tokens (B,1) + caches -> (logits (B,V), caches')."""
    x = embed_lookup(cfg, lm.embed, tokens)
    x = x * math.sqrt(cfg.d_model)
    new_caches = []
    for blk, cache in zip(lm.layers, caches):
        x, c = block_decode(cfg, blk, x, pos, cache)
        new_caches.append(c)
    x = rms_norm(lm.ln_f, x, cfg.norm_eps)
    return unembed_logits(cfg, lm.embed, x)[:, 0], new_caches
