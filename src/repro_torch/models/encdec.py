"""Whisper-style encoder-decoder (the ``audio`` family: whisper-base).

The port of ``repro/models/encdec.py``, with its parameter names and
layouts: ``embed`` (the (vocab, d) table and the (d, vocab) unembedding),
``enc`` (one ``EncBlock`` a layer: ``ln1``, ``attn``, ``ln2``, ``mlp``),
``dec`` (one ``DecBlock`` a layer: ``ln1``, ``self_attn``, ``ln_x``,
``cross_attn``, ``ln2``, ``mlp``), ``ln_enc`` and ``ln_f``.  The JAX
package scan-stacks ``enc`` and ``dec`` on a leading axis; here each layer
is a module of an ``nn.ModuleList`` (``convert.params_from_jax`` unstacks
them).

The frontend is the JAX package's stub: the encoder takes precomputed
frame embeddings (B, F, d), F = prompt_len / ``frame_ratio``.  Both stacks
add sinusoidal positions (``sinusoidal``) and use no RoPE.  The encoder's
self-attention is not causal and runs the flash-attention kernel at S = T
= F; the decoder's teacher-forced pass (``decode_train``) runs it causal
over the tokens, and its cross-attention non-causal over the encoder
states (S tokens against T = F frames).

Training.  ``encdec_loss`` (the port of ``repro/models/encdec.py:101-105``)
is ``encode``, then ``decode_train``, then the chunked cross-entropy of
``transformer.chunked_xent``.  Where grad is on and ``cfg.remat`` is not
``none``, each encoder and decoder block is checkpointed, as the decoder
LM's blocks are (the JAX package keeps this stack's activations; the
gradient is the same).

Serving.  ``prefill_cross`` encodes the frames and fills each decoder
layer's cross K/V once; it yields no logits, so decoding starts from BOS at
position 0, as the JAX serve driver does.  A layer's cache is the GQA
cache of ``attention.py`` (the self-attention K/V paged, one page table
shared by all layers) plus ``cross_k`` and ``cross_v``, contiguous (B, F,
KVH, dh) as in the JAX package.  ``decode_step`` runs the self-attention
through the paged-decode kernel and the cross-attention in plain torch,
float32 scores over the cached cross K/V, as the JAX code computes it
there (no TPU kernel computes it: ``repro/models/encdec.py:156-166``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .common import MLP, RMSNorm, init_params, mlp_apply, rms_norm
from .transformer import Embed, chunked_xent, embed_lookup, unembed_logits


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (...,) -> (..., d) float32: sin of the angles, then cos,
    at frequencies exp(-log(10^4) i / (d/2 - 1)), as the JAX package's."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(1, half - 1))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncBlock(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = attn.GQA(cfg, device=device, dtype=dtype)
        self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff, device=device, dtype=dtype)


class DecBlock(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.self_attn = attn.GQA(cfg, device=device, dtype=dtype)
        self.ln_x = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.cross_attn = attn.GQA(cfg, device=device, dtype=dtype)
        self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff, device=device, dtype=dtype)


class EncDec(nn.Module):
    """Embedding, ``n_enc_layers`` encoder and ``n_layers`` decoder
    blocks, the two final norms."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.embed = Embed(cfg, device=device, dtype=dtype)
        self.enc = nn.ModuleList(EncBlock(cfg, device=device, dtype=dtype)
                                 for _ in range(cfg.n_enc_layers))
        self.dec = nn.ModuleList(DecBlock(cfg, device=device, dtype=dtype)
                                 for _ in range(cfg.n_layers))
        self.ln_enc = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln_f = RMSNorm(cfg.d_model, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> "EncDec":
        """Draw every parameter, module by module, layer by layer."""
        for m in self.modules():
            if hasattr(m, "defs"):
                init_params(m, m.defs, generator)
        return self


def _remat(cfg) -> bool:
    return cfg.remat != "none" and torch.is_grad_enabled()


def _run(cfg, body, *args):
    """``body(*args)``, checkpointed where ``_remat`` says so."""
    if _remat(cfg):
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _enc_block(cfg, blk: EncBlock, x, positions):
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    x = x + attn.gqa_apply(cfg, blk.attn, h, positions, causal=False)[0]
    h = rms_norm(blk.ln2, x, cfg.norm_eps)
    return x + mlp_apply(cfg, blk.mlp, h)


def encode(cfg, p: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d) stub embeddings -> encoder states (B, F, d)."""
    f = frames.shape[1]
    x = frames + sinusoidal(torch.arange(f, device=frames.device),
                            cfg.d_model)[None].to(frames.dtype)
    positions = torch.arange(f, dtype=torch.int32, device=frames.device)
    for blk in p.enc:
        x = _run(cfg, _enc_block, cfg, blk, x, positions)
    return rms_norm(p.ln_enc, x, cfg.norm_eps)


def _embed(cfg, p: EncDec, tokens: torch.Tensor, positions: torch.Tensor,
           gs_backend: str) -> torch.Tensor:
    """Token rows (the embedding gather) plus their sinusoidal positions."""
    x = embed_lookup(cfg, p.embed, tokens, backend=gs_backend)
    return x + sinusoidal(positions, cfg.d_model)[None].to(x.dtype)


def decode_train(cfg, p: EncDec, tokens: torch.Tensor,
                 enc_out: torch.Tensor,
                 gs_backend: str = "torch") -> torch.Tensor:
    """The teacher-forced decoder pass: tokens (B, S) over the encoder
    states (B, F, d) -> hidden (B, S, d)."""
    s = tokens.shape[1]
    dev = tokens.device
    x = _embed(cfg, p, tokens, torch.arange(s, device=dev), gs_backend)
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=dev)
    for blk in p.dec:
        x = _run(cfg, _dec_block, cfg, blk, x, positions, enc_out, enc_pos)
    return rms_norm(p.ln_f, x, cfg.norm_eps)


def _dec_block(cfg, blk: DecBlock, x, positions, enc_out, enc_pos):
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    x = x + attn.gqa_apply(cfg, blk.self_attn, h, positions, causal=True)[0]
    h = rms_norm(blk.ln_x, x, cfg.norm_eps)
    kv = attn.gqa_kv(cfg, blk.cross_attn, enc_out, enc_pos)
    x = x + attn.gqa_apply(cfg, blk.cross_attn, h, positions, causal=False,
                           kv=kv)[0]
    h = rms_norm(blk.ln2, x, cfg.norm_eps)
    return x + mlp_apply(cfg, blk.mlp, h)


def forward(cfg, p: EncDec, tokens: torch.Tensor, frames: torch.Tensor,
            gs_backend: str = "torch") -> torch.Tensor:
    """``decode_train`` over ``encode(frames)``: hidden (B, S, d)."""
    return decode_train(cfg, p, tokens, encode(cfg, p, frames), gs_backend)


def encdec_loss(cfg, p: EncDec, batch: dict,
                gs_backend: str = "torch") -> torch.Tensor:
    """The training loss of ``batch``: ``frames`` (B, F, d), ``tokens``
    and ``labels`` (B, S); the mean token cross-entropy of the decoder
    over the encoded frames."""
    enc_out = encode(cfg, p, batch["frames"])
    hidden = decode_train(cfg, p, batch["tokens"], enc_out, gs_backend)
    return chunked_xent(cfg, p, hidden, batch["labels"])


# -- serving ----------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype, device, n_frames: int,
               seed: int = 0) -> list:
    """Zeroed per-layer caches of the decoder: the self-attention's pages
    (one table for all layers, drawn from ``seed``, room for ``max_len``
    positions) and the cross K/V (B, n_frames, KVH, dh)."""
    table = attn.page_table(batch, attn.n_pages(max_len), seed, device)
    shape = (batch, n_frames, cfg.n_kv_heads, cfg.dh)
    return [dict(attn.gqa_init_cache(cfg, table, dtype, device),
                 cross_k=torch.zeros(shape, dtype=dtype, device=device),
                 cross_v=torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def prefill_cross(cfg, p: EncDec, frames: torch.Tensor,
                  cache: list) -> list:
    """Run the encoder and fill each layer's cross K/V (in place)."""
    enc_out = encode(cfg, p, frames)
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                           device=frames.device)
    for blk, c in zip(p.dec, cache):
        k, v = attn.gqa_kv(cfg, blk.cross_attn, enc_out, enc_pos)
        c["cross_k"].copy_(k)
        c["cross_v"].copy_(v)
    return cache


def cross_decode(cfg, p: attn.GQA, x: torch.Tensor, cross_k: torch.Tensor,
                 cross_v: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention: x (B, 1, d) over the cached (B, F, KVH,
    dh) K/V, every frame, float32 scores; the output cast back to x's
    dtype before ``wo``.  Returns (B, 1, d)."""
    b = x.shape[0]
    kvh, dh = cfg.n_kv_heads, cfg.dh
    q = attn.project(x, p.wq).reshape(b, 1, kvh, cfg.n_heads // kvh, dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", q.to(torch.float32),
                     cross_k.to(torch.float32)) / math.sqrt(dh)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", prob, cross_v.to(torch.float32))
    return attn.out_proj(p, o.reshape(b, 1, cfg.n_heads, dh).to(x.dtype))


def decode_step(cfg, p: EncDec, cache: list, tokens: torch.Tensor, pos: int,
                gs_backend: str = "torch"):
    """One decoder token: tokens (B, 1) at position ``pos`` -> (logits (B,
    V), cache), the self-attention's K/V written at ``pos``."""
    x = _embed(cfg, p, tokens, torch.full((1,), pos, device=tokens.device),
               gs_backend)
    for blk, c in zip(p.dec, cache):
        h = rms_norm(blk.ln1, x, cfg.norm_eps)
        y, c = attn.gqa_decode(cfg, blk.self_attn, h, pos, c)
        x = x + y
        h = rms_norm(blk.ln_x, x, cfg.norm_eps)
        x = x + cross_decode(cfg, blk.cross_attn, h, c["cross_k"],
                             c["cross_v"])
        h = rms_norm(blk.ln2, x, cfg.norm_eps)
        x = x + mlp_apply(cfg, blk.mlp, h)
    x = rms_norm(p.ln_f, x, cfg.norm_eps)
    return unembed_logits(cfg, p.embed, x)[:, 0], cache
