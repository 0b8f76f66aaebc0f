"""Model zoo: one interface over the ported architectures.

    model = Model(get_config("llama3-8b"))      # or deepseek-v2-236b, ...
    params = model.init(torch.Generator("cuda").manual_seed(0))   # an LM
    logits, cache = model.prefill(params, tokens, max_len)   # ready to decode
    logits, cache = model.decode_step(params, cache, tokens, pos)
    lm = model.init(gen, trainable=True)                     # to train
    loss = model.loss(lm, {"tokens": ..., "labels": ...})

The ``vlm`` family (internvl2-26b): ``prefill(params, tokens, max_len,
img_embeds=...)`` puts the (B, n_img, d) image embeddings before the
prompt, so the cache holds n_img + S positions and decoding continues at
n_img + S; ``max_len`` counts the image positions (default n_img + S).

The ``audio`` family (whisper-base, ``encdec``): ``init`` returns an
``EncDec``; ``prefill(params, frames, max_len)`` encodes the (B, F, d)
frames and fills the cross K/V, returning no logits (``None``, the cache),
and decoding starts from BOS at position 0; ``forward(params, tokens,
frames=...)`` is the teacher-forced pass.

The port of ``repro/models/zoo.py``.  ``device=None`` means ``cuda`` and
raises without CUDA; only an explicit ``device="cpu"`` runs on the CPU.
Parameters hold no gradient unless ``init(trainable=True)``; serving
(``prefill``, ``decode_step``) runs under ``torch.no_grad`` whatever they
hold, so it builds no autograd graph.
"""
from __future__ import annotations

import torch

from ..engine import resolve_device
from . import encdec, transformer


def model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Model:
    def __init__(self, cfg):
        self.cfg = cfg

    @property
    def audio(self) -> bool:
        return self.cfg.family == "audio"

    def init(self, generator: torch.Generator | None = None, device=None,
             dtype=None, trainable: bool = False
             ) -> transformer.LM | encdec.EncDec:
        """The parameters, drawn on ``device`` from ``generator`` (default:
        a generator on that device seeded 0) in ``dtype`` (default the
        config's); with ``trainable`` they require grad."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        net = encdec.EncDec if self.audio else transformer.LM
        net = net(self.cfg, device=dev,
                  dtype=dtype or model_dtype(self.cfg)).init_(generator)
        return net.requires_grad_(trainable)

    def forward(self, params, tokens, **kw):
        if self.audio:
            return encdec.forward(self.cfg, params, tokens, **kw)
        return transformer.forward(self.cfg, params, tokens, **kw)

    def loss(self, params, batch: dict) -> torch.Tensor:
        """The training loss of ``batch``: ``tokens`` and ``labels`` (B, S)
        and, for a ``vlm`` model, optionally ``img_embeds``
        (``transformer.lm_loss``); for the ``audio`` family also the (B, F,
        d) ``frames`` (``encdec.encdec_loss``)."""
        if self.audio:
            return encdec.encdec_loss(self.cfg, params, batch)
        return transformer.lm_loss(self.cfg, params, batch)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, max_len: int | None = None,
                seed: int = 0, gs_backend: str = "torch",
                img_embeds: torch.Tensor | None = None):
        """tokens (B,S) -> (last-position logits (B,V), per-layer caches
        that ``decode_step`` continues from at position S, with room for
        ``max_len`` positions (default S; a paged cache's table is drawn
        from ``seed``; an MLA cache is contiguous).  A mamba or RG-LRU
        cache does not grow: ``max_len`` is ignored there.  ``gs_backend``: the backend
        of the embedding gather and the MoE dispatch.  For the ``audio``
        family ``tokens`` are the (B, F, d) frames and ``max_len`` the
        decoder's positions: returns (None, the filled cache).  For the
        ``vlm`` family ``img_embeds`` (B, n_img, d) go before the prompt:
        the cache continues at n_img + S and ``max_len`` (default n_img +
        S) counts them."""
        if self.audio:
            if max_len is None:
                raise ValueError("an audio prefill needs max_len, the "
                                 "decoder's positions")
            cache = encdec.init_cache(self.cfg, tokens.shape[0], max_len,
                                      params.embed.table.dtype,
                                      tokens.device, tokens.shape[1], seed)
            return None, encdec.prefill_cross(self.cfg, params, tokens,
                                              cache)
        b, s = tokens.shape
        if img_embeds is not None and self.cfg.family == "vlm":
            s += img_embeds.shape[1]
        caches = transformer.init_cache(self.cfg, b, max_len or s,
                                        params.embed.table.dtype,
                                        tokens.device, seed)
        hidden, caches = transformer.forward(self.cfg, params, tokens,
                                             caches=caches,
                                             gs_backend=gs_backend,
                                             img_embeds=img_embeds)
        last = transformer.unembed_logits(self.cfg, params.embed,
                                          hidden[:, -1:])[:, 0]
        return last, caches

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   seed: int = 0, n_frames: int = 0):
        if self.audio:
            return encdec.init_cache(self.cfg, batch, max_len,
                                     dtype or model_dtype(self.cfg),
                                     resolve_device(device), n_frames, seed)
        return transformer.init_cache(self.cfg, batch, max_len,
                                      dtype or model_dtype(self.cfg),
                                      resolve_device(device), seed)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos,
                    gs_backend: str = "torch"):
        if self.audio:
            return encdec.decode_step(self.cfg, params, cache, tokens, pos,
                                      gs_backend=gs_backend)
        return transformer.decode_step(self.cfg, params, cache, tokens, pos,
                                       gs_backend=gs_backend)


# -- analytic counts (the port of ``repro/models/zoo.py:157-188``) ------------

def _count(cfg) -> tuple[int, int, int]:
    """(total, routed expert, embedding table) parameters, counted on the
    ``meta`` device (nothing is allocated): a routed expert's path holds
    ``experts``, the table's ends in ``table``, as the JAX defs' do."""
    net = encdec.EncDec if cfg.family == "audio" else transformer.LM
    total = routed = table = 0
    for name, p in net(cfg, device="meta").named_parameters():
        parts = name.split(".")
        total += p.numel()
        routed += p.numel() if "experts" in parts else 0
        table += p.numel() if parts[-1] == "table" else 0
    return total, routed, table


def count_params(cfg, active_only: bool = False) -> int:
    """Total parameters or, with ``active_only`` for a MoE model, those a
    token runs."""
    total, routed, _ = _count(cfg)
    if active_only and cfg.n_experts:
        return int(total - routed + routed * cfg.top_k / cfg.n_experts)
    return total


def matmul_params(cfg, active_only: bool = False) -> int:
    """Parameters in matmuls: all but the embedding's lookup table (which
    moves bytes), unless it is tied and so also the unembedding."""
    total, routed, table = _count(cfg)
    n = total if cfg.tie_embeddings else total - table
    if active_only and cfg.n_experts:     # the top_k experts a token runs
        n = n - routed + int(routed * cfg.top_k / cfg.n_experts)
    return n


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS of one step of ``shape`` (a ``ShapeConfig``): 6 N D to
    train, 2 N D forward only (D tokens: batch x seq, or batch for a decode
    step), N the active matmul parameters."""
    n = matmul_params(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
