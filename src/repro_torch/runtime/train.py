"""The train step: the port of ``repro/runtime/train.py:71-110``.

``make_train_step`` returns ``train_step(lm, opt_state, batch) -> (lm,
opt_state, metrics)``: the loss and its gradient with respect to every
parameter of ``lm`` (an ``LM`` from ``Model.init(trainable=True)``),
clipped by global norm at ``grad_clip``, then one AdamW step, which
updates ``lm``'s parameters and the moments in place (``optim.adamw``).
With ``microbatches`` > 1 the batch's rows are split into that many
slices, each slice's gradient summed in float32, then scaled by
1 / microbatches and cast to the parameter's dtype, as there.  ``metrics``
holds ``loss``, ``grad_norm`` and ``step`` as 0-d tensors.  The JAX
module's sharding builders (``assemble_train``, ``zero1_shardings``) are
mesh work and wait (ROADMAP, the training queue).
"""
from __future__ import annotations

import torch

from ..models import encdec, transformer
from ..models.zoo import Model
from ..optim import AdamWConfig, adamw_update, clip_by_global_norm


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d each parameter (zeros for one the loss does not use, as
    jax.grad gives)."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), got)}


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, aux_weight: float = 0.01):
    """Returns train_step(lm, opt_state, batch) -> (lm, opt_state,
    metrics); ``batch`` holds ``tokens`` and ``labels`` (B, S), for a
    ``vlm`` model optionally ``img_embeds`` and for the ``audio`` family
    ``frames``, as tensors on lm's device.  The embedding and any MoE
    dispatch run on the ``torch`` backend: the row kernels have no
    backward."""
    cfg = model.cfg

    def loss_fn(lm, batch):
        if cfg.family == "audio":
            return encdec.encdec_loss(cfg, lm, batch)
        return transformer.lm_loss(cfg, lm, batch, aux_weight=aux_weight)

    def train_step(lm, opt_state, batch):
        params = dict(lm.named_parameters())
        if microbatches > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"batch of {rows} rows does not split "
                                 f"into {microbatches} microbatches")
            mb = rows // microbatches
            g32 = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                lossi = loss_fn(lm, part)
                for k, g in _grads(lossi, params).items():
                    g32[k] += g.to(torch.float32)
                loss = loss.to(lossi.device) + lossi.detach()
            loss = loss / microbatches
            grads = {k: (g32[k] / microbatches).to(p.dtype)
                     for k, p in params.items()}
            del g32
        else:
            loss = loss_fn(lm, batch)
            grads = _grads(loss, params)
            loss = loss.detach()
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        adamw_update(opt_cfg, params, grads, opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": opt_state["step"].clone()}
        return lm, opt_state, metrics

    return train_step
