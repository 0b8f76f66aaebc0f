"""AdamW from scratch: the port of ``repro/optim/adamw.py:18-66``.

The rule is the JAX package's: float32 moments whatever the parameter's
dtype, bias correction at ``step + 1``, weight decay on every parameter,
the update computed in float32 and cast back to the parameter's dtype.
Plain functions on dicts of tensors (name -> tensor), not
``torch.optim.AdamW``, so the tests can hold parameters and moments to the
JAX ones.  ``adamw_update`` writes the new parameters and moments IN PLACE
(where the JAX package returns new arrays and donates the old): at
llama3-8b's width a second copy of the float32 moments would be another
22 GB.  The JAX module's ``opt_state_axes`` (ZeRO-1 over a mesh) waits for
the multi-card work (ROADMAP, the training queue).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: dict) -> dict:
    """{"m": zeros, "v": zeros (float32, each parameter's shape), "step":
    0-d int32 tensor}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = next(iter(params.values()))
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _lr_at(cfg: AdamWConfig, step: int) -> float:
    return cfg.lr(step) if callable(cfg.lr) else cfg.lr


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 state: dict):
    """One AdamW step of ``params`` by ``grads`` (both name -> tensor) from
    ``state`` (``init_opt_state``'s): updates the parameters, ``m``, ``v``
    and ``step`` in place and returns (params, state)."""
    state["step"] += 1
    step = int(state["step"])
    lr = _lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m, v = state["m"][k], state["v"][k]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        p32 = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, state
