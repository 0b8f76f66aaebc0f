"""Shared model machinery: declared parameters and their init, the RMS norm.

The port of ``repro/models/common.py:24-100``.  A module declares its
parameters as ``ParamDef``s (shape, init, scale) in the JAX package's
names and layouts (weights are (in, out), so a layer is ``x @ w``);
``make_params`` allocates them, uninitialised, on a device (``meta``
allocates nothing), and ``init_params`` draws them from an explicit
``torch.Generator``, leaf by leaf, in the working dtype: ``normal`` draws
N(0, 1) times ``scale`` (``None`` -> 1/sqrt(fan_in)), ``zeros`` and
``ones`` fill.  Parameters hold no gradient: the port serves, it does not
train yet.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # None -> 1/sqrt(fan_in)


def fan_in(shape: tuple[int, ...]) -> int:
    return shape[0] if len(shape) > 1 else max(1, shape[0])


def make_params(module: nn.Module, defs: dict, device, dtype) -> None:
    """Register one uninitialised parameter per ``ParamDef`` of ``defs``."""
    for name, d in defs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(d.shape, device=device, dtype=dtype),
            requires_grad=False))


@torch.no_grad()
def init_params(module: nn.Module, defs: dict,
                generator: torch.Generator) -> None:
    """Draw ``module``'s declared parameters, in declaration order."""
    for name, d in defs.items():
        p = getattr(module, name)
        if d.init == "zeros":
            p.zero_()
        elif d.init == "ones":
            p.fill_(1.0)
        else:
            scale = d.scale if d.scale is not None else 1.0 / math.sqrt(
                fan_in(d.shape))
            p.normal_(generator=generator).mul_(scale)


class RMSNorm(nn.Module):
    """``{"scale": (d,)}``, init ones."""

    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__()
        self.defs = {"scale": ParamDef((d,), init="ones")}
        make_params(self, self.defs, device, dtype)


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Float32 inside, as the JAX package's ``rms_norm``."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)
