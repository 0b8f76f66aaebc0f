"""Carry weights and caches between the JAX package and the port.

The JAX package scan-stacks each stage's layers on a leading axis
(``params["stages"][s]["b<i>_<kind>"]``, one slice per group); the port
keeps one ``Block`` per layer, in ``stage_layout`` order (recurrentgemma's
``b0_rec``, ``b1_rec``, ``b2_attn_local`` x 12 are layers 0-35, its last
stage's ``b0_rec``, ``b1_rec`` layers 36 and 37).  ``params_from_jax``
unstacks a JAX
``Model.init`` tree, given as numpy arrays, into a state dict for
``LM.load_state_dict`` (which casts to the module's dtype): a MoE layer's
stacked (L, E, d, ff) experts become one (E, d, ff) tensor a layer, MLA's
norms ``mixer.q_norm.scale`` and ``mixer.kv_norm.scale``.
``cache_from_jax`` and ``cache_to_jax`` do the same for decode caches: an
MLA layer's latent cache (``c_kv``, ``k_pe``), a mamba layer's state and
an RG-LRU layer's (``conv``, ``h``) are contiguous on both sides and
carried a layer at a time; between the
JAX package's contiguous K/V cache (count, B, max_len, KVH, dh) and the
port's paged one they gather the pages through the table, and scatter
them back.
The ``audio`` family (whisper-base) stacks its ``enc`` and ``dec`` blocks
on one leading axis each: layer i of a stack is ``enc.<i>`` or ``dec.<i>``
of ``encdec.EncDec``; its decode cache is one dict, ``self_k``/``self_v``
(L, B, max_len, KVH, dh) and ``cross_k``/``cross_v`` (L, B, F, KVH, dh),
which the port keeps a layer at a time (the self K/V paged).
JAX's bfloat16 arrays arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, so every leaf goes through float32, which
holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from . import attention as attn
from .transformer import stage_layout


def _f32(x) -> torch.Tensor:
    a = np.asarray(x, dtype=np.float32)
    # JAX hands out read-only arrays; torch wants to own writable memory
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _layers(cfg, stacked: list):
    """Yield (layer index, group index, stage entry) in layer order."""
    i = 0
    for stage, (count, kinds) in zip(stacked, stage_layout(cfg)):
        for g in range(count):
            for k, kind in enumerate(kinds):
                yield i, g, stage[f"b{k}_{kind}"]
                i += 1


def params_from_jax(cfg, tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``Model.init`` tree (numpy leaves) -> the port's state dict."""
    state = {f"embed.{k}": _f32(v) for k, v in _leaves(tree["embed"])}
    state.update({f"ln_f.{k}": _f32(v) for k, v in _leaves(tree["ln_f"])})
    if cfg.family == "audio":
        state.update({f"ln_enc.{k}": _f32(v)
                      for k, v in _leaves(tree["ln_enc"])})
        for stack in ("enc", "dec"):
            for k, v in _leaves(tree[stack]):
                state.update({f"{stack}.{i}.{k}": _f32(v[i])
                              for i in range(v.shape[0])})
        return state
    for i, g, block in _layers(cfg, tree["stages"]):
        for k, v in _leaves(block):
            state[f"layers.{i}.{k}"] = _f32(v[g])
    return state


def cache_from_jax(cfg, caches: list, seed: int = 0) -> list[dict]:
    """JAX decode cache (numpy leaves) -> the port's per-layer list, as
    float32 CPU tensors (``ssm`` and ``h`` are float32 on both sides; an
    MLA latent and a ``conv`` state are carried as they are).  Contiguous
    K/V go into pages through one table drawn from ``seed``."""
    if cfg.family == "audio":
        return _audio_cache_from_jax(cfg, caches, seed)
    out, table = [], None
    for _, g, block in _layers(cfg, caches):
        if "k" not in block:
            out.append({k: _f32(v[g]) for k, v in block.items()})
            continue
        k, v = _f32(block["k"][g]), _f32(block["v"][g])
        if table is None:
            b, length = k.shape[:2]
            table = attn.page_table(b, attn.n_pages(length), seed, "cpu")
        cache = attn.gqa_init_cache(cfg, table, torch.float32, "cpu")
        attn.write_prefill(cache, k, v)
        out.append(cache)
    return out


def _audio_cache_from_jax(cfg, cache: dict, seed: int) -> list[dict]:
    k = _f32(cache["self_k"])
    table = attn.page_table(k.shape[1], attn.n_pages(k.shape[2]), seed, "cpu")
    out = []
    for i in range(k.shape[0]):
        c = attn.gqa_init_cache(cfg, table, torch.float32, "cpu")
        attn.write_prefill(c, k[i], _f32(cache["self_v"][i]))
        out.append(dict(c, cross_k=_f32(cache["cross_k"][i]),
                        cross_v=_f32(cache["cross_v"][i])))
    return out


def _to_jax(cache: dict, max_len: int | None) -> dict:
    if "page_table" not in cache:
        return cache
    table = cache["page_table"]
    k, v = attn.contiguous_kv(cache, max_len or table.shape[1]
                              * attn.PAGE_SIZE)
    return {"k": k, "v": v}


def cache_to_jax(cfg, caches: list[dict], max_len: int | None = None) -> list:
    """The port's per-layer cache -> the JAX layout, as float32 numpy.
    Paged K/V are gathered through the table into (B, max_len, KVH, dh)
    (default: every slot of the table)."""
    if cfg.family == "audio":
        out = {}
        for c in caches:
            k, v = attn.contiguous_kv(c, max_len or c["page_table"].shape[1]
                                      * attn.PAGE_SIZE)
            for name, x in (("self_k", k), ("self_v", v),
                            ("cross_k", c["cross_k"]),
                            ("cross_v", c["cross_v"])):
                out.setdefault(name, []).append(
                    x.detach().to("cpu", torch.float32).numpy())
        return {name: np.stack(xs) for name, xs in out.items()}
    caches = [_to_jax(c, max_len) for c in caches]
    out, i = [], 0
    for count, kinds in stage_layout(cfg):
        stage = {}
        for k, kind in enumerate(kinds):
            layers = caches[i + k::len(kinds)][:count]
            stage[f"b{k}_{kind}"] = {
                name: np.stack([c[name].detach().to("cpu", torch.float32)
                                .numpy() for c in layers])
                for name in layers[0]}
        out.append(stage)
        i += count * len(kinds)
    return out
