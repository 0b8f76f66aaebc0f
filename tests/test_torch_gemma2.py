"""repro_torch's gemma2-27b serving path against the JAX package, on the
CPU.

gemma2 adds to the dense path: GeGLU (the tanh GELU that ``jax.nn.gelu``
defaults to), a tied embedding table with a logit softcap, an attention
softcap, and alternating local (window) and global layers, in prefill
(flash attention's options) and in decode (paged decode's ``softcap`` and
``window``, new here).  The same numpy weights (a JAX ``Model.init``
tree carried across by ``convert``) and tokens go through both.  The
smoke config (2 layers: one local with window 32, one global; d_model 64,
4 heads, 2 KV heads, dh 16) runs in float32 at 1e-5, where the two sides
differ in summation order only.

The oracle for prefill + decode is the JAX ``decode_step`` iterated over
the whole sequence from ``init_cache``: the JAX ``Model.prefill`` cache
keeps a local layer's trailing window at slots 0..w-1 while its decode
writes slot ``pos % w``, which agree only when the prompt is a multiple
of the window.  The prompt here (45 tokens) is longer than the window and
not a multiple of it.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.kernels.paged_decode import paged_decode_attention as j_paged
from repro.kernels.paged_decode.ref import (
    paged_decode_attention_ref as j_paged_ref)
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro.models.common import abstract_tree
from repro.models.zoo import Model as JModel
from repro.models.zoo import count_params as j_count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import launches
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.kernels.paged_decode.ops import paged_decode_attention
from repro_torch.kernels.paged_decode.ref import (paged_decode_attention_ref,
                                                  paged_decode_split_ref,
                                                  window_pages, window_start)
from repro_torch.launch import serve
from repro_torch.models import attention, common, convert, transformer
from repro_torch.models.zoo import Model, count_params

ROOT = Path(__file__).resolve().parent.parent
ARCH = "gemma2-27b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 keeps 8 significant bits (u = 2^-8): the two frameworks round
# the residual stream, RoPE and GeGLU at different places, so values of
# magnitude up to ~4 may differ by a few roundings; held at 8 u
BF16_TOL = dict(rtol=2 ** -5, atol=2 ** -5)
# gemma2's bfloat16 logits reach its logit softcap of 30, where one
# bfloat16 step is 0.125; a logit near 0 is the sum of terms that large,
# and carries their roundings: held at 2 steps of the top binade
BF16_LOGIT_TOL = dict(rtol=2 ** -5, atol=2 ** -2)
FULL_PARAMS = 27_226_704_384
WINDOW = 32                   # the smoke config's


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def _j_cfg(dtype="float32"):
    return dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_config_and_layout():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
            cfg.d_ff, cfg.vocab, cfg.window) == (46, 4608, 32, 16, 128,
                                                 36864, 256000, 4096)
    assert (cfg.attn_softcap, cfg.logit_softcap, cfg.mlp_kind,
            cfg.tie_embeddings) == (50.0, 30.0, "geglu", True)
    smoke = _cfg()
    assert transformer.stage_layout(smoke) == [(1, ("local", "global"))]
    lm = transformer.LM(smoke, device="meta")
    assert [b.kind for b in lm.layers] == ["local", "global"]
    assert [b.window for b in lm.layers] == [WINDOW, 0]
    assert not hasattr(lm.embed, "unembed")
    with pytest.raises(ValueError, match="even"):
        transformer.stage_layout(dataclasses.replace(smoke, n_layers=3))


# -- GeGLU and the tied, softcapped unembedding ------------------------------------

def test_geglu_equals_jax_mlp_apply():
    cfg, jcfg = _cfg(), _j_cfg()
    rng = np.random.default_rng(0)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
         .astype(np.float32)
         for k, s in abstract_tree(j_common.mlp_def(jcfg, 64, 256),
                                   jnp.float32).items()}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    want = j_common.mlp_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    m = common.MLP(cfg, 64, 256, device="cpu", dtype=torch.float32)
    m.load_state_dict({k: _t(v) for k, v in p.items()})
    got = common.mlp_apply(cfg, m, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # the exact erf GELU is another function: it misses the tolerance
    erf = (torch.nn.functional.gelu(_t(x) @ m.wg) * (_t(x) @ m.wi)) @ m.wo
    assert not np.allclose(erf.numpy(), np.asarray(want), **F32_TOL)


def test_tied_softcapped_unembedding_equals_jax():
    cfg, jcfg = _cfg(), _j_cfg()
    rng = np.random.default_rng(1)
    table = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32)
    x = (3 * rng.standard_normal((2, 5, cfg.d_model))).astype(np.float32)
    want = j_tf.unembed_logits(jcfg, {"table": jnp.asarray(table)},
                               jnp.asarray(x))
    emb = transformer.Embed(cfg, device="cpu", dtype=torch.float32)
    emb.load_state_dict({"table": _t(table)})
    got = transformer.unembed_logits(cfg, emb, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # the softcap bites: raw logits pass 30, capped ones stay below it
    assert (np.abs(x @ table.T) > cfg.logit_softcap).any()
    assert got.abs().max() < cfg.logit_softcap


# -- local and global GQA with the softcap -------------------------------------

def _gqa_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
            .astype(np.float32)
            for k, s in abstract_tree(j_attn.gqa_defs(jcfg),
                                      jnp.float32).items()}


def _port_gqa(cfg, npp):
    m = attention.GQA(cfg, device="cpu", dtype=torch.float32)
    m.load_state_dict({k: _t(v) for k, v in npp.items()})
    return m


@pytest.mark.parametrize("window", [WINDOW, 0])
def test_gqa_prefill_equals_jax(window):
    # S = 80 > window 32: the window cuts keys of most queries
    cfg, jcfg = _cfg(), _j_cfg()
    npp = _gqa_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 80, cfg.d_model)).astype(np.float32)
    pos = np.arange(80, dtype=np.int32)
    want, (jk, jv) = j_attn.gqa_apply(
        jcfg, {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(x),
        jnp.asarray(pos), window=window, return_kv=True)
    table = attention.page_table(2, 5, seed=7, device="cpu")
    cache = attention.gqa_init_cache(cfg, table, torch.float32, "cpu")
    y, cache = attention.gqa_apply(cfg, _port_gqa(cfg, npp), _t(x), _t(pos),
                                   cache=cache, window=window)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **F32_TOL)
    k, v = attention.contiguous_kv(cache, 80)    # every position kept
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **F32_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32_TOL)


@pytest.mark.parametrize("window", [WINDOW, 0])
@pytest.mark.parametrize("pos", [20, 31, 32, 45, 64, 70])
def test_gqa_decode_equals_jax_ring(pos, window):
    """The port's paged decode (the plain version on the CPU) with the
    softcap and window against JAX ``gqa_decode`` on its ring of
    ``window`` slots: before the ring is full (pos < 31), at the wrap,
    past it and at multiples of the window."""
    cfg, jcfg = _cfg(), _j_cfg()
    npp = _gqa_params(jcfg, seed=2)
    rng = np.random.default_rng(3 + pos)
    b, max_len = 3, 80
    shape = (b, max_len, cfg.n_kv_heads, cfg.dh)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    if window:                   # positions t < pos in ring slots t % w
        ring = np.zeros((2, b, window) + shape[2:], np.float32)
        for t in range(max(0, pos - window), pos):
            ring[:, :, t % window] = ck[:, t], cv[:, t]
        jc = {"k": jnp.asarray(ring[0]), "v": jnp.asarray(ring[1])}
    else:
        jc = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    jy, _ = j_attn.gqa_decode(
        jcfg, {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(x),
        jnp.int32(pos), jc, window=window)
    table = attention.page_table(b, 5, seed=1, device="cpu")
    cache = attention.gqa_init_cache(cfg, table, torch.float32, "cpu")
    attention.write_prefill(cache, _t(ck), _t(cv))
    y, _ = attention.gqa_decode(cfg, _port_gqa(cfg, npp), _t(x), pos, cache,
                                window=window)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)


# -- paged decode's options ----------------------------------------------------------

def _paged_inputs(b, kvh, g, dh, pages, page, pps, lengths, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (3 * rng.standard_normal((b, kvh, g, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.integers(0, pages, (b, pps)).astype(np.int32),   # repeats
            np.asarray(lengths, np.int32))


def _numpy_attention(q, k, v, valid, scale, cap):
    """One row of attention in float64: q (G, dh), k and v (T, dh)."""
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * scale
    if cap:
        s = np.tanh(s / cap) * cap
    s = np.where(valid[None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v.astype(np.float64)


@pytest.mark.parametrize("softcap,window", [(50.0, 0), (0.0, 20), (50.0, 20),
                                            (5.0, 7)])
def test_paged_plain_options_equal_numpy(softcap, window):
    b, kvh, g, dh, pages, page, pps = 4, 2, 2, 16, 24, 8, 6
    ins = _paged_inputs(b, kvh, g, dh, pages, page, pps, [0, 5, 29, 48])
    got = paged_decode_attention(*map(_t, ins), softcap=softcap,
                                 window=window).numpy()
    q, kp, vp, pt, ln = ins
    for r in range(b):
        pos = np.arange(pps * page)
        valid = pos < ln[r]
        if window:
            valid &= pos >= ln[r] - window
        for h in range(kvh):
            k = kp[h, pt[r]].reshape(-1, dh)
            v = vp[h, pt[r]].reshape(-1, dh)
            want = _numpy_attention(q[r, h], k, v, valid, dh ** -0.5,
                                    softcap)
            np.testing.assert_allclose(got[r, h], want, **F32_TOL)


def test_paged_plain_without_options_equals_jax_kernel():
    ins = _paged_inputs(2, 2, 4, 16, 12, 8, 3, [5, 24], seed=2)
    j_ins = list(map(jnp.asarray, ins))
    for want in (j_paged(*j_ins, interpret=True),
                 j_paged_ref(*j_ins, scale=0.25)):
        got = paged_decode_attention(*map(_t, ins), softcap=0.0, window=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("window,page,pps,want", [
    (0, 16, 514, 514), (4096, 16, 514, 257), (4096, 16, 200, 200),
    (1, 8, 9, 1), (2, 8, 9, 2), (8, 8, 9, 2), (9, 8, 9, 2), (10, 8, 9, 3),
    (32, 16, 4, 3)])
def test_window_pages(window, page, pps, want):
    assert window_pages(window, page, pps) == want
    if window:      # no run of `window` positions straddles more pages
        for start in range(0, 3 * page):
            pages = (start + window - 1) // page - start // page + 1
            assert pages <= want or want == pps


def test_window_start_keeps_the_span_in_the_table():
    page, pps, w = 8, 9, 20
    n = window_pages(w, page, pps)
    assert window_start(0, w, page, pps) == (0, 0)
    assert window_start(37, 0, page, pps) == (0, 0)
    for length in range(1, pps * page + 1):
        e0, w_lo = window_start(length, w, page, pps)
        assert w_lo == max(0, length - w)
        assert 0 <= e0 <= w_lo // page and e0 + n <= pps
        assert (length - 1) // page < e0 + n       # the last key is inside


# (B, KVH, G, dh, pages, page, pps, lengths, softcap, window): the window
# inside one page, straddling pages, past the table's end once moved back,
# longer than the row; a row of length 0 beside them
SPLIT_OPTION_CASES = [
    (3, 2, 2, 16, 30, 8, 10, [0, 37, 80], 50.0, 20),
    (4, 1, 4, 16, 40, 4, 14, [1, 17, 29, 56], 0.0, 9),
    (2, 2, 1, 32, 20, 16, 9, [144, 100], 30.0, 3),
    (2, 2, 2, 16, 12, 8, 6, [48, 13], 50.0, 0),
    (2, 1, 2, 16, 12, 8, 6, [48, 13], 0.0, 100),
]


@pytest.mark.parametrize("case", range(len(SPLIT_OPTION_CASES)))
def test_split_ref_with_options_equals_plain(case):
    """The kernel's arithmetic (``paged_decode_split_ref``: its per-row
    split ranges over the window's pages, tanh then log2(e)) equals the
    plain version with the same options at every split count the window
    admits."""
    b, kvh, g, dh, pages, page, pps, lengths, cap, w = SPLIT_OPTION_CASES[
        case]
    t = list(map(_t, _paged_inputs(b, kvh, g, dh, pages, page, pps, lengths,
                                   seed=case)))
    want = paged_decode_attention_ref(*t, scale=dh ** -0.5, softcap=cap,
                                      window=w)
    for splits in sorted({1, 2, window_pages(w, page, pps)}):
        got = paged_decode_split_ref(*t, scale=dh ** -0.5, splits=splits,
                                     softcap=cap, window=w)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_paged_wrapper_checks_the_options():
    ins = list(map(_t, _paged_inputs(2, 2, 4, 64, 8, 8, 3, [5, 24])))
    with pytest.raises(ValueError, match="window"):
        paged_decode_attention(*ins, window=-1)
    with pytest.raises(ValueError, match="softcap"):
        paged_decode_attention(*ins, softcap=-1.0)
    # the autotune key counts the pages a row's window touches
    key = paged_ops.tile_key(2, 16, 2, 128, 16, window_pages(4096, 16, 514),
                             torch.bfloat16, "cpu")
    assert key.lanes == 257


# -- the model -----------------------------------------------------------------------

def _model_params(jcfg, dtype, seed=0):
    """A JAX ``Model.init`` tree with numpy leaves of the JAX dtype.

    JAX's ``init_tree`` takes a stacked leaf's fan-in from its layer axis;
    the stacked matrices are redrawn at 1/sqrt(fan_in of one layer), as the
    port draws them.  Norm scales are moved by noise so that they matter.
    """
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        stacked = path[0].key == "stages"
        if stacked and v.ndim >= 3:
            v = rng.standard_normal(v.shape) / np.sqrt(v.shape[1])
        elif v.ndim == 1 or (stacked and v.ndim == 2):
            v = v + 0.1 * rng.standard_normal(v.shape)
        return np.asarray(jnp.asarray(v.astype(np.float32), dtype))
    return jax.tree_util.tree_map_with_path(
        leaf, JModel(jcfg).init(jax.random.PRNGKey(seed)))


def _port_lm(cfg, np_tree, dtype):
    lm = transformer.LM(cfg, device="cpu", dtype=dtype)
    lm.load_state_dict(convert.params_from_jax(cfg, np_tree))
    return lm


def _tokens(cfg, b, s, seed=4):
    return np.random.default_rng(seed).integers(2, cfg.vocab, (b, s))


@pytest.mark.parametrize("s", [45, 80])
def test_forward_logits_equal_jax(s):
    cfg, jcfg = _cfg(), _j_cfg()
    tree = _model_params(jcfg, jnp.float32)
    lm = _port_lm(cfg, tree, torch.float32)
    toks = _tokens(cfg, 2, s)
    jtree = jax.tree.map(jnp.asarray, tree)
    jh, _ = j_tf.forward(jcfg, jtree, jnp.asarray(toks, jnp.int32))
    want = j_tf.unembed_logits(jcfg, jtree["embed"], jh)
    before = dict(launches)
    hidden = transformer.forward(cfg, lm, _t(toks))
    assert launches == before                 # CPU: plain versions only
    got = transformer.unembed_logits(cfg, lm.embed, hidden)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _prefill_decode_vs_jax(dtype, jdtype, tol, gs_backend="torch",
                           logit_tol=None):
    """Port prefill of 45 tokens (past the window of 32, no multiple of it)
    + 8 decode steps against JAX ``decode_step`` iterated from
    ``init_cache`` over all 53 tokens: the logits at positions 44..52."""
    cfg, jcfg = _cfg(dtype), _j_cfg(dtype)
    tree = _model_params(jcfg, jdtype)
    jtree = jax.tree.map(jnp.asarray, tree)
    tdtype = getattr(torch, dtype)
    lm = _port_lm(cfg, tree, tdtype)
    jm, model = JModel(jcfg), Model(cfg)
    plen, gen, b = 45, 8, 2
    toks = _tokens(cfg, b, plen + gen)
    jcache = jm.init_cache(b, plen + gen)
    assert jcache[0]["b0_local"]["k"].shape[2] == WINDOW      # the ring
    step = jax.jit(jm.decode_step)
    jlogits = []
    for t in range(plen + gen):
        lg, jcache = step(jtree, jcache, jnp.asarray(toks[:, t:t + 1],
                                                     jnp.int32), jnp.int32(t))
        jlogits.append(np.asarray(lg, np.float32))
    t_toks = _t(toks)
    logits, cache = model.prefill(lm, t_toks[:, :plen], max_len=plen + gen,
                                  seed=3, gs_backend=gs_backend)
    assert logits.dtype == tdtype and logits.shape == (b, cfg.vocab)
    got = [logits]
    for t in range(plen, plen + gen):
        logits, cache = model.decode_step(lm, cache, t_toks[:, t:t + 1], t,
                                          gs_backend=gs_backend)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).float().numpy(),
                               np.stack(jlogits[plen - 1:], 1),
                               **(logit_tol or tol))
    # the global layer's cache is the JAX one's, position for position
    k, v = attention.contiguous_kv(cache[1], plen + gen)
    np.testing.assert_allclose(k.float().numpy(), np.asarray(
        jcache[0]["b1_global"]["k"][0], np.float32), **tol)
    np.testing.assert_allclose(v.float().numpy(), np.asarray(
        jcache[0]["b1_global"]["v"][0], np.float32), **tol)


@pytest.mark.parametrize("gs_backend", ["torch", "hopper"])
def test_prefill_then_decode_equals_jax_float32(gs_backend):
    _prefill_decode_vs_jax("float32", jnp.float32, F32_TOL, gs_backend)


def test_prefill_then_decode_equals_jax_bfloat16():
    _prefill_decode_vs_jax("bfloat16", jnp.bfloat16, BF16_TOL,
                           logit_tol=BF16_LOGIT_TOL)


# -- weights at full width ----------------------------------------------------------

def _zeros(shape):
    """A float32 array of ``shape`` that allocates one element."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape,
                                           (0,) * len(shape))


def test_full_width_params_convert_and_count():
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    assert count_params(cfg) == FULL_PARAMS == j_count_params(jcfg)
    abstract = JModel(jcfg).abstract_params()
    state = convert.params_from_jax(
        cfg, jax.tree.map(lambda s: _zeros(s.shape), abstract))
    meta = transformer.LM(cfg, device="meta").state_dict()
    assert state.keys() == meta.keys()
    assert all(state[k].shape == meta[k].shape for k in meta)
    assert sum(t.numel() for t in state.values()) == FULL_PARAMS
    assert "embed.unembed" not in state
    assert state["embed.table"].shape == (cfg.vocab, cfg.d_model)
    stage = abstract["stages"][0]
    assert set(stage) == {"b0_local", "b1_global"}
    for key, first in (("b0_local", 0), ("b1_global", 1)):
        s = stage[key]["mixer"]["wq"]
        assert s.shape[0] == cfg.n_layers // 2
        assert {tuple(state[f"layers.{i}.mixer.wq"].shape)
                for i in range(first, cfg.n_layers, 2)} == {s.shape[1:]}


def test_params_from_jax_maps_local_and_global_to_alternate_layers():
    cfg = dataclasses.replace(_cfg(), n_layers=4)
    jcfg = dataclasses.replace(_j_cfg(), n_layers=4)
    tree = _model_params(jcfg, jnp.float32)
    state = convert.params_from_jax(cfg, tree)
    stage = tree["stages"][0]
    for g in range(2):
        np.testing.assert_array_equal(
            state[f"layers.{2 * g}.mixer.wq"].numpy(),
            stage["b0_local"]["mixer"]["wq"][g])
        np.testing.assert_array_equal(
            state[f"layers.{2 * g + 1}.mlp.wg"].numpy(),
            stage["b1_global"]["mlp"]["wg"][g])
    np.testing.assert_array_equal(state["embed.table"].numpy(),
                                  tree["embed"]["table"])


# -- serving -------------------------------------------------------------------------

def test_serve_cpu_decode_equals_teacher_forced_forward():
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "6",
                      "--gs-backend", "hopper"])
    cfg = get_smoke_config(ARCH)
    assert res.tokens.shape == (2, 7) and res.logits.shape == (2, 7, 512)
    assert not any(res.launches_prefill.values())      # CPU: plain versions
    assert not any(res.launches_decode.values())
    assert torch.isfinite(res.logits.float()).all()
    seq = torch.cat([res.prompts, res.tokens[:, :-1]], 1)
    hidden = transformer.forward(cfg, res.params, seq)
    tf = transformer.unembed_logits(cfg, res.params.embed,
                                    hidden[:, res.prompt_len - 1:])
    np.testing.assert_allclose(tf.float().numpy(), res.logits.float().numpy(),
                               **BF16_TOL)
    assert torch.equal(res.logits.argmax(-1), res.tokens)


def test_serve_module_runs_gemma2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--prompt-len", "36", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] prefill: 4x36" in out.stdout
    assert "[serve] decode: 4 steps x batch 4" in out.stdout


def test_new_modules_import_no_jax():
    code = ("import sys; import repro_torch.models.transformer, "
            "repro_torch.configs.gemma2_27b, repro_torch.tracing; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'triton')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
