"""repro_torch's recurrentgemma-9b serving path against the JAX package, on
the CPU.

recurrentgemma adds the ``hybrid`` family: RG-LRU blocks (``rec``: a causal
conv, real gates, the linear recurrence h_t = a_t h_{t-1} + beta_t gx_t,
new in ``models/rglru.py`` and ``kernels/rglru_scan``) and local attention
(``attn_local``: MQA, window 2048, head size 256) in a (rec, rec, attn)
pattern, 12 times, then (rec, rec).  The smoke config is cut to 5 layers,
so that both stages run.  The same numpy weights (a JAX ``Model.init``
tree carried across by ``convert``) and tokens go through both; float32
at 1e-5, where the two sides differ in summation order only, and the
recurrence bit for bit.

The oracle for prefill + decode is the JAX ``decode_step`` iterated over
the whole sequence from ``init_cache``: the JAX serve driver crashes on
``hybrid`` (its ``block_apply`` returns no cache for ``rec``), and the JAX
``Model.prefill`` cache keeps a local layer's trailing window at slots
0..w-1, no oracle for a decode that writes slot ``pos % w``.  The prompt
(45 tokens) is longer than the window of 16 and no multiple of it.
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
from repro.core import trace_gs as j_trace_gs
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.kernels.paged_decode import paged_decode_attention as j_paged
from repro.kernels.paged_decode.ref import (
    paged_decode_attention_ref as j_paged_ref)
from repro.models import attention as j_attn
from repro.models import rglru as j_rglru
from repro.models import transformer as j_tf
from repro.models.common import abstract_tree
from repro.models.zoo import Model as JModel
from repro.models.zoo import count_params as j_count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import KERNELS, _build, launches
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.kernels.paged_decode.ops import paged_decode_attention
from repro_torch.kernels.paged_decode.ref import paged_decode_split_ref
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import fma_f32, rglru_scan_ref
from repro_torch.launch import serve
from repro_torch.models import attention, convert, rglru, transformer
from repro_torch.models.zoo import Model, count_params
from repro_torch.tracing import trace_gs

ROOT = Path(__file__).resolve().parent.parent
ARCH = "recurrentgemma-9b"
LAYERS = 5                    # (rec, rec, attn_local) and (rec, rec)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# as test_torch_gemma2.py: bfloat16 keeps 8 significant bits (u = 2^-8);
# the two frameworks round the residual stream, RoPE, the gates and GeGLU
# at different places, so values of magnitude up to ~4 may differ by a few
# roundings: held at 8 u; logits, sums over a tied table drawn at scale 1,
# at 2 steps of their top binade
BF16_TOL = dict(rtol=2 ** -5, atol=2 ** -5)
BF16_LOGIT_TOL = dict(rtol=2 ** -5, atol=2 ** -2)
FULL_PARAMS = 9_396_408_320
WINDOW = 16                   # the smoke config's


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype,
                               n_layers=LAYERS)


def _j_cfg(dtype="float32"):
    return dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype,
                               n_layers=LAYERS)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_config_and_layout():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.dh, cfg.d_ff, cfg.vocab, cfg.window,
            cfg.lru_width) == ("hybrid", 38, 4096, 16, 1, 256, 12288, 256000,
                               2048, 4096)
    assert (cfg.mlp_kind, cfg.tie_embeddings, cfg.attn_softcap,
            cfg.logit_softcap) == ("geglu", True, 0.0, 0.0)
    assert transformer.stage_layout(cfg) == [
        (12, ("rec", "rec", "attn_local")), (1, ("rec", "rec"))]
    assert transformer.stage_layout(cfg) == j_tf.stage_layout(
        j_get_config(ARCH))
    kinds = transformer.layer_kinds(cfg)
    assert kinds.count("rec") == 26 and kinds.count("attn_local") == 12
    assert [i for i, k in enumerate(kinds) if k == "attn_local"] == list(
        range(2, 36, 3))
    smoke = _cfg()
    assert transformer.stage_layout(smoke) == j_tf.stage_layout(_j_cfg())
    lm = transformer.LM(smoke, device="meta")
    assert [b.kind for b in lm.layers] == ["rec", "rec", "attn_local",
                                           "rec", "rec"]
    assert [b.window for b in lm.layers] == [0, 0, WINDOW, 0, 0]
    assert isinstance(lm.layers[0].mixer, rglru.RGLRU)
    assert isinstance(lm.layers[2].mixer, attention.GQA)


# -- the recurrence -----------------------------------------------------------

def _scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32)
    beta = np.sqrt(np.clip(1 - a * a, 1e-12, None)).astype(np.float32)
    gx = (3 * rng.standard_normal((b, s, w))).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, beta, gx, h0


@pytest.mark.parametrize("b,s,w", [(2, 37, 64), (1, 1, 3), (3, 200, 17)])
def test_rglru_scan_plain_equals_jax_lax_scan_bitwise(b, s, w):
    a, beta, gx, h0 = _scan_inputs(b, s, w, seed=s)
    xs = tuple(jnp.asarray(np.moveaxis(x, 1, 0)) for x in (a, beta, gx))
    j_last, j_hs = jax.lax.scan(j_rglru._step, jnp.asarray(h0), xs)
    before = launches["rglru_scan"]
    for fn in (rglru_scan, rglru_scan_ref):
        hs, last = fn(*map(_t, (a, beta, gx, h0)))
        assert hs.dtype == last.dtype == torch.float32
        np.testing.assert_array_equal(hs.numpy(),
                                      np.moveaxis(np.asarray(j_hs), 0, 1))
        np.testing.assert_array_equal(last.numpy(), np.asarray(j_last))
    assert launches["rglru_scan"] == before             # CPU: no launch


def test_rglru_scan_order_is_the_fused_form():
    # the unfused a h + beta gx, rounded twice, is another function: over
    # 200 steps it leaves the kernel's order somewhere
    a, beta, gx, h0 = map(_t, _scan_inputs(3, 200, 17, seed=1))
    hs, _ = rglru_scan_ref(a, beta, gx, h0)
    h, unfused = h0, torch.empty_like(hs)
    for t in range(a.shape[1]):
        h = a[:, t] * h + beta[:, t] * gx[:, t]
        unfused[:, t] = h
    assert not torch.equal(hs, unfused)
    torch.testing.assert_close(hs, unfused, rtol=1e-5, atol=1e-5)


def test_fma_f32_rounds_once():
    # a b = 2^-24 - 2^-70 lies just below the halfway point between c = 1 +
    # 2^-23 and 1 + 2^-22: fmaf gives c; the float64 sum rounds to the
    # halfway point, and rounding that to float32 (ties to even) gives
    # 1 + 2^-22
    a = torch.tensor([1 + 2 ** -23], dtype=torch.float32)
    b = torch.tensor([2 ** -24 - 2 ** -47], dtype=torch.float32)
    c = torch.tensor([1 + 2 ** -23], dtype=torch.float32)
    assert fma_f32(a, b, c).item() == 1 + 2 ** -23
    naive = (a.double() * b.double() + c.double()).float()
    assert naive.item() == 1 + 2 ** -22
    # and on random operands of mixed signs and scales, the exact sum
    # (fractions) rounded to nearest, ties to even
    from fractions import Fraction
    rng = np.random.default_rng(7)
    x, y, z = (rng.standard_normal(400) * 2.0 ** rng.integers(-30, 30, 400)
               for _ in range(3))
    x, y, z = (v.astype(np.float32) for v in (x, y, z))
    got = fma_f32(*map(_t, (x, y, z))).numpy()
    for i in range(400):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) + Fraction(
            float(z[i]))
        f = np.float32(float(exact))
        cands = [np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        near = [v for v, d in zip(cands, dist) if d == best]
        want = near[0] if len(near) == 1 else next(
            v for v in near if not (v.view(np.int32) & 1))
        assert got[i] == want, (i, x[i], y[i], z[i])


def test_rglru_scan_wrapper_checks():
    a, beta, gx, h0 = map(_t, _scan_inputs(2, 5, 8, seed=0))
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a.double(), beta, gx, h0)
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, beta[:, :4].contiguous(), gx, h0)
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, beta, gx, h0[:1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), beta, gx,
                   h0)
    # S = 0: no step, h_S is h0
    hs, last = rglru_scan(a[:, :0], beta[:, :0], gx[:, :0], h0)
    assert hs.shape == (2, 0, 8) and torch.equal(last, h0)
    assert "rglru_scan" in KERNELS and "rglru_scan" in _build.SOURCES
    assert "rglru_scan_f32" in _build._SIGNATURES["rglru_scan"]


# -- the RG-LRU block ---------------------------------------------------------

def _rglru_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in abstract_tree(j_rglru.rglru_defs(jcfg), jnp.float32).items():
        if len(s.shape) == 1:        # biases and lam: moved so they matter
            v = 0.5 + 0.3 * rng.standard_normal(s.shape)
        else:
            v = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        out[k] = v.astype(np.float32)
    return out


def _port_rglru(cfg, npp, dtype=torch.float32):
    m = rglru.RGLRU(cfg, device="cpu", dtype=dtype)
    m.load_state_dict({k: _t(v) for k, v in npp.items()})
    return m


@pytest.mark.parametrize("s", [1, 2, 21])
def test_rglru_prefill_and_cache_equal_jax(s):
    """Prefill y against ``rglru_apply``; its cache against JAX
    ``rglru_decode`` iterated over the same S tokens from
    ``rglru_init_cache`` (S = 1, 2: fewer inputs than the conv's 3)."""
    cfg, jcfg = _cfg(), _j_cfg()
    npp = _rglru_params(jcfg)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    x = np.random.default_rng(1).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want = j_rglru.rglru_apply(jcfg, jp, jnp.asarray(x))
    jc = j_rglru.rglru_init_cache(jcfg, 2, jnp.float32)
    for t in range(s):
        _, jc = j_rglru.rglru_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc)
    y, cache = rglru.rglru_prefill(cfg, _port_rglru(cfg, npp), _t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **F32_TOL)
    assert cache["conv"].shape == (2, 3, cfg.lru_width)
    assert cache["h"].dtype == torch.float32
    for k in ("conv", "h"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                   **F32_TOL)


def test_rglru_decode_equals_jax():
    cfg, jcfg = _cfg(), _j_cfg()
    npp = _rglru_params(jcfg, seed=2)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    c = {"conv": rng.standard_normal((3, 3, cfg.lru_width)).astype(
             np.float32),
         "h": rng.standard_normal((3, cfg.lru_width)).astype(np.float32)}
    jy, jc = j_rglru.rglru_decode(jcfg, jp, jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in c.items()})
    before = launches["rglru_scan"]
    y, cache = rglru.rglru_decode(cfg, _port_rglru(cfg, npp), _t(x),
                                  {k: _t(v) for k, v in c.items()})
    assert launches["rglru_scan"] == before
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                   **F32_TOL)
    init = rglru.rglru_init_cache(cfg, 3, torch.bfloat16, "cpu")
    assert init["conv"].dtype == torch.bfloat16
    assert init["h"].dtype == torch.float32


# -- attention at head size 256 -----------------------------------------------

# (B, KVH, G, S, T, causal, window): recurrentgemma's MQA G 16 at dh 256,
# windows that cut keys, a ragged S, rows the window leaves no key
FLASH_256_CASES = [
    (1, 1, 16, 48, 48, True, 16),
    (2, 1, 16, 37, 37, True, 0),
    (1, 2, 4, 40, 40, False, 8),
    (1, 1, 16, 40, 16, True, 4),
]


@pytest.mark.parametrize("b,kvh,g,s,t,causal,window", FLASH_256_CASES)
def test_flash_plain_at_dh256_equals_jax(b, kvh, g, s, t, causal, window):
    dh = 256
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((b, kvh, g, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=0.0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = [j_flash(jq, jk, jv, block_q=8, block_k=8, interpret=True, **kw),
            j_flash_ref(jq, jk, jv, scale=dh ** -0.5, **kw)]
    before = launches["flash_attention"]
    got = flash_attention(_t(q), _t(k), _t(v), **kw)
    assert launches["flash_attention"] == before
    for w in want:
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)


def test_kernel_shapes_take_dh256():
    assert 256 in flash_ops.HEAD_DIMS
    flash_ops.check_kernel_shape(256, 16)
    for opts in (False, True):
        paged_ops.check_kernel_shape(256, 16, options=opts)
    assert (256, 16) in paged_ops.SHAPES
    assert (256, 16) in paged_ops.OPTION_SHAPES
    for dh, g in ((256, 8), (256, 1), (256, 12)):
        with pytest.raises(ValueError, match="not supported"):
            paged_ops.check_kernel_shape(dh, g, options=True)


def _paged_inputs(b, kvh, g, dh, pages, page, pps, lengths, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, kvh, g, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.permutation(pages)[:b * pps].reshape(b, pps).astype(np.int32),
            np.asarray(lengths, np.int32))


def test_paged_plain_at_dh256_g16_equals_jax():
    # without a window: the JAX kernel (interpret mode) and its reference
    ins = _paged_inputs(3, 1, 16, 256, 18, 8, 6, [1, 48, 29], seed=1)
    j_ins = list(map(jnp.asarray, ins))
    got = paged_decode_attention(*map(_t, ins))
    for want in (j_paged(*j_ins, interpret=True),
                 j_paged_ref(*j_ins, scale=256 ** -0.5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("lengths", [[40, 24, 17], [48, 16, 33]])
def test_paged_plain_window_at_dh256_g16_equals_jax(lengths):
    """With the window of 16 (2 pages of 8): where the window starts on a
    page, it is the JAX reference over the table's entries from that page
    at length 16; elsewhere (17, 33: starting inside a page) the kernel's
    split arithmetic at every split count agrees with the plain version."""
    page, w = 8, WINDOW
    ins = _paged_inputs(3, 1, 16, 256, 18, page, 6, lengths, seed=2)
    t = list(map(_t, ins))
    got = paged_decode_attention(*t, window=w)
    q, kp, vp, pt, ln = ins
    for r, length in enumerate(lengths):
        if (length - w) % page:
            continue
        first = (length - w) // page
        want = j_paged_ref(*map(jnp.asarray, (
            q[r:r + 1], kp, vp, pt[r:r + 1, first:first + w // page],
            np.asarray([w], np.int32))), scale=256 ** -0.5)
        np.testing.assert_allclose(got[r:r + 1].numpy(), np.asarray(want),
                                   **F32_TOL)
    for splits in (1, 2, 3):
        split = paged_decode_split_ref(*t, scale=256 ** -0.5, splits=splits,
                                       window=w)
        np.testing.assert_allclose(split.numpy(), got.numpy(), **F32_TOL)


def _gqa_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
            .astype(np.float32)
            for k, s in abstract_tree(j_attn.gqa_defs(jcfg),
                                      jnp.float32).items()}


@pytest.mark.parametrize("pos", [9, 15, 16, 37])
def test_mqa_dh256_decode_equals_jax_ring(pos):
    """recurrentgemma's attention at its head shape (16 query heads on one
    KV head of 256), window 16: the port's paged decode against JAX
    ``gqa_decode`` on its ring of 16 slots, before the ring fills, at the
    wrap and past it."""
    cfg = dataclasses.replace(_cfg(), d_model=64, head_dim=256)
    jcfg = dataclasses.replace(_j_cfg(), d_model=64, head_dim=256)
    npp = _gqa_params(jcfg)
    rng = np.random.default_rng(pos)
    b, max_len, w = 2, 48, WINDOW
    shape = (b, max_len, 1, 256)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    ring = np.zeros((2, b, w) + shape[2:], np.float32)
    for t in range(max(0, pos - w), pos):
        ring[:, :, t % w] = ck[:, t], cv[:, t]
    jy, _ = j_attn.gqa_decode(
        jcfg, {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(x),
        jnp.int32(pos), {"k": jnp.asarray(ring[0]), "v": jnp.asarray(ring[1])},
        window=w)
    m = attention.GQA(cfg, device="cpu", dtype=torch.float32)
    m.load_state_dict({k: _t(v) for k, v in npp.items()})
    cache = attention.gqa_init_cache(
        cfg, attention.page_table(b, 3, seed=1, device="cpu"), torch.float32,
        "cpu")
    attention.write_prefill(cache, _t(ck), _t(cv))
    y, _ = attention.gqa_decode(cfg, m, _t(x), pos, cache, window=w)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)


# -- the model ----------------------------------------------------------------

def _model_params(jcfg, dtype, seed=0):
    """A JAX ``Model.init`` tree with numpy leaves of the JAX dtype, as in
    test_torch_gemma2.py: stacked matrices redrawn at 1/sqrt(fan_in of one
    layer), vectors (norm scales, the RG-LRU's biases and lam) moved by
    noise so that they matter."""
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


def test_forward_logits_equal_jax():
    cfg, jcfg = _cfg(), _j_cfg()
    tree = _model_params(jcfg, jnp.float32)
    lm = _port_lm(cfg, tree, torch.float32)
    toks = _tokens(cfg, 2, 45)
    jtree = jax.tree.map(jnp.asarray, tree)
    jh, _ = j_tf.forward(jcfg, jtree, jnp.asarray(toks, jnp.int32))
    want = j_tf.unembed_logits(jcfg, jtree["embed"], jh)
    before = dict(launches)
    hidden = transformer.forward(cfg, lm, _t(toks))
    assert launches == before                 # CPU: plain versions only
    got = transformer.unembed_logits(cfg, lm.embed, hidden)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _prefill_decode_vs_jax(dtype, jdtype, tol, logit_tol, gs_backend="torch"):
    """Port prefill of 45 tokens (past the window of 16, no multiple of it)
    + 4 decode steps against JAX ``decode_step`` iterated from
    ``init_cache`` over all 49 tokens: the logits at positions 44..48, and
    the RG-LRU layers' final caches."""
    cfg, jcfg = _cfg(dtype), _j_cfg(dtype)
    tree = _model_params(jcfg, jdtype)
    jtree = jax.tree.map(jnp.asarray, tree)
    tdtype = getattr(torch, dtype)
    lm = _port_lm(cfg, tree, tdtype)
    jm, model = JModel(jcfg), Model(cfg)
    plen, gen, b = 45, 4, 2
    toks = _tokens(cfg, b, plen + gen)
    jcache = jm.init_cache(b, plen + gen)
    assert jcache[0]["b2_attn_local"]["k"].shape[2] == WINDOW   # the ring
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
                               np.stack(jlogits[plen - 1:], 1), **logit_tol)
    # the rec layers' states are the JAX ones (layer i of the stages'
    # order: 0, 1 in the first stage's group, 3, 4 in the second stage)
    for i, (s, key) in {0: (0, "b0_rec"), 1: (0, "b1_rec"), 3: (1, "b0_rec"),
                        4: (1, "b1_rec")}.items():
        for name in ("conv", "h"):
            np.testing.assert_allclose(
                cache[i][name].float().numpy(),
                np.asarray(jcache[s][key][name][0], np.float32), **tol)


@pytest.mark.parametrize("gs_backend", ["torch", "hopper"])
def test_prefill_then_decode_equals_jax_float32(gs_backend):
    _prefill_decode_vs_jax("float32", jnp.float32, F32_TOL, F32_TOL,
                           gs_backend)


def test_prefill_then_decode_equals_jax_bfloat16():
    _prefill_decode_vs_jax("bfloat16", jnp.bfloat16, BF16_TOL,
                           BF16_LOGIT_TOL)


def test_rec_cache_carriers_round_trip():
    cfg = _cfg()
    rng = np.random.default_rng(5)
    caches = transformer.init_cache(cfg, 2, 24, torch.float32, "cpu")
    for i, c in enumerate(caches):
        if "h" in c:
            c["conv"].copy_(_t(rng.standard_normal(c["conv"].shape)
                               .astype(np.float32)))
            c["h"].copy_(_t(rng.standard_normal(c["h"].shape)
                            .astype(np.float32)))
    j = convert.cache_to_jax(cfg, caches)
    assert set(j[0]) == {"b0_rec", "b1_rec", "b2_attn_local"}
    assert set(j[1]) == {"b0_rec", "b1_rec"}
    assert j[0]["b0_rec"]["h"].shape == (1, 2, cfg.lru_width)
    back = convert.cache_from_jax(cfg, j)
    for a, b in zip(caches, back):
        if "h" in a:
            assert torch.equal(a["conv"], b["conv"])
            assert torch.equal(a["h"], b["h"])


# -- weights at full width ----------------------------------------------------

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
    assert state["layers.0.mixer.w_a"].shape == (4096, 4096)
    assert state["layers.2.mixer.wq"].shape == (4096, 16, 256)
    assert state["layers.2.mixer.wk"].shape == (4096, 1, 256)
    assert state["layers.37.mixer.lam"].shape == (4096,)
    assert "layers.37.mixer.wq" not in state


def test_params_from_jax_maps_the_38_layers_in_stage_order():
    # at full depth (38 layers), narrow: the stages' slices land on layers
    # 0-35 by (group, kind) and 36, 37 from the last stage
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=38)
    jcfg = dataclasses.replace(j_get_smoke_config(ARCH), n_layers=38,
                               dtype="float32")
    tree = _model_params(jcfg, jnp.float32)
    state = convert.params_from_jax(cfg, tree)
    first, last = tree["stages"]
    assert first["b0_rec"]["mixer"]["w_a"].shape[0] == 12
    assert last["b1_rec"]["mixer"]["lam"].shape[0] == 1
    for g in range(12):
        for k, kind in enumerate(("rec", "rec", "attn_local")):
            name = "w_a" if kind == "rec" else "wq"
            np.testing.assert_array_equal(
                state[f"layers.{3 * g + k}.mixer.{name}"].numpy(),
                first[f"b{k}_{kind}"]["mixer"][name][g])
            np.testing.assert_array_equal(
                state[f"layers.{3 * g + k}.ln2.scale"].numpy(),
                first[f"b{k}_{kind}"]["ln2"]["scale"][g])
    for i, key in ((36, "b0_rec"), (37, "b1_rec")):
        np.testing.assert_array_equal(state[f"layers.{i}.mixer.lam"].numpy(),
                                      last[key]["mixer"]["lam"][0])
    lm = transformer.LM(cfg, device="meta")
    assert [b.kind for b in lm.layers][-3:] == ["attn_local", "rec", "rec"]


# -- the trace ----------------------------------------------------------------

def test_trace_equals_jax():
    # one access on both sides: the embedding's gather of 128 token rows
    tokens = (2, 64)
    jcfg = _j_cfg()
    want = j_trace_gs(lambda p, t: j_tf.forward(jcfg, p, t)[0],
                      JModel(jcfg).abstract_params(jnp.float32),
                      jax.ShapeDtypeStruct(tokens, jnp.int32))
    cfg = _cfg()
    lm = Model(cfg).init(device="cpu")
    toks = _t(_tokens(cfg, *tokens))
    got = trace_gs(lambda t: transformer.forward(cfg, lm, t,
                                                 gs_backend="hopper"), toks)
    assert len(want.accesses) == len(got.accesses) == 1
    (w,), (g,) = want.accesses, got.accesses
    assert (g.kind, g.n_lookups, g.slice_elems, g.moved_bytes) == (
        w.kind, w.n_lookups, w.slice_elems, w.moved_bytes) == (
        "gather", 128, cfg.d_model, 128 * cfg.d_model * 4)


# -- serving ------------------------------------------------------------------

def test_serve_cpu_decode_equals_teacher_forced_forward():
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "6",
                      "--gs-backend", "hopper"])
    cfg = get_smoke_config(ARCH)
    assert res.tokens.shape == (2, 7) and res.logits.shape == (2, 7, 256)
    assert not any(res.launches_prefill.values())      # CPU: plain versions
    assert not any(res.launches_decode.values())
    assert torch.isfinite(res.logits.float()).all()
    seq = torch.cat([res.prompts, res.tokens[:, :-1]], 1)
    hidden = transformer.forward(cfg, res.params, seq)
    tf = transformer.unembed_logits(cfg, res.params.embed,
                                    hidden[:, res.prompt_len - 1:])
    np.testing.assert_allclose(tf.float().numpy(), res.logits.float().numpy(),
                               **BF16_LOGIT_TOL)
    assert torch.equal(res.logits.argmax(-1), res.tokens)


def test_serve_module_runs_recurrentgemma_on_cpu():
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
            "repro_torch.models.rglru, repro_torch.kernels.rglru_scan.ops, "
            "repro_torch.configs.recurrentgemma_9b; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'triton')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
