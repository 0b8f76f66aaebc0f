"""repro_torch's llama3-8b serving path against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its port: flash
attention and paged decode (the JAX Pallas kernels in interpret mode and
their oracles, against the port's plain versions and wrappers), the GQA
block's prefill, the whole model's forward, and prefill + decode with
their caches (the port's paged cache gathered through its table into the
JAX package's contiguous layout).  The smoke config (2 layers, d_model 64,
4 heads, 2 KV heads, dh 16) runs in float32 at 1e-5 (the two sides differ
only in summation order), and once in bfloat16 at a tolerance stated
there.
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
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.kernels.paged_decode import paged_decode_attention as j_paged
from repro.kernels.paged_decode.ref import (
    paged_decode_attention_ref as j_paged_ref)
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro.models.common import abstract_tree
from repro.models.zoo import Model as JModel
from repro.models.zoo import count_params as j_count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.kernels.paged_decode.ops import paged_decode_attention
from repro_torch.kernels.paged_decode.ref import paged_decode_attention_ref
from repro_torch.launch import serve
from repro_torch.models import attention, convert, transformer
from repro_torch.models.zoo import Model, count_params

ROOT = Path(__file__).resolve().parent.parent
ARCH = "llama3-8b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 keeps 8 significant bits (u = 2^-8): the two frameworks round
# the residual stream, RoPE and SwiGLU at different places, so values of
# magnitude up to ~4 may differ by a few roundings; held at 8 u
BF16_TOL = dict(rtol=2 ** -5, atol=2 ** -5)
# (B, KVH, G, S, T, dh, causal, window, softcap): the JAX package's own
# flash test shapes, and a ragged S = T = 33 with a window and a softcap
FLASH_CASES = [
    (2, 2, 2, 64, 64, 16, True, 0, 0.0),
    (1, 1, 4, 128, 128, 32, True, 32, 0.0),
    (2, 1, 1, 64, 64, 16, True, 0, 50.0),
    (1, 2, 2, 96, 96, 16, False, 0, 0.0),
    (2, 2, 2, 33, 33, 16, True, 0, 0.0),
    (1, 2, 4, 33, 33, 16, False, 8, 50.0),
]
# (B, KVH, G, dh, pages, page, pps): the JAX package's own paged cases
PAGED_CASES = [(1, 1, 1, 16, 4, 8, 2), (2, 2, 4, 16, 12, 8, 3),
               (4, 2, 2, 64, 32, 16, 4), (2, 4, 1, 32, 8, 8, 2)]


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def _j_cfg(dtype="float32"):
    return dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- flash attention -------------------------------------------------------------

@pytest.mark.parametrize("b,kvh,g,s,t,dh,causal,window,cap", FLASH_CASES)
def test_flash_plain_equals_jax_kernel_and_oracle(b, kvh, g, s, t, dh,
                                                  causal, window, cap):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, kvh, g, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap)
    scale = 1 / dh ** 0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = [j_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw),
            j_flash_ref(jq, jk, jv, scale=scale, **kw)]
    before = launches["flash_attention"]
    for got in (flash_attention(_t(q), _t(k), _t(v), **kw),
                flash_attention_ref(_t(q), _t(k), _t(v), scale=scale, **kw)):
        assert got.dtype == torch.float32 and got.shape == q.shape
        for w in want:
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)
    assert launches["flash_attention"] == before     # CPU: no kernel launch


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 4, 8, 64)
    k = v = torch.zeros(1, 2, 8, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, torch.zeros(1, 1, 8, 64), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(ValueError, match="no keys"):
        flash_attention(q, k[:, :, :0], v[:, :, :0])
    # a window that leaves rows 8 + 4 - 1 = 11.. no key: the reference's
    # uniform mean of v over all keys, not an error
    vr = torch.arange(2 * 8 * 64, dtype=torch.float32).reshape(1, 2, 8, 64)
    got = flash_attention(torch.zeros(1, 2, 4, 20, 64), k, vr, window=4)
    assert torch.equal(got[:, :, :, 11:],
                       vr.mean(2)[:, :, None, None].expand(1, 2, 4, 9, 64))
    # the kernel's templates: on CUDA tensors these raise before launching
    for dh, g in ((16, 4), (96, 4), (64, 65)):
        with pytest.raises(ValueError):
            flash_ops.check_kernel_shape(dh, g)
    for dh in flash_ops.HEAD_DIMS:
        flash_ops.check_kernel_shape(dh, 4)


# (B, KVH, G, S, T, dh, causal, window, softcap) with S >= T + window:
# rows T + window - 1 .. S - 1 see no key
NO_KEY_CASES = [
    (1, 2, 2, 40, 16, 16, True, 8, 0.0),
    (2, 1, 4, 33, 20, 16, False, 4, 0.0),
    (1, 2, 1, 64, 3, 32, True, 1, 50.0),
    (1, 1, 2, 70, 24, 16, False, 16, 50.0),
]


@pytest.mark.parametrize("b,kvh,g,s,t,dh,causal,window,cap", NO_KEY_CASES)
def test_flash_rows_with_no_key_equal_jax_oracle(b, kvh, g, s, t, dh, causal,
                                                 window, cap):
    # every score of such a row is masked to -1e30 (after the softcap), so
    # its weights are uniform: the mean of v over all T keys
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, kvh, g, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap)
    want = np.asarray(j_flash_ref(*map(jnp.asarray, (q, k, v)),
                                  scale=1 / dh ** 0.5, **kw))
    got = flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    empty = slice(t + window - 1, None)
    np.testing.assert_allclose(
        got[:, :, :, empty],
        np.broadcast_to(v.mean(2)[:, :, None, None], got[:, :, :, empty].shape),
        **F32_TOL)


def test_flash_bfloat16_rounds_once():
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((2, 2, 2, 33, 16), (2, 2, 33, 16), (2, 2, 33, 16)))
    got = flash_attention(q, k, v)
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               scale=0.25)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.bfloat16())


# -- paged decode ----------------------------------------------------------------

def _paged_inputs(b, kvh, g, dh, pages, page, pps, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, kvh, g, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.integers(0, pages, (b, pps)).astype(np.int32),   # repeats
            rng.integers(1, page * pps + 1, (b,)).astype(np.int32))


@pytest.mark.parametrize("b,kvh,g,dh,pages,page,pps", PAGED_CASES)
def test_paged_plain_equals_jax_kernel_and_oracle(b, kvh, g, dh, pages, page,
                                                  pps):
    ins = _paged_inputs(b, kvh, g, dh, pages, page, pps)
    j_ins = list(map(jnp.asarray, ins))
    scale = 1 / dh ** 0.5
    want = [j_paged(*j_ins, interpret=True),
            j_paged_ref(*j_ins, scale=scale)]
    t_ins = list(map(_t, ins))
    before = launches["paged_decode"]
    for got in (paged_decode_attention(*t_ins),
                paged_decode_attention_ref(*t_ins, scale=scale)):
        assert got.dtype == torch.float32 and got.shape == (b, kvh, g, dh)
        for w in want:
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)
    assert launches["paged_decode"] == before


def test_paged_length_zero_equals_jax_oracle():
    # every score masked to -1e30: uniform weights over all pps * page
    # positions of the row's pages (rows of length 0 beside others)
    ins = list(_paged_inputs(3, 2, 4, 16, 12, 8, 3, seed=2))
    ins[4] = np.array([0, 24, 0], dtype=np.int32)
    want = np.asarray(j_paged_ref(*map(jnp.asarray, ins), scale=0.25))
    got = paged_decode_attention(*map(_t, ins)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    _, kp, vp, pt, _ = ins
    rows = vp[:, pt[0]].reshape(2, -1, 16)          # (KVH, pps * page, dh)
    np.testing.assert_allclose(
        got[0], np.broadcast_to(rows.mean(1)[:, None], (2, 4, 16)), **F32_TOL)


def test_paged_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, pt, ln = map(_t, _paged_inputs(2, 2, 4, 64, 8, 8, 3))
    with pytest.raises(TypeError, match="bfloat16"):
        paged_decode_attention(q.double(), kp.double(), vp.double(), pt, ln)
    with pytest.raises(TypeError):
        paged_decode_attention(q, kp, vp, pt.long(), ln)
    with pytest.raises(TypeError):
        paged_decode_attention(q, kp, vp, pt, ln.long())
    with pytest.raises(ValueError, match="shape"):
        paged_decode_attention(q, kp[:1].contiguous(), vp, pt, ln)
    with pytest.raises(ValueError, match="rows"):
        paged_decode_attention(q, kp, vp, pt[:1], ln)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, kp, vp, pt.T.contiguous().T, ln)
    for dh, g in ((16, 4), (96, 4), (64, 3), (64, 32)):
        with pytest.raises(ValueError):
            paged_ops.check_kernel_shape(dh, g)
    for dh in paged_ops.HEAD_DIMS:
        for g in paged_ops.GROUPS:
            paged_ops.check_kernel_shape(dh, g)


# -- the GQA block -------------------------------------------------------------------

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


def test_gqa_prefill_equals_jax_and_fills_the_pages():
    cfg, jcfg = _cfg(), _j_cfg()
    npp = _gqa_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    pos = np.arange(21, dtype=np.int32)
    want, (jk, jv) = j_attn.gqa_apply(
        jcfg, {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(x),
        jnp.asarray(pos), return_kv=True)
    table = attention.page_table(2, 3, seed=7, device="cpu")
    cache = attention.gqa_init_cache(cfg, table, torch.float32, "cpu")
    y, cache = attention.gqa_apply(cfg, _port_gqa(cfg, npp), _t(x), _t(pos),
                                   cache=cache)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **F32_TOL)
    # the table is a permutation: pages scattered, none shared
    assert sorted(table.reshape(-1).tolist()) == list(range(6))
    k, v = attention.contiguous_kv(cache, 21)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **F32_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32_TOL)


def test_gqa_decode_equals_jax():
    cfg, jcfg = _cfg(), _j_cfg()
    npp = _gqa_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    b, max_len, pos = 3, 40, 29
    shape = (b, max_len, cfg.n_kv_heads, 16)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jy, jc = j_attn.gqa_decode(
        jcfg, {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(x),
        jnp.int32(pos), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)})
    table = attention.page_table(b, 3, seed=1, device="cpu")
    cache = attention.gqa_init_cache(cfg, table, torch.float32, "cpu")
    attention.write_prefill(cache, _t(ck), _t(cv))
    y, cache = attention.gqa_decode(cfg, _port_gqa(cfg, npp), _t(x), pos,
                                    cache)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    k, v = attention.contiguous_kv(cache, max_len)
    np.testing.assert_allclose(k.numpy(), np.asarray(jc["k"]), **F32_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jc["v"]), **F32_TOL)


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


def test_forward_logits_equal_jax():
    cfg, jcfg = _cfg(), _j_cfg()
    tree = _model_params(jcfg, jnp.float32)
    lm = _port_lm(cfg, tree, torch.float32)
    toks = _tokens(cfg, 2, 37)        # no multiple of the 16-query chunk
    jtree = jax.tree.map(jnp.asarray, tree)
    jh, _ = j_tf.forward(jcfg, jtree, jnp.asarray(toks, jnp.int32))
    want = j_tf.unembed_logits(jcfg, jtree["embed"], jh)
    hidden = transformer.forward(cfg, lm, _t(toks))
    got = transformer.unembed_logits(cfg, lm.embed, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _prefill_decode_vs_jax(dtype, jdtype, tol):
    """Port prefill of 9 tokens + decode x 4 against the JAX Model.prefill,
    spliced into its init_cache as serve.py:62-67 does, + decode_step x 4:
    logits and caches."""
    cfg, jcfg = _cfg(dtype), _j_cfg(dtype)
    tree = _model_params(jcfg, jdtype)
    jtree = jax.tree.map(jnp.asarray, tree)
    tdtype = getattr(torch, dtype)
    lm = _port_lm(cfg, tree, tdtype)
    jm, model = JModel(jcfg), Model(cfg)
    plen, gen, b = 9, 4, 2
    max_len = plen + gen
    toks = _tokens(cfg, b, max_len)

    jlast, jpre = jm.prefill(jtree, {"tokens": jnp.asarray(toks[:, :plen],
                                                           jnp.int32)})

    def splice(full, pre):
        pad = [(0, f - p) for f, p in zip(full.shape, pre.shape)]
        return jnp.pad(pre, pad).astype(full.dtype)
    jcache = jax.tree.map(splice, jm.init_cache(b, max_len), jpre)
    jcache_prompt = jax.tree.map(lambda v: np.asarray(v, np.float32), jcache)
    jlogits = [np.asarray(jlast, np.float32)]
    step = jax.jit(jm.decode_step)
    for t in range(plen, max_len):
        lg, jcache = step(jtree, jcache,
                          jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t))
        jlogits.append(np.asarray(lg, np.float32))
    jcache = jax.tree.map(lambda v: np.asarray(v, np.float32), jcache)

    t_toks = _t(toks)
    logits, cache = model.prefill(lm, t_toks[:, :plen], max_len=max_len,
                                  seed=3)
    assert logits.dtype == tdtype and logits.shape == (b, cfg.vocab)
    table = cache[0]["page_table"]
    assert table.shape == (b, 1) and all(c["page_table"] is table
                                         for c in cache)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            convert.cache_to_jax(cfg, cache, max_len)[0]["b0_dense"][name],
            jcache_prompt[0]["b0_dense"][name], **tol)
    got = [logits]                    # positions plen-1 .. max_len-1
    for t in range(plen, max_len):
        logits, cache = model.decode_step(lm, cache, t_toks[:, t:t + 1], t)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).float().numpy(),
                               np.stack(jlogits, 1), **tol)
    back = convert.cache_to_jax(cfg, cache, max_len)
    for name in ("k", "v"):
        np.testing.assert_allclose(back[0]["b0_dense"][name],
                                   jcache[0]["b0_dense"][name], **tol)
    # and the caches carry across both ways
    again = convert.cache_to_jax(cfg, convert.cache_from_jax(cfg, back),
                                 max_len)
    for name in ("k", "v"):
        np.testing.assert_array_equal(again[0]["b0_dense"][name],
                                      back[0]["b0_dense"][name])


def test_prefill_then_decode_equals_jax_float32():
    _prefill_decode_vs_jax("float32", jnp.float32, F32_TOL)


def test_prefill_then_decode_equals_jax_bfloat16():
    _prefill_decode_vs_jax("bfloat16", jnp.bfloat16, BF16_TOL)


# -- weights at full width ----------------------------------------------------------

def _zeros(shape):
    """A float32 array of ``shape`` that allocates one element."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape,
                                           (0,) * len(shape))


def test_full_width_params_convert_and_count():
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    want_n = 8_030_261_248
    assert count_params(cfg) == want_n == j_count_params(jcfg)
    abstract = JModel(jcfg).abstract_params()
    state = convert.params_from_jax(
        cfg, jax.tree.map(lambda s: _zeros(s.shape), abstract))
    meta = transformer.LM(cfg, device="meta").state_dict()
    assert state.keys() == meta.keys()
    assert all(state[k].shape == meta[k].shape for k in meta)
    assert sum(t.numel() for t in state.values()) == want_n
    stage = abstract["stages"][0]["b0_dense"]
    for name, s in (("mixer.wq", stage["mixer"]["wq"]),
                    ("mlp.wo", stage["mlp"]["wo"]),
                    ("ln2.scale", stage["ln2"]["scale"])):
        shapes = {tuple(state[f"layers.{i}.{name}"].shape)
                  for i in range(cfg.n_layers)}
        assert s.shape[0] == cfg.n_layers and shapes == {tuple(s.shape[1:])}


# -- serving -------------------------------------------------------------------------

def test_serve_cpu_decode_equals_teacher_forced_forward():
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "19", "--gen", "3"])
    cfg = get_smoke_config(ARCH)
    assert res.tokens.shape == (2, 4) and res.logits.shape == (2, 4, 512)
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


def test_serve_module_runs_llama_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] prefill: 4x32" in out.stdout
    assert "[serve] decode: 16 steps x batch 4" in out.stdout


def test_serve_and_model_without_device_raise_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None runs on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke"])               # llama3-8b is the default
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_smoke_config(ARCH)).init()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_smoke_config(ARCH)).init_cache(1, 8)
