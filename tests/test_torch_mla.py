"""repro_torch's MLA (deepseek-v2 multi-head latent attention) against the
JAX package, on the CPU.

The same numpy inputs and weights go through the JAX function and its
port: ``chunked_attention`` (chunked and ragged, causal or not, a window,
a softcap, dv != dh), ``mla_apply`` and the latent cache its prefill
writes (the JAX package's ``mla_apply_cache``), and the absorbed-matrix
``mla_decode``.  deepseek-v2-236b's smoke config (4 heads, kv_lora_rank
32, q_lora_rank 48, qk 16 + 8, v 16, 16-query chunks) in float32 at 1e-5:
the two sides differ only in summation order.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import attention as j_attn
from repro.models.common import abstract_tree
from repro.models.common import chunked_attention as j_chunked
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention
from repro_torch.models.common import chunked_attention

ARCH = "deepseek-v2-236b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# (B, S, T, KVH, G, dh, dv, chunk, causal, window, softcap, q_offset):
# S a multiple of the chunk, S ragged (one chunk), dv != dh, KV longer
# than the queries (decode-like offsets), a window and a softcap
CHUNK_CASES = [
    (2, 64, 64, 4, 1, 24, 16, 16, True, 0, 0.0, 0),
    (1, 37, 37, 4, 1, 24, 16, 16, True, 0, 0.0, 0),
    (2, 32, 48, 2, 3, 16, 8, 8, True, 0, 0.0, 16),
    (1, 40, 40, 2, 2, 16, 32, 8, False, 0, 0.0, 0),
    (2, 48, 48, 1, 4, 16, 16, 16, True, 8, 0.0, 0),
    (1, 30, 30, 2, 1, 16, 16, 8, True, 0, 50.0, 0),
]


def _cfgs(dtype="float32"):
    return (dataclasses.replace(get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("b,s,t,kvh,g,dh,dv,chunk,causal,window,cap,off",
                         CHUNK_CASES)
def test_chunked_attention_equals_jax(b, s, t, kvh, g, dh, dv, chunk, causal,
                                      window, cap, off):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, s, kvh, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, dv)).astype(np.float32)
    kw = dict(chunk=chunk, causal=causal, window=window, attn_softcap=cap,
              q_offset=off, scale=0.3)
    want = np.asarray(j_chunked(*map(jnp.asarray, (q, k, v)), **kw))
    got = chunked_attention(_t(q), _t(k), _t(v), **kw)
    assert got.shape == (b, s, kvh, g, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_chunked_attention_keeps_q_dtype():
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.standard_normal(sh).astype(np.float32)).bfloat16()
               for sh in ((1, 32, 2, 1, 16), (1, 32, 2, 16), (1, 32, 2, 8)))
    got = chunked_attention(q, k, v, chunk=16)
    want = chunked_attention(q.float(), k.float(), v.float(), chunk=16)
    assert got.dtype == torch.bfloat16 and torch.equal(got,
                                                       want.bfloat16())


def _mla_params(jcfg, seed=0):
    """Numpy weights of one MLA layer in the JAX layout; the norm scales
    moved off 1 so that they matter."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in abstract_tree(j_attn.mla_defs(jcfg), jnp.float32).items():
        if isinstance(s, dict):
            out[k] = {"scale": (1 + 0.1 * rng.standard_normal(
                s["scale"].shape)).astype(np.float32)}
        else:
            out[k] = (rng.standard_normal(s.shape)
                      / np.sqrt(s.shape[0])).astype(np.float32)
    return out


def _port_mla(cfg, npp):
    m = attention.MLA(cfg, device="cpu", dtype=torch.float32)
    state = {}
    for k, v in npp.items():
        if isinstance(v, dict):
            state[f"{k}.scale"] = _t(v["scale"])
        else:
            state[k] = _t(v)
    m.load_state_dict(state)
    return m


def _jp(npp):
    return {k: ({"scale": jnp.asarray(v["scale"])} if isinstance(v, dict)
                else jnp.asarray(v)) for k, v in npp.items()}


@pytest.mark.parametrize("s", [32, 21])       # chunked, and ragged
def test_mla_prefill_equals_jax_and_writes_the_latent_cache(s):
    cfg, jcfg = _cfgs()
    npp = _mla_params(jcfg)
    b, max_len = 2, 40
    x = np.random.default_rng(1).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    jy, jc = j_attn.mla_apply_cache(jcfg, _jp(npp), jnp.asarray(x),
                                    jnp.asarray(pos))
    cache = attention.mla_init_cache(cfg, b, max_len, torch.float32, "cpu")
    y, cache = attention.mla_apply(cfg, _port_mla(cfg, npp), _t(x), _t(pos),
                                   cache=cache)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    assert cache["c_kv"].shape == (b, max_len, cfg.kv_lora_rank)
    assert cache["k_pe"].shape == (b, max_len, cfg.qk_rope_dim)
    for name in ("c_kv", "k_pe"):
        np.testing.assert_allclose(cache[name][:, :s].numpy(),
                                   np.asarray(jc[name]), **F32_TOL)
        assert not cache[name][:, s:].any()
    # without a cache: the same y
    y2, none = attention.mla_apply(cfg, _port_mla(cfg, npp), _t(x), _t(pos))
    assert none is None and torch.equal(y, y2)


def test_mla_decode_equals_jax():
    cfg, jcfg = _cfgs()
    npp = _mla_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    b, max_len, pos = 3, 24, 17
    c_kv = rng.standard_normal((b, max_len, cfg.kv_lora_rank)).astype(
        np.float32)
    k_pe = rng.standard_normal((b, max_len, cfg.qk_rope_dim)).astype(
        np.float32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jy, jc = j_attn.mla_decode(jcfg, _jp(npp), jnp.asarray(x), jnp.int32(pos),
                               {"c_kv": jnp.asarray(c_kv),
                                "k_pe": jnp.asarray(k_pe)})
    cache = {"c_kv": _t(c_kv.copy()), "k_pe": _t(k_pe.copy())}
    y, cache = attention.mla_decode(cfg, _port_mla(cfg, npp), _t(x), pos,
                                    cache)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    for name in ("c_kv", "k_pe"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]),
                                   **F32_TOL)
    with pytest.raises(ValueError, match="outside"):
        attention.mla_decode(cfg, _port_mla(cfg, npp), _t(x), max_len, cache)


def test_mla_decode_iterated_equals_the_prefill():
    # decode over a prompt, step by step (absorbed form), writes the same
    # latent cache and gives each position the prefill's output
    cfg, jcfg = _cfgs()
    npp = _mla_params(jcfg, seed=4)
    m = _port_mla(cfg, npp)
    b, s = 2, 12
    x = _t(np.random.default_rng(5).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    pre = attention.mla_init_cache(cfg, b, s, torch.float32, "cpu")
    y, pre = attention.mla_apply(cfg, m, x, torch.arange(s), cache=pre)
    it = attention.mla_init_cache(cfg, b, s, torch.float32, "cpu")
    ys = []
    for t in range(s):
        yt, it = attention.mla_decode(cfg, m, x[:, t:t + 1], t, it)
        ys.append(yt)
    # the absorbed form contracts over the latent where the prefill
    # contracts over each head's K and V: other sums, held at 1e-4
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               rtol=1e-4, atol=1e-4)
    for name in ("c_kv", "k_pe"):
        np.testing.assert_allclose(it[name].numpy(), pre[name].numpy(),
                                   **F32_TOL)
