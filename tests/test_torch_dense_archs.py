"""repro_torch's chatglm3-6b and starcoder2-15b serving paths against the
JAX package, on the CPU.

The two add to the llama3-8b path: chatglm3-6b RoPE over the first half of
each head (mode ``"2d"``, as the JAX package's ``apply_rope`` computes it:
split halves of the first dh // 2 columns, at frequencies over dh // 2, the
rest passed through) and G = 32 / 2 = 16; starcoder2-15b the plain GELU
MLP (``wi`` and ``wo`` only, ``jax.nn.gelu``'s tanh form) and G = 48 / 4 =
12, which paged decode's kernel takes through an instance of its own.  The
same numpy weights (a JAX ``Model.init`` tree carried across by
``convert``) and tokens go through both packages.  The smoke configs
(2 layers, 4 heads over 2 KV heads; chatglm3 d_model 64, dh 16; starcoder2
d_model 48, dh 12) run in float32 at 1e-5, where the two sides differ in
summation order and in their float32 cos, sin and tanh only, and in
bfloat16 at a tolerance stated there.
"""
import dataclasses

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
from repro_torch.kernels.paged_decode.ref import paged_decode_attention_ref
from repro_torch.launch import serve
from repro_torch.models import attention, common, convert, transformer
from repro_torch.models.zoo import Model, count_params

ARCHS = ("chatglm3-6b", "starcoder2-15b")
FULL_PARAMS = {"chatglm3-6b": 6_243_454_976,
               "starcoder2-15b": 15_955_630_080}
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 keeps 8 significant bits (u = 2^-8): the two frameworks round
# the residual stream, RoPE and the MLP at different places, so values of
# magnitude up to ~4 may differ by a few roundings; held at 8 u
BF16_TOL = dict(rtol=2 ** -5, atol=2 ** -5)
# RoPE alone rounds once to bfloat16: a float32 cos or sin one ulp apart
# on the two sides may move that rounding by one step, 2^-8 of the value
ROPE_BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def _j_cfg(arch, dtype="float32"):
    return dataclasses.replace(j_get_smoke_config(arch), dtype=dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the configs ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_configs_field_for_field(arch):
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_smoke_config(arch), j_get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert get_config("chatglm3-6b").rope == "2d"
    assert get_config("starcoder2-15b").mlp_kind == "gelu"


# -- RoPE over half the head ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [12, 16, 128])
@pytest.mark.parametrize("mode", ["2d", "partial", "full"])
def test_apply_rope_equals_jax(mode, dh, dtype):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 37, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 37)).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(j_common.apply_rope(jx, jnp.asarray(pos), 10000.0,
                                          mode), np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    got = common.apply_rope(tx, _t(pos), 10000.0, mode)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype == "float32"
                                  else ROPE_BF16_TOL))
    rot = dh if mode == "full" else dh // 2
    # the columns past rot pass through untouched, bit for bit
    assert torch.equal(got[..., rot:], tx[..., rot:])
    if mode != "full":
        # split halves of the first rot columns at frequencies over rot:
        # position 1 turns column 0 with column rot // 2 by one radian
        one = torch.zeros(1, 1, 1, dh)
        one[..., 0] = 1.0
        turned = common.apply_rope(one, torch.ones(1, 1), 10000.0, mode)
        assert torch.allclose(turned[..., 0], torch.cos(torch.ones(1)))
        assert torch.allclose(turned[..., rot // 2], torch.sin(torch.ones(1)))


# -- the plain GELU MLP -------------------------------------------------------------

def test_gelu_mlp_equals_jax():
    cfg, jcfg = _cfg("starcoder2-15b"), _j_cfg("starcoder2-15b")
    rng = np.random.default_rng(5)
    defs = j_common.mlp_def(jcfg, cfg.d_model, cfg.d_ff)
    npp = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
           .astype(np.float32)
           for k, s in abstract_tree(defs, jnp.float32).items()}
    assert set(npp) == {"wi", "wo"}
    m = common.MLP(cfg, cfg.d_model, cfg.d_ff, device="cpu",
                   dtype=torch.float32)
    assert set(m.state_dict()) == {"wi", "wo"}
    m.load_state_dict({k: _t(v) for k, v in npp.items()})
    x = (3 * rng.standard_normal((2, 11, cfg.d_model))).astype(np.float32)
    want = j_common.mlp_apply(jcfg, {k: jnp.asarray(v) for k, v in
                                     npp.items()}, jnp.asarray(x))
    got = common.mlp_apply(cfg, m, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# -- the GQA block ---------------------------------------------------------------------

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


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_prefill_equals_jax_and_fills_the_pages(arch):
    cfg, jcfg = _cfg(arch), _j_cfg(arch)
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
    k, v = attention.contiguous_kv(cache, 21)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **F32_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_equals_jax(arch):
    cfg, jcfg = _cfg(arch), _j_cfg(arch)
    npp = _gqa_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    b, max_len, pos = 3, 40, 29
    shape = (b, max_len, cfg.n_kv_heads, cfg.dh)
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
    """A JAX ``Model.init`` tree with numpy leaves of the JAX dtype, the
    stacked matrices redrawn at 1/sqrt(fan_in of one layer) (the JAX
    ``init_tree`` takes a stacked leaf's fan-in from its layer axis) and
    the norm scales moved by noise so that they matter."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_equal_jax(arch):
    cfg, jcfg = _cfg(arch), _j_cfg(arch)
    tree = _model_params(jcfg, jnp.float32)
    lm = _port_lm(cfg, tree, torch.float32)
    toks = _tokens(cfg, 2, 37)        # no multiple of the 16-query chunk
    jtree = jax.tree.map(jnp.asarray, tree)
    jh, _ = j_tf.forward(jcfg, jtree, jnp.asarray(toks, jnp.int32))
    want = j_tf.unembed_logits(jcfg, jtree["embed"], jh)
    hidden = transformer.forward(cfg, lm, _t(toks))
    got = transformer.unembed_logits(cfg, lm.embed, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_jax(arch, dtype, tol):
    """Port prefill of 9 tokens + decode x 4 against the JAX Model.prefill,
    spliced into its init_cache as its serve.py does, + decode_step x 4:
    logits and both 2-KV-head caches, carried both ways."""
    cfg, jcfg = _cfg(arch, dtype), _j_cfg(arch, dtype)
    jdtype = getattr(jnp, dtype)
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
    assert back[0]["b0_dense"]["k"].shape == (
        cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.dh)
    for name in ("k", "v"):
        np.testing.assert_allclose(back[0]["b0_dense"][name],
                                   jcache[0]["b0_dense"][name], **tol)
    again = convert.cache_to_jax(cfg, convert.cache_from_jax(cfg, back),
                                 max_len)
    for name in ("k", "v"):
        np.testing.assert_array_equal(again[0]["b0_dense"][name],
                                      back[0]["b0_dense"][name])


# -- weights at full width ----------------------------------------------------------

def _zeros(shape):
    """A float32 array of ``shape`` that allocates one element."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape,
                                           (0,) * len(shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_params_convert_and_count(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    want_n = FULL_PARAMS[arch]
    assert count_params(cfg) == want_n == j_count_params(jcfg)
    abstract = JModel(jcfg).abstract_params()
    state = convert.params_from_jax(
        cfg, jax.tree.map(lambda s: _zeros(s.shape), abstract))
    meta = transformer.LM(cfg, device="meta").state_dict()
    assert state.keys() == meta.keys()
    assert all(state[k].shape == meta[k].shape for k in meta)
    assert sum(t.numel() for t in state.values()) == want_n
    stage = abstract["stages"][0]["b0_dense"]
    assert ("wg" in stage["mlp"]) == (cfg.mlp_kind != "gelu")
    for name, s in (("mixer.wk", stage["mixer"]["wk"]),
                    ("mlp.wi", stage["mlp"]["wi"]),
                    ("mlp.wo", stage["mlp"]["wo"])):
        shapes = {tuple(state[f"layers.{i}.{name}"].shape)
                  for i in range(cfg.n_layers)}
        assert s.shape[0] == cfg.n_layers and shapes == {tuple(s.shape[1:])}
    assert stage["mixer"]["wk"].shape[2] == cfg.n_kv_heads


# -- paged decode at G 12 ----------------------------------------------------------

def _paged_inputs(b, kvh, g, dh, pages, page, pps, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, kvh, g, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.integers(0, pages, (b, pps)).astype(np.int32),   # repeats
            rng.integers(1, page * pps + 1, (b,)).astype(np.int32))


@pytest.mark.parametrize("b,kvh,dh,pages,page,pps",
                         [(2, 4, 128, 12, 16, 3), (3, 2, 16, 8, 8, 4)])
def test_paged_plain_at_g12_equals_jax_kernel_and_oracle(b, kvh, dh, pages,
                                                         page, pps):
    ins = _paged_inputs(b, kvh, 12, dh, pages, page, pps)
    j_ins = list(map(jnp.asarray, ins))
    scale = 1 / dh ** 0.5
    want = [j_paged(*j_ins, interpret=True),
            j_paged_ref(*j_ins, scale=scale)]
    t_ins = list(map(_t, ins))
    before = launches["paged_decode"]
    for got in (paged_decode_attention(*t_ins),
                paged_decode_attention_ref(*t_ins, scale=scale)):
        assert got.shape == (b, kvh, 12, dh)
        for w in want:
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)
    assert launches["paged_decode"] == before          # CPU: no launch


def test_paged_kernel_shapes_take_g12_at_dh128_only():
    assert (128, 12) in paged_ops.SHAPES
    paged_ops.check_kernel_shape(128, 12)
    for dh, g, opts in ((64, 12, False), (128, 3, False), (128, 12, True),
                        (128, 6, True), (128, 10, False), (256, 12, False)):
        with pytest.raises(ValueError, match="not supported"):
            paged_ops.check_kernel_shape(dh, g, options=opts)


# -- serving ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cpu_decode_equals_teacher_forced_forward(arch):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "19", "--gen", "3"])
    cfg = get_smoke_config(arch)
    assert res.tokens.shape == (2, 4)
    assert res.logits.shape == (2, 4, cfg.vocab)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_without_device_raises_when_no_cuda(arch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None runs on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", arch, "--smoke"])
