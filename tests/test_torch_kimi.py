"""repro_torch's kimi-k2-1t-a32b serving path against the JAX package, on
the CPU.

kimi-k2 is the ``moe`` family with GQA (the JAX package's config: 64
heads over 8 KV heads at head size 112, not the published model's MLA),
384 routed experts top-8 and one shared expert, and a first dense layer.
What it adds to the ported paths: flash attention and paged decode at dh
112, G 8 (the kernels' new instances; here their plain versions, against
the JAX Pallas kernels in interpret mode and their oracles), and the MoE
dispatch at 384 experts (against the JAX ``moe_apply_gspmd`` on the
``torch``, ``hopper`` and ``onehot`` backends).  The same numpy weights
(a JAX ``Model.init`` tree carried across by ``convert``) and tokens go
through both packages.  Float32 at 1e-5 (the two sides differ only in
summation order), bfloat16 at a tolerance stated there.
"""
import dataclasses

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
from repro.models import moe as j_moe
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
from repro_torch.models import convert, moe, transformer
from repro_torch.models.zoo import Model, count_params

ARCH = "kimi-k2-1t-a32b"
FULL_PARAMS = 1_027_291_575_296        # 61 layers, as the JAX count
SERVED_PARAMS = 19_934_645_248         # 2 layers: the dense and one MoE
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 keeps 8 significant bits (u = 2^-8): the two frameworks round
# the residual stream, RoPE, the router and SwiGLU at different places, so
# values of magnitude up to ~4 may differ by a few roundings; held at 8 u
BF16_TOL = dict(rtol=2 ** -5, atol=2 ** -5)
BACKENDS = ("torch", "hopper", "onehot")


def _cfg(dtype="float32", **kw):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **kw)


def _j_cfg(dtype="float32", **kw):
    return dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype, **kw)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the config ------------------------------------------------------------------------

def test_configs_equal_the_jax_configs_field_for_field():
    for mine, theirs in ((get_config(ARCH), j_get_config(ARCH)),
                         (get_smoke_config(ARCH), j_get_smoke_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    cfg = get_config(ARCH)
    # GQA at dh 112, not MLA: the JAX package's assignment-table config
    assert (cfg.attn_kind, cfg.dh, cfg.n_heads // cfg.n_kv_heads) == (
        "full", 112, 8)
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts) == (384, 8, 1)


# -- flash attention and paged decode at dh 112, G 8 --------------------------------

# (B, KVH, G, S, T, causal, window): both masks, a window of 64, a ragged
# S = T = 33 and rows that a window leaves no key (S > T + window - 1)
FLASH_CASES = [(1, 1, 8, 64, 64, True, 0), (1, 2, 8, 33, 33, False, 0),
               (2, 1, 8, 96, 96, True, 64), (1, 1, 8, 40, 16, True, 8)]


@pytest.mark.parametrize("b,kvh,g,s,t,causal,window", FLASH_CASES)
def test_flash_plain_at_dh112_equals_jax_kernel_and_oracle(b, kvh, g, s, t,
                                                           causal, window):
    dh = 112
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((b, kvh, g, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    scale = 1 / dh ** 0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = [j_flash_ref(jq, jk, jv, scale=scale, **kw)]
    if s == t:                # the JAX kernel's own grid: S = T blocks
        want.append(j_flash(jq, jk, jv, block_q=32, block_k=32,
                            interpret=True, **kw))
    before = launches["flash_attention"]
    for got in (flash_attention(_t(q), _t(k), _t(v), **kw),
                flash_attention_ref(_t(q), _t(k), _t(v), scale=scale, **kw)):
        assert got.shape == q.shape
        for w in want:
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)
    assert launches["flash_attention"] == before     # CPU: no kernel launch


def _paged_inputs(b, kvh, g, dh, pages, page, pps, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    lengths = rng.integers(1, page * pps + 1, (b,)).astype(np.int32)
    lengths[0] = page * pps                           # one full row
    return (rng.standard_normal((b, kvh, g, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.integers(0, pages, (b, pps)).astype(np.int32),   # repeats
            lengths)


@pytest.mark.parametrize("b,kvh,pages,page,pps",
                         [(2, 2, 12, 16, 3), (3, 1, 8, 8, 4)])
def test_paged_plain_at_112_8_equals_jax_kernel_and_oracle(b, kvh, pages,
                                                           page, pps):
    ins = _paged_inputs(b, kvh, 8, 112, pages, page, pps)
    j_ins = list(map(jnp.asarray, ins))
    scale = 1 / 112 ** 0.5
    want = [j_paged(*j_ins, interpret=True),
            j_paged_ref(*j_ins, scale=scale)]
    t_ins = list(map(_t, ins))
    before = launches["paged_decode"]
    for got in (paged_decode_attention(*t_ins),
                paged_decode_attention_ref(*t_ins, scale=scale)):
        assert got.shape == (b, kvh, 8, 112)
        for w in want:
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)
    assert launches["paged_decode"] == before          # CPU: no launch


def test_kernel_shapes_take_dh112_at_g8_without_options():
    assert 112 in flash_ops.HEAD_DIMS
    flash_ops.check_kernel_shape(112, 8)
    assert (112, 8) in paged_ops.SHAPES
    assert (112, 8) not in paged_ops.OPTION_SHAPES
    paged_ops.check_kernel_shape(112, 8)
    for dh, g, opts in ((112, 8, True), (112, 4, False), (112, 16, False),
                        (96, 8, False)):
        with pytest.raises(ValueError, match="not supported"):
            paged_ops.check_kernel_shape(dh, g, options=opts)
    with pytest.raises(ValueError, match="head size"):
        flash_ops.check_kernel_shape(96, 8)


# -- the MoE at 384 experts, top-8, one shared -------------------------------------

def _moe_cfgs():
    """kimi's routing (384 experts, top-8, one shared expert) at a narrow
    width."""
    kw = dict(n_experts=384, top_k=8, n_shared_experts=1, d_model=32,
              d_ff_expert=16)
    return _cfg(**kw), _j_cfg(**kw)


def _moe_params(jcfg, seed, hot=()):
    rng = np.random.default_rng(seed)
    tree = abstract_tree(j_moe.moe_defs(jcfg), jnp.float32)

    def draw(s):
        return (rng.standard_normal(s.shape)
                / np.sqrt(s.shape[-2])).astype(np.float32)
    out = {k: ({kk: draw(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else draw(v)) for k, v in tree.items()}
    u = rng.standard_normal(jcfg.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    for e in hot:
        out["router"][:, e] += 3 * u
    return out, u


def _port_moe(cfg, npp):
    m = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    state = {}
    for k, v in npp.items():
        if isinstance(v, dict):
            state.update({f"{k}.{kk}": _t(vv) for kk, vv in v.items()})
        else:
            state[k] = _t(v)
    m.load_state_dict(state)
    return m


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("hot", [(), tuple(range(8))])
def test_moe_at_384_experts_equals_jax(backend, hot):
    cfg, jcfg = _moe_cfgs()
    npp, u = _moe_params(jcfg, seed=len(hot), hot=hot)
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 48, cfg.d_model))
         + 4.0 * u * rng.random((2, 48, 1)) * bool(hot)).astype(np.float32)
    p = _port_moe(cfg, npp)
    n = x.shape[0] * x.shape[1]
    cap = moe.capacity(cfg, n)
    assert cap == j_moe._capacity(jcfg, n) == 8
    tope, _, _ = moe.route(cfg, p, _t(x).reshape(-1, cfg.d_model))
    loads = np.bincount(tope.reshape(-1).numpy(), minlength=384)
    if hot:
        assert loads[list(hot)].min() > cap   # the hot experts overflow
    jp = jax.tree.map(jnp.asarray, npp)
    want_y, want_aux = j_moe.moe_apply_gspmd(jcfg, jp, jnp.asarray(x))
    before = dict(launches)
    y, aux = moe.moe_apply(cfg, p, _t(x), backend)
    assert launches == before                 # CPU: plain versions only
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_TOL)


def test_full_width_capacity_at_the_served_shapes():
    cfg = get_config(ARCH)
    assert moe.capacity(cfg, 4 * 2048) == 216     # 65,536 assignments
    assert moe.capacity(cfg, 4) == cfg.top_k == 8


# -- the model ---------------------------------------------------------------------

def _model_params(jcfg, dtype, seed=0):
    """A JAX ``Model.init`` tree with numpy leaves of the JAX dtype, the
    stacked matrices redrawn at 1/sqrt(fan_in of one layer) and the norm
    scales moved by noise so that they matter."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        stacked = path[0].key == "stages"
        if stacked and v.ndim >= 3:
            # an expert stack (L, E, d_in, d_out) takes its fan-in at axis 2
            fan = v.shape[2 if "experts" in str(path) else 1]
            v = rng.standard_normal(v.shape) / np.sqrt(fan)
        elif v.ndim == 1 or (stacked and v.ndim == 2):
            v = v + 0.1 * rng.standard_normal(v.shape)
        return np.asarray(jnp.asarray(v.astype(np.float32), dtype))
    return jax.tree_util.tree_map_with_path(
        leaf, JModel(jcfg).init(jax.random.PRNGKey(seed)))


def _port_lm(cfg, tree, dtype):
    lm = transformer.LM(cfg, device="cpu", dtype=dtype)
    lm.load_state_dict(convert.params_from_jax(cfg, tree))
    return lm


def _tokens(cfg, b, s, seed=4):
    return np.random.default_rng(seed).integers(2, cfg.vocab, (b, s))


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_forward_logits_equal_jax(backend):
    cfg, jcfg = _cfg(), _j_cfg()
    assert transformer.layer_kinds(cfg) == ["dense", "moe"]
    tree = _model_params(jcfg, jnp.float32)
    lm = _port_lm(cfg, tree, torch.float32)
    toks = _tokens(cfg, 2, 37)
    jtree = jax.tree.map(jnp.asarray, tree)
    jh, _ = j_tf.forward(jcfg, jtree, jnp.asarray(toks, jnp.int32))
    want = j_tf.unembed_logits(jcfg, jtree["embed"], jh)
    hidden = transformer.forward(cfg, lm, _t(toks), gs_backend=backend)
    got = transformer.unembed_logits(cfg, lm.embed, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_then_decode_equals_jax(dtype, tol):
    """Port prefill of 9 tokens + decode x 4 against the JAX Model.prefill,
    spliced into its init_cache as its serve.py does, + decode_step x 4:
    logits and the paged caches of both layers, carried both ways."""
    cfg, jcfg = _cfg(dtype), _j_cfg(dtype)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    tree = _model_params(jcfg, jdtype, seed=1)
    jtree = jax.tree.map(jnp.asarray, tree)
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
                                  seed=3, gs_backend="hopper")
    got = [logits]
    for t in range(plen, max_len):
        logits, cache = model.decode_step(lm, cache, t_toks[:, t:t + 1], t,
                                          gs_backend="hopper")
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).float().numpy(),
                               np.stack(jlogits, 1), **tol)
    back = convert.cache_to_jax(cfg, cache, max_len)
    for stage, kind in ((0, "b0_dense"), (1, "b0_moe")):
        for name in ("k", "v"):
            assert back[stage][kind][name].shape == (
                1, b, max_len, cfg.n_kv_heads, cfg.dh)
            np.testing.assert_allclose(back[stage][kind][name],
                                       jcache[stage][kind][name], **tol)


# -- weights at full width ----------------------------------------------------------

def _zeros(shape):
    """A float32 array of ``shape`` that allocates one element."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape,
                                           (0,) * len(shape))


@pytest.mark.parametrize("layers,want", [(61, FULL_PARAMS),
                                         (2, SERVED_PARAMS)])
def test_count_params_equals_jax(layers, want):
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
    jcfg = dataclasses.replace(j_get_config(ARCH), n_layers=layers)
    assert count_params(cfg) == want == j_count_params(jcfg)


def test_served_depth_params_convert():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    jcfg = dataclasses.replace(j_get_config(ARCH), n_layers=2)
    abstract = JModel(jcfg).abstract_params()
    state = convert.params_from_jax(
        cfg, jax.tree.map(lambda s: _zeros(s.shape), abstract))
    meta = transformer.LM(cfg, device="meta").state_dict()
    assert state.keys() == meta.keys()
    assert all(state[k].shape == meta[k].shape for k in meta)
    assert sum(t.numel() for t in state.values()) == SERVED_PARAMS
    assert meta["layers.1.mlp.experts.wi"].shape == (384, 7168, 2048)
    assert meta["layers.0.mlp.wi"].shape == (7168, 18432)
    assert meta["layers.1.mixer.wk"].shape == (7168, 8, 112)


# -- serving ------------------------------------------------------------------------

def test_serve_cpu_hopper_equals_torch_and_launches_nothing():
    # bfloat16, the smoke config: the hopper backend's plain versions give
    # the torch backend's tokens and logits bit for bit on the CPU
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "19", "--gen", "3"]
    res = serve.main(argv + ["--gs-backend", "hopper"])
    ref = serve.main(argv)
    assert res.tokens.shape == (2, 4) and res.logits.shape == (2, 4, 256)
    assert not any(res.launches_prefill.values())      # CPU: plain versions
    assert not any(res.launches_decode.values())
    assert torch.isfinite(res.logits.float()).all()
    assert torch.equal(res.logits, ref.logits)
    assert torch.equal(res.tokens, ref.tokens)


def test_serve_cpu_decode_equals_teacher_forced_forward():
    # float32 at a capacity that drops nothing (E / k): the prefill and the
    # steps then route every token as one forward over the whole sequence
    cfg = _cfg(capacity_factor=8 / 2)
    res = serve.run(cfg, 2, 19, 3, device="cpu", gs_backend="hopper")
    assert res.tokens.shape == (2, 4)
    seq = torch.cat([res.prompts, res.tokens[:, :-1]], 1)
    hidden = transformer.forward(cfg, res.params, seq, gs_backend="hopper")
    tf = transformer.unembed_logits(cfg, res.params.embed,
                                    hidden[:, res.prompt_len - 1:])
    np.testing.assert_allclose(tf.numpy(), res.logits.numpy(), **F32_TOL)
    assert torch.equal(res.logits.argmax(-1), res.tokens)
