"""repro_torch's internvl2-26b serving path against the JAX package, on the
CPU.

internvl2-26b is the ``vlm`` family: the dense stack (48 layers, GQA 48
over 8 heads at dh 128, SwiGLU) after ``n_img_tokens`` precomputed image
embeddings, which take the first positions, before the sqrt(d_model)
scale; its InternViT frontend is a stub in both packages.  The same numpy
weights (a JAX ``Model.init`` tree carried across by ``convert``), image
embeddings and tokens go through both.  The smoke config (2 layers, 4
heads over 2 KV heads, d_model 64, dh 16, 8 image tokens) runs in float32
at 1e-5, where the two sides differ in summation order and in their
float32 cos and sin only, and in bfloat16 at a tolerance stated there.
G = 48 / 8 = 6 at full width: paged decode's plain version is held to the
JAX kernel (interpret mode) and reference at G 6.
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
from repro.models import transformer as j_tf
from repro.models.zoo import Model as JModel
from repro.models.zoo import count_params as j_count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import NOT_PORTED
from repro_torch.kernels import launches
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.kernels.paged_decode.ops import paged_decode_attention
from repro_torch.kernels.paged_decode.ref import paged_decode_attention_ref
from repro_torch.launch import serve
from repro_torch.models import convert, transformer
from repro_torch.models.zoo import Model, count_params

ARCH = "internvl2-26b"
FULL_PARAMS = 19_861_260_288
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 keeps 8 significant bits (u = 2^-8): the two frameworks round
# the residual stream, RoPE and the MLP at different places, so values of
# magnitude up to ~4 may differ by a few roundings; held at 8 u
BF16_TOL = dict(rtol=2 ** -5, atol=2 ** -5)


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def _j_cfg(dtype="float32"):
    return dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


def _model_params(jcfg, dtype, seed=0):
    """A JAX ``Model.init`` tree with numpy leaves of the JAX dtype, the
    stacked matrices redrawn at 1/sqrt(fan_in of one layer) and the norm
    scales moved by noise so that they matter."""
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


def _inputs(cfg, b, s, seed=4):
    """Tokens (B, S) and image embeddings (B, n_img, d) from one seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(2, cfg.vocab, (b, s)),
            rng.standard_normal((b, cfg.n_img_tokens, cfg.d_model)
                                ).astype(np.float32))


# -- the config -------------------------------------------------------------------------

def test_config_equals_the_jax_config_and_nothing_is_left_unported():
    for mine, theirs in ((get_config(ARCH), j_get_config(ARCH)),
                         (get_smoke_config(ARCH), j_get_smoke_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert NOT_PORTED == ()
    cfg = get_config(ARCH)
    assert cfg.family == "vlm" and cfg.n_heads // cfg.n_kv_heads == 6
    assert transformer.stage_layout(cfg) == j_tf.stage_layout(
        j_get_config(ARCH)) == [(48, ("dense",))]


# -- the model ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_images", [True, False])
def test_forward_with_images_equals_jax(with_images):
    """The hidden states over image + text positions, then the text
    positions' logits, against the JAX ``transformer.forward`` (37 tokens:
    no multiple of the 16-query chunk)."""
    cfg, jcfg = _cfg(), _j_cfg()
    tree = _model_params(jcfg, jnp.float32)
    lm = _port_lm(cfg, tree, torch.float32)
    toks, img = _inputs(cfg, 2, 37)
    jtree = jax.tree.map(jnp.asarray, tree)
    jimg = jnp.asarray(img) if with_images else None
    jh, _ = j_tf.forward(jcfg, jtree, jnp.asarray(toks, jnp.int32),
                         img_embeds=jimg)
    hidden = transformer.forward(cfg, lm, _t(toks),
                                 img_embeds=_t(img) if with_images else None)
    n_img = cfg.n_img_tokens if with_images else 0
    assert hidden.shape == (2, n_img + 37, cfg.d_model)
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(jh),
                               **F32_TOL)
    want = j_tf.unembed_logits(jcfg, jtree["embed"], jh[:, n_img:])
    got = transformer.unembed_logits(cfg, lm.embed, hidden[:, n_img:])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_with_images_then_decode_equals_jax(dtype, tol):
    """Port prefill of 8 image embeddings + 9 tokens, then decode x 4,
    against the JAX ``Model.prefill(img_embeds=...)`` spliced into its
    ``init_cache`` (no local layers: the JAX prefill cache is a valid
    oracle) + ``decode_step`` x 4 at positions n_img + t: logits and both
    KV caches, carried both ways."""
    cfg, jcfg = _cfg(dtype), _j_cfg(dtype)
    jdtype = getattr(jnp, dtype)
    tree = _model_params(jcfg, jdtype)
    jtree = jax.tree.map(jnp.asarray, tree)
    tdtype = getattr(torch, dtype)
    lm = _port_lm(cfg, tree, tdtype)
    jm, model = JModel(jcfg), Model(cfg)
    plen, gen, b = 9, 4, 2
    n_img = cfg.n_img_tokens
    max_len = n_img + plen + gen
    toks, img = _inputs(cfg, b, plen + gen)
    img = np.asarray(jnp.asarray(img, jdtype).astype(jnp.float32))

    jlast, jpre = jm.prefill(jtree, {
        "tokens": jnp.asarray(toks[:, :plen], jnp.int32),
        "img_embeds": jnp.asarray(img, jdtype)})

    def splice(full, pre):
        pad = [(0, f - p) for f, p in zip(full.shape, pre.shape)]
        return jnp.pad(pre, pad).astype(full.dtype)
    jcache = jax.tree.map(splice, jm.init_cache(b, max_len), jpre)
    jcache_prompt = jax.tree.map(lambda v: np.asarray(v, np.float32), jcache)
    jlogits = [np.asarray(jlast, np.float32)]
    step = jax.jit(jm.decode_step)
    for t in range(plen, plen + gen):
        lg, jcache = step(jtree, jcache,
                          jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(n_img + t))
        jlogits.append(np.asarray(lg, np.float32))
    jcache = jax.tree.map(lambda v: np.asarray(v, np.float32), jcache)

    t_toks = _t(toks)
    logits, cache = model.prefill(lm, t_toks[:, :plen], max_len=max_len,
                                  seed=3, img_embeds=_t(img).to(tdtype))
    assert logits.dtype == tdtype and logits.shape == (b, cfg.vocab)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            convert.cache_to_jax(cfg, cache, max_len)[0]["b0_dense"][name],
            jcache_prompt[0]["b0_dense"][name], **tol)
    got = [logits]
    for t in range(plen, plen + gen):
        logits, cache = model.decode_step(lm, cache, t_toks[:, t:t + 1],
                                          n_img + t)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).float().numpy(),
                               np.stack(jlogits, 1), **tol)
    back = convert.cache_to_jax(cfg, cache, max_len)
    assert back[0]["b0_dense"]["k"].shape == (
        cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.dh)
    for name in ("k", "v"):
        np.testing.assert_allclose(back[0]["b0_dense"][name],
                                   jcache[0]["b0_dense"][name], **tol)


def test_prefill_default_max_len_counts_the_images():
    cfg = _cfg()
    lm = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks, img = _inputs(cfg, 2, 5)
    _, cache = Model(cfg).prefill(lm, _t(toks), img_embeds=_t(img))
    # n_img + 5 = 13 positions: one page of 16
    assert cache[0]["page_table"].shape == (2, 1)
    assert not any(p.requires_grad for p in lm.parameters())


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
    stage = abstract["stages"][0]["b0_dense"]
    for name, s in (("mixer.wq", stage["mixer"]["wq"]),
                    ("mixer.wk", stage["mixer"]["wk"]),
                    ("mlp.wg", stage["mlp"]["wg"])):
        shapes = {tuple(state[f"layers.{i}.{name}"].shape)
                  for i in range(cfg.n_layers)}
        assert s.shape[0] == cfg.n_layers and shapes == {tuple(s.shape[1:])}


# -- paged decode at G 6 ----------------------------------------------------------

def _paged_inputs(b, kvh, g, dh, pages, page, pps, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, kvh, g, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.standard_normal((kvh, pages, page, dh)).astype(f),
            rng.integers(0, pages, (b, pps)).astype(np.int32),   # repeats
            rng.integers(1, page * pps + 1, (b,)).astype(np.int32))


@pytest.mark.parametrize("b,kvh,dh,pages,page,pps",
                         [(2, 8, 128, 12, 16, 3), (3, 2, 16, 8, 8, 4)])
def test_paged_plain_at_g6_equals_jax_kernel_and_oracle(b, kvh, dh, pages,
                                                        page, pps):
    ins = _paged_inputs(b, kvh, 6, dh, pages, page, pps)
    j_ins = list(map(jnp.asarray, ins))
    scale = 1 / dh ** 0.5
    want = [j_paged(*j_ins, interpret=True),
            j_paged_ref(*j_ins, scale=scale)]
    t_ins = list(map(_t, ins))
    before = launches["paged_decode"]
    for got in (paged_decode_attention(*t_ins),
                paged_decode_attention_ref(*t_ins, scale=scale)):
        assert got.shape == (b, kvh, 6, dh)
        for w in want:
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)
    assert launches["paged_decode"] == before          # CPU: no launch


def test_paged_kernel_shapes_take_g6_at_dh128_without_options():
    assert (128, 6) in paged_ops.SHAPES
    paged_ops.check_kernel_shape(128, 6)
    for dh, g, opts in ((64, 6, False), (128, 6, True), (256, 6, False)):
        with pytest.raises(ValueError, match="not supported"):
            paged_ops.check_kernel_shape(dh, g, options=opts)


# -- serving ------------------------------------------------------------------------

@pytest.mark.parametrize("images", [True, False])
def test_serve_cpu_decode_equals_teacher_forced_forward(images):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "19", "--gen", "3"],
                     images=images)
    cfg = get_smoke_config(ARCH)
    n_img = cfg.n_img_tokens if images else 0
    assert res.tokens.shape == (2, 4)
    assert res.logits.shape == (2, 4, cfg.vocab)
    assert (res.img_embeds is not None) == images
    assert not any(res.launches_prefill.values())      # CPU: plain versions
    assert not any(res.launches_decode.values())
    seq = torch.cat([res.prompts, res.tokens[:, :-1]], 1)
    hidden = transformer.forward(cfg, res.params, seq,
                                 img_embeds=res.img_embeds)
    tf = transformer.unembed_logits(cfg, res.params.embed,
                                    hidden[:, n_img + res.prompt_len - 1:])
    np.testing.assert_allclose(tf.float().numpy(), res.logits.float().numpy(),
                               **BF16_TOL)
    assert torch.equal(res.logits.argmax(-1), res.tokens)


def test_serve_images_only_for_a_vlm():
    with pytest.raises(ValueError, match="takes no images"):
        serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "4", "--gen", "1"],
                   images=True)
