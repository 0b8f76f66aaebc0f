"""repro_torch's training path against the JAX package, on the CPU.

The optimizer (``warmup_cosine``, ``clip_by_global_norm``, ``adamw_update``),
the token pipeline, flash attention's gradient (the backward kernel's
plain version and autograd through the wrapper), the loss and its
gradients, one ``make_train_step``, microbatches, the checkpointer and
the supervisor, each held to its JAX counterpart on the same numpy draws;
every arch's smoke config (whisper-base's encoder-decoder loss among
them) in float32 through ``models/convert.py``.  Tolerances are stated where they are used.
Each test runs torch on one thread: these shapes are tiny, and more
threads only wait on each other.
"""
import dataclasses
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import TokenPipeline as JTokenPipeline
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.zoo import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime.train import make_train_step as j_make_train_step
from repro_torch.checkpoint import CheckpointManager, Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import PipelineState, TokenPipeline
from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_lse)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.launch import train as train_cli
from repro_torch.models import convert, encdec, transformer
from repro_torch.models.zoo import Model
from repro_torch.optim import (AdamWConfig, adamw_update,
                               clip_by_global_norm, init_opt_state,
                               warmup_cosine)
from repro_torch.runtime.supervisor import SupervisorConfig, TrainSupervisor
from repro_torch.runtime.train import make_train_step

# float32 on both sides, summed in other orders: 1e-5 of the values
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# gradients of the loss sum many more terms (every position, every layer
# in backward): 1e-4 relative, with an atol of 1e-6 for entries near 0
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x, np.float32)


# -- the optimizer ------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total,floor", [(5, 40, 0.1), (0, 10, 0.0),
                                                (10, 10, 0.5)])
def test_warmup_cosine_equals_jax(warmup, total, floor):
    mine = warmup_cosine(3e-3, warmup, total, floor)
    theirs = j_warmup_cosine(3e-3, warmup, total, floor)
    for step in range(0, total + 5):
        # JAX computes in float32: its rounding, 2^-24 relative
        np.testing.assert_allclose(mine(step), float(theirs(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)
        assert mine(torch.tensor(step)) == mine(step)


def _grad_tree(seed, dtype, big=False):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    return {k: (rng.standard_normal(s) * (10.0 if big else 0.01)
                ).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_equals_jax(big, dtype):
    tree = _grad_tree(1, dtype, big)
    jt = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in tree.items()}
    tt = {k: _t(_np(v)).to(getattr(torch, dtype)) for k, v in jt.items()}
    jc, jn = j_clip(jt, 1.0)
    tc, tn = clip_by_global_norm(tt, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert (float(tn) > 1.0) == big
    for k in tree:
        assert tc[k].dtype == getattr(torch, dtype)
        # the float32 scale may round a bfloat16 value the other way: 1 ulp
        tol = F32_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
        np.testing.assert_allclose(tc[k].float().numpy(), _np(jc[k]), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_jax(dtype):
    """Three steps of AdamW from the same parameters and gradients: the
    parameters in their dtype, the moments float32, the step count."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = _grad_tree(2, dtype, big=True)
    jcfg = JAdamWConfig(lr=j_warmup_cosine(1e-2, 1, 10), weight_decay=0.1)
    cfg = AdamWConfig(lr=warmup_cosine(1e-2, 1, 10), weight_decay=0.1)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    tp = {k: _t(_np(v)).to(tdt) for k, v in jp.items()}
    js, ts = j_init_opt_state(jp), init_opt_state(tp)
    for i in range(3):
        g = {k: (np.random.default_rng(10 + i).standard_normal(v.shape)
                 ).astype(np.float32) for k, v in params.items()}
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        tg = {k: _t(_np(v)).to(tdt) for k, v in jg.items()}
        jp, js = j_adamw_update(jcfg, jp, jg, js)
        out_p, ts = adamw_update(cfg, tp, tg, ts)
        assert out_p is tp                  # updated in place
    assert int(ts["step"]) == int(js["step"]) == 3
    # float32 moments: 1e-6; the parameters: float32's sums, or one
    # bfloat16 rounding step of the float32 update
    ptol = dict(rtol=1e-5, atol=1e-7) if dtype == "float32" else dict(
        rtol=2 ** -7, atol=0)
    for k in params:
        assert tp[k].dtype == tdt and ts["m"][k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].float().numpy(), _np(jp[k]), **ptol)
        for mom in ("m", "v"):
            np.testing.assert_allclose(ts[mom][k].numpy(), _np(js[mom][k]),
                                       rtol=1e-6, atol=1e-12)


# -- the pipeline ------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 8, 0),
                                                  (128256, 64, 4, 3)])
def test_token_pipeline_equals_jax_bit_for_bit(vocab, seq, batch, seed):
    mine = TokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    theirs = JTokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch,
                            seed=seed)
    for i in (0, 1, 7):
        a, b = mine.batch(i), theirs.batch(i)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        parts = [mine.shard_batch(i, h, 2)["tokens"] for h in range(2)]
        assert np.array_equal(np.concatenate(parts), a["tokens"])
    assert PipelineState.from_json(PipelineState(5).to_json()).next_batch == 5


# -- flash attention's gradient ------------------------------------------------------

# B, KVH, G, S, T, causal, window, softcap, dh, q's scale
FLASH_CASES = [
    (1, 2, 3, 24, 24, True, 0, 0.0, 16, 1.0),
    (2, 1, 4, 16, 40, True, 0, 0.0, 16, 1.0),
    (1, 2, 2, 40, 16, True, 0, 0.0, 16, 1.0),
    (2, 2, 3, 24, 40, False, 0, 0.0, 16, 1.0),
    (1, 1, 1, 32, 32, False, 0, 0.0, 16, 1.0),
    # G 12 and 16 (the bf16 kernel's CTA walks the G heads), at lengths
    # that are no multiple of a block: 130 halves the JAX block to 2
    (1, 1, 12, 13, 13, True, 0, 0.0, 16, 1.0),
    (1, 2, 16, 9, 17, False, 0, 0.0, 16, 1.0),
    (2, 1, 12, 17, 7, True, 0, 0.0, 16, 1.0),
    (1, 1, 16, 1, 5, True, 0, 0.0, 16, 1.0),
    (1, 1, 12, 130, 16, False, 0, 0.0, 16, 1.0),
    (1, 1, 16, 16, 130, True, 0, 0.0, 16, 1.0),
    # a window (gemma2's local layers), causal and not, S != T
    (1, 2, 2, 40, 40, True, 8, 0.0, 16, 1.0),
    (2, 1, 3, 24, 40, False, 5, 0.0, 16, 1.0),
    (1, 2, 2, 17, 33, True, 1, 0.0, 16, 1.0),
    # a softcap where it bites: q scaled so that |scores| reach 3 x the cap
    (1, 2, 2, 24, 24, True, 0, 2.0, 16, 3.0),
    (2, 1, 3, 16, 40, False, 0, 1.5, 16, 3.0),
    # both (gemma2's local layers), and the softcap alone at dh 64
    (1, 2, 2, 33, 33, True, 6, 2.0, 16, 3.0),
    (1, 1, 2, 24, 24, True, 0, 3.0, 64, 2.0),
    # dh 64 (whisper): the encoder, the causal decoder, S != T cross
    (2, 2, 1, 24, 24, False, 0, 0.0, 64, 1.0),
    (1, 2, 1, 40, 40, True, 0, 0.0, 64, 1.0),
    (2, 1, 2, 40, 12, False, 0, 0.0, 64, 1.0),
    # rows that the window leaves no key (i >= T + window - 1, so S > T):
    # P = 1/T over every key, dV += dO / T, nothing to dQ or dK
    (1, 2, 2, 40, 16, True, 8, 0.0, 16, 1.0),
    (2, 1, 3, 30, 9, False, 4, 2.0, 16, 3.0),
    (1, 1, 2, 24, 5, True, 1, 0.0, 64, 1.0),
    # dh 256 (recurrentgemma-9b's local layers: MQA at G 16, a window),
    # windowed and not, rows without a key among them
    (1, 1, 16, 24, 24, True, 8, 0.0, 256, 1.0),
    (1, 1, 16, 17, 33, False, 0, 0.0, 256, 1.0),
    (2, 1, 2, 40, 40, True, 16, 0.0, 256, 1.0),
    (1, 1, 16, 30, 9, True, 4, 0.0, 256, 1.0)]


def _flash_inputs(b, kvh, g, s, t, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, kvh, g, s, dh)).astype(f),
            rng.standard_normal((b, kvh, t, dh)).astype(f),
            rng.standard_normal((b, kvh, t, dh)).astype(f),
            rng.standard_normal((b, kvh, g, s, dh)).astype(f))


@pytest.mark.parametrize("b,kvh,g,s,t,causal,window,softcap,dh,qs",
                         FLASH_CASES)
def test_flash_backward_equals_jax_vjp(b, kvh, g, s, t, causal, window,
                                       softcap, dh, qs):
    """dq, dk, dv of the JAX flash attention (the Pallas forward in
    interpret mode, its custom_vjp's recompute) against the backward's
    plain version on the forward's out and lse, and against autograd
    through the port's wrapper (CPU: the plain forward), float32."""
    q, k, v, do = _flash_inputs(b, kvh, g, s, t, dh)
    q = q * np.float32(qs)
    scale = dh ** -0.5
    opts = dict(causal=causal, window=window, softcap=softcap)
    out, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, interpret=True,
                                               **opts),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o, lse = flash_attention_lse(tq, tk, tv, **opts)
    np.testing.assert_allclose(o.numpy(), _np(out), **F32_TOL)
    before = launches["flash_attention_bwd"]
    got = flash_attention_bwd(tq, tk, tv, o, lse, tdo, scale=scale, **opts)
    ref = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, scale=scale,
                                  **opts)
    assert launches["flash_attention_bwd"] == before   # CPU: no launch
    xq, xk, xv = (x.clone().requires_grad_() for x in (tq, tk, tv))
    auto = torch.autograd.grad(flash_attention(xq, xk, xv, **opts),
                               (xq, xk, xv), tdo)
    for mine in (got, ref, auto):
        for a, w in zip(mine, want):
            np.testing.assert_allclose(a.numpy(), _np(w), **F32_TOL)
    if softcap:      # the cap bites: some score at least 2 x the cap
        raw = torch.einsum("bhgqd,bhtd->bhgqt", tq, tk) * scale
        assert float(raw.abs().max()) > 2 * softcap


def test_flash_backward_rows_without_keys_follow_the_jax_vjp():
    """A row that the window leaves no key takes V's mean in the forward;
    its gradient gives each key's dV dO / T and dQ nothing, as the JAX
    vjp does (the plain version does not read P = exp(s - lse) there: its
    lse, -1e30 + ln T, rounds to -1e30 in float32, which would give P = 1
    and dV off by a factor of T)."""
    q, k, v, do = map(_t, _flash_inputs(1, 1, 1, 12, 4))
    opts = dict(causal=True, window=2, softcap=0.0)
    o, lse = flash_attention_lse(q, k, v, **opts)
    empty = torch.arange(12) >= 4 + 2 - 1
    assert bool((lse[..., empty] == -1e30).all())
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, scale=0.25,
                                     **opts)
    assert bool((dq[..., empty, :] == 0).all())
    seen = flash_attention_bwd(q[..., ~empty, :], k, v, o[..., ~empty, :],
                               lse[..., ~empty], do[..., ~empty, :],
                               scale=0.25, **opts)
    torch.testing.assert_close(dk, seen[1])
    torch.testing.assert_close(
        dv, seen[2] + do[..., empty, :].sum((2, 3))[:, :, None] / 4)


def test_flash_forward_lse_is_the_logsumexp_of_the_masked_scores():
    q, k, v, _ = _flash_inputs(1, 2, 2, 20, 20)
    tq, tk, tv = map(_t, (q, k, v))
    out, lse = flash_attention_ref(tq, tk, tv, scale=0.25, return_lse=True)
    s = torch.einsum("bhgqd,bhtd->bhgqt", tq, tk) * 0.25
    s = s.masked_fill(torch.ones(20, 20).triu(1).bool(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    torch.testing.assert_close(out, flash_attention_ref(tq, tk, tv,
                                                        scale=0.25))


# -- the loss, its gradients and the train step ----------------------------------------

ARCHS = ("llama3-8b", "internvl2-26b", "falcon-mamba-7b", "deepseek-v2-236b",
         "gemma2-27b", "chatglm3-6b", "starcoder2-15b", "recurrentgemma-9b",
         "kimi-k2-1t-a32b", "whisper-base")


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(j_get_smoke_config(arch), dtype="float32",
                                **kw))


def _model_params(jcfg, seed=0):
    """A JAX ``Model.init`` tree (float32 numpy), the stacked matrices
    redrawn at 1/sqrt(fan_in of one layer), the norm scales moved by
    noise so that they matter."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        stacked = path[0].key in ("stages", "enc", "dec")
        if stacked and v.ndim >= 3:
            v = rng.standard_normal(v.shape) / np.sqrt(v.shape[1])
        elif v.ndim == 1 or (stacked and v.ndim == 2):
            v = v + 0.1 * rng.standard_normal(v.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, JModel(jcfg).init(jax.random.PRNGKey(seed)))


def _port_lm(cfg, tree):
    net = encdec.EncDec if cfg.family == "audio" else transformer.LM
    lm = net(cfg, device="cpu", dtype=torch.float32)
    lm.load_state_dict(convert.params_from_jax(cfg, tree))
    return lm.requires_grad_(True)


def _batch(cfg, b=2, s=24, seed=0, images=True):
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=s, global_batch=b,
                         seed=seed)
    batch = dict(pipe.batch(0))
    if cfg.family == "vlm" and images:
        batch["img_embeds"] = np.random.default_rng(seed).standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":     # the stub frontend's frame embeddings
        batch["frames"] = np.random.default_rng(seed).standard_normal(
            (b, s // cfg.frame_ratio, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_equal_jax(arch, remat):
    cfg, jcfg = _cfgs(arch, remat=remat)
    tree = _model_params(jcfg)
    lm = _port_lm(cfg, tree)
    batch = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, {k: jnp.asarray(v)
                                        for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, tree))
    loss = Model(cfg).loss(lm, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **F32_TOL)
    params = dict(lm.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    want = convert.params_from_jax(cfg, jax.tree.map(_np, jgrads))
    assert want.keys() == params.keys()
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_lm_loss_scores_text_positions_only():
    cfg, _ = _cfgs("internvl2-26b")
    lm = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    b = {k: _t(v) for k, v in _batch(cfg).items()}
    hidden = transformer.forward(cfg, lm, b["tokens"],
                                 img_embeds=b["img_embeds"])
    want = transformer.chunked_xent(cfg, lm, hidden[:, cfg.n_img_tokens:],
                                    b["labels"])
    torch.testing.assert_close(transformer.lm_loss(cfg, lm, b), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_jax(arch):
    """One step: loss, grad_norm, step, the updated parameters and both
    moments against the JAX ``make_train_step`` (clipping at 1.0 bites:
    the gradient's norm passes it)."""
    cfg, jcfg = _cfgs(arch)
    tree = _model_params(jcfg)
    lm = _port_lm(cfg, tree)
    batch = _batch(cfg)
    # eps 1e-6 (both sides): a first Adam step is lr g / (|g| + eps), and
    # at the default 1e-8 a gradient entry of ~1e-8 (a few of 10^4 here)
    # turns a 1e-9 difference in g into a visible one in the step
    jopt_cfg = JAdamWConfig(lr=1e-2, eps=1e-6, grad_clip=0.5)
    jp = jax.tree.map(jnp.asarray, tree)
    jp, js, jm = jax.jit(j_make_train_step(JModel(jcfg), jopt_cfg))(
        jp, j_init_opt_state(jp), {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    step = make_train_step(Model(cfg), AdamWConfig(lr=1e-2, eps=1e-6,
                                                   grad_clip=0.5))
    params = dict(lm.named_parameters())
    _, ts, m = step(lm, init_opt_state(params),
                    {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **F32_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert float(m["grad_norm"]) > 0.5
    assert int(m["step"]) == int(jm["step"]) == 1
    # the moments hold g / 10 and g^2 / 20: GRAD_TOL's rtol (twice, for
    # the square); the first step moves a parameter by lr g / (|g| + eps)
    # (+ weight decay), which follows g's last digits where |g| is near
    # eps: the parameters are held at lr / 100 absolute
    for got, want, tol in ((ts["m"], js["m"], dict(rtol=1e-4, atol=1e-7)),
                           (ts["v"], js["v"], dict(rtol=2e-4, atol=1e-12)),
                           (params, jp, dict(rtol=1e-5, atol=1e-4))):
        want = convert.params_from_jax(cfg, jax.tree.map(_np, want))
        for k, t in got.items():
            np.testing.assert_allclose(t.detach().numpy(), want[k].numpy(),
                                       err_msg=k, **tol)


def test_microbatched_step_matches_full_batch():
    """Gradient accumulation over 2 microbatches: the same loss, parameters
    and moments as the full batch (float32, as tests/test_system.py:38)."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32", remat="none")
    model = Model(cfg)
    batch = {k: _t(v) for k, v in TokenPipeline(
        vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0).batch(0).items()}
    out = []
    for mb in (1, 2):
        lm = model.init(torch.Generator().manual_seed(0), "cpu",
                        trainable=True)
        opt = init_opt_state(dict(lm.named_parameters()))
        _, opt, m = make_train_step(model, AdamWConfig(lr=1e-3),
                                    microbatches=mb)(lm, opt, batch)
        out.append((float(m["loss"]), dict(lm.named_parameters()), opt))
    assert np.isclose(out[0][0], out[1][0], rtol=1e-5)
    for k, p in out[0][1].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   out[1][1][k].detach().numpy(),
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(out[0][2]["m"][k].numpy(),
                                   out[1][2]["m"][k].numpy(),
                                   rtol=1e-3, atol=1e-8)


def test_train_loss_decreases():
    """A tiny LM learns the synthetic bigram structure within 30 steps (as
    tests/test_system.py:19, which takes 40)."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32", remat="none")
    model = Model(cfg)
    lm = model.init(torch.Generator().manual_seed(0), "cpu", trainable=True)
    opt = init_opt_state(dict(lm.named_parameters()))
    step = make_train_step(model, AdamWConfig(
        lr=warmup_cosine(3e-3, warmup=5, total=30), weight_decay=0.0))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    losses = []
    for i in range(30):
        _, opt, m = step(lm, opt, {k: _t(v) for k, v in pipe.batch(i).items()})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses


def test_params_train_only_when_asked_and_serving_builds_no_graph():
    cfg, _ = _cfgs("llama3-8b")
    model = Model(cfg)
    frozen = model.init(torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    lm = model.init(torch.Generator().manual_seed(0), "cpu", trainable=True)
    assert all(p.requires_grad for p in lm.parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (2, 8)))
    logits, cache = model.prefill(lm, toks, max_len=10)
    assert not logits.requires_grad
    logits, cache = model.decode_step(lm, cache, toks[:, :1], 8)
    assert not logits.requires_grad
    assert not any(t.requires_grad for c in cache for t in c.values())


def test_hopper_gather_refuses_a_gradient():
    cfg, _ = _cfgs("llama3-8b")
    lm = Model(cfg).init(torch.Generator().manual_seed(0), "cpu",
                         trainable=True)
    b = {k: _t(v) for k, v in _batch(cfg).items()}
    with pytest.raises(NotImplementedError, match="no backward"):
        transformer.lm_loss(cfg, lm, b, gs_backend="hopper")


# -- checkpointing ------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "h": torch.randn(6, generator=g).to(torch.bfloat16)},
            "opt": {"m": [torch.randn(3, generator=g)],
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v) for v in tree]
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_checkpoint_roundtrip_bf16_without_ml_dtypes(tmp_path):
    import repro_torch.checkpoint.checkpointer as mod
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(7, t)
    assert ck.latest_step() == 7
    back = ck.restore(7, _like(t))
    for a, b in zip(_leaves(t), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(mod.__file__) as f:
        assert "ml_dtypes" not in f.read().split('"""')[-1]   # the code


def test_checkpoint_reads_the_jax_layout(tmp_path):
    """A bfloat16 leaf the JAX checkpointer wrote (its raw 16-bit words,
    the dtype named in the manifest) restores bit for bit, and back."""
    w = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    JCheckpointer(str(tmp_path)).save(3, {"w": jnp.asarray(w, jnp.bfloat16),
                                          "n": jnp.int32(5)})
    back = Checkpointer(str(tmp_path)).restore(3, {
        "w": torch.zeros(4, 3, dtype=torch.bfloat16),
        "n": torch.tensor(0, dtype=torch.int32)})
    assert torch.equal(back["w"], torch.from_numpy(w).to(torch.bfloat16))
    assert int(back["n"]) == 5
    Checkpointer(str(tmp_path)).save(4, back)
    jback = JCheckpointer(str(tmp_path)).restore(4, {
        "w": jax.ShapeDtypeStruct((4, 3), jnp.bfloat16),
        "n": jax.ShapeDtypeStruct((), jnp.int32)})
    assert np.array_equal(_np(jback["w"]), back["w"].float().numpy())


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_checkpoint_shape_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(1, {"w": torch.zeros(5)})
    with pytest.raises(KeyError, match="missing"):
        ck.restore(1, {"x": torch.zeros(4)})


def test_manager_async_and_prune(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (10, 20, 30):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    assert mgr.latest_step() == 30
    steps = sorted(int(d[5:]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [20, 30]
    back = mgr.restore(30, _like(_tree()))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(_tree(30)),
                                                  _leaves(back)))
    mgr.close()


# -- the supervisor -----------------------------------------------------------------

def test_supervisor_crash_restart(tmp_path):
    crashed = {"done": False}

    def build(ckpt):
        start = ckpt.latest_step() or 0
        state = {"x": torch.tensor(float(start))}
        if start:
            state = ckpt.restore(start, state)

        def step_fn(state, i):
            if i == 7 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("simulated node failure")
            return {"x": state["x"] + 1}, {"loss": float(state["x"])}

        return state, step_fn, start

    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=5, max_restarts=2))
    state = sup.run(build, 12)
    # crash at 7 -> restart from ckpt step 5 -> steps 5..11 rerun
    assert crashed["done"]
    assert float(state["x"]) == 12.0
    sup.ckpt.close()


def test_supervisor_straggler_detection(tmp_path):
    def build(ckpt):
        def step_fn(state, i):
            time.sleep(0.25 if i == 8 else 0.01)
            return state, {"loss": 1.0}
        return {}, step_fn, 0

    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=100,
                                           straggler_factor=5.0))
    sup.run(build, 10)
    assert 8 in sup.straggler_events
    sup.ckpt.close()


def test_supervisor_checkpoints_on_sigterm(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install on the main thread only")

    def build(ckpt):
        def step_fn(state, i):
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return {"x": state["x"] + 1}, {"loss": 0.0}
        return {"x": torch.tensor(0.0)}, step_fn, 0

    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=100))
    old = signal.getsignal(signal.SIGTERM)
    try:
        state = sup.run(build, 10)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert float(state["x"]) == 4.0 and sup.ckpt.latest_step() == 4
    sup.ckpt.close()


def test_supervisor_gives_back_sigterm_and_its_state(tmp_path):
    """When ``run`` returns, SIGTERM has the handler it had before, and
    nothing of the supervisor still holds the run's state (a finished
    run's model would otherwise stay in device memory)."""
    import weakref
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install on the main thread only")
    held = []

    def build(ckpt):
        state = {"w": torch.zeros(4)}
        held.append(weakref.ref(state["w"]))
        return state, lambda state, i: (state, {"loss": 0.0}), 0

    before = signal.getsignal(signal.SIGTERM)
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=100))
    sup.run(build, 3)
    assert signal.getsignal(signal.SIGTERM) is before
    import gc
    gc.collect()
    assert held[0]() is None
    sup.ckpt.close()


# -- the driver and the demo ---------------------------------------------------------

def test_train_cli_restarts_from_its_checkpoint(tmp_path):
    """``launch.train`` twice on one checkpoint directory: the second run
    restores the first's last checkpoint and runs only the steps after
    it, with the loss continuing."""
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--batch",
            "4", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "4"]
    first = train_cli.main(argv + ["--steps", "8"])
    assert [s.step for s in first.stats] == list(range(8))
    assert not any(first.launches.values())            # CPU: plain versions
    second = train_cli.main(argv + ["--steps", "12"])
    assert [s.step for s in second.stats] == list(range(8, 12))
    assert all(np.isfinite(s.loss) for s in second.stats)
    assert second.stats[0].loss < first.stats[0].loss


def test_ft_demo_restores_and_learns():
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_ft_demo_torch.py")
    spec = importlib.util.spec_from_file_location("train_ft_demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    sup, crash = demo.main(["--device", "cpu"])
    # step 20's checkpoint, or step 10's while 20's async write is in flight
    assert crash["restored_from"] in (10, 20) and not crash["armed"]
    assert len(sup.stats) == (demo.STEPS + demo.CRASH_AT
                              - crash["restored_from"])
