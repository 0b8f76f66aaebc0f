"""repro_torch's whisper-base (the ``audio`` family, ``models/encdec.py``)
against the JAX package, on the CPU.

The same numpy weights (a JAX ``Model.init`` tree carried across by
``convert``), frames and tokens go through both packages: the sinusoidal
positions, the encoder (flash attention, not causal), the teacher-forced
decoder (causal self-attention, cross-attention over the encoder states
with S != T), the prefill's cross K/V, and iterated ``decode_step`` logits
and caches against the JAX ``encdec_decode_step``.  The smoke config (2 +
2 layers, d_model 64, 4 heads over 4 KV heads, dh 16) runs in float32 at
1e-5, where the two sides differ only in summation order and their
float32 sin, cos and exp, and in bfloat16 at a tolerance stated there.
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
from repro.models import encdec as j_encdec
from repro.models.zoo import Model as JModel
from repro.models.zoo import count_params as j_count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import serve
from repro_torch.models import convert, encdec
from repro_torch.models.zoo import Model, count_params

ROOT = Path(__file__).resolve().parent.parent
ARCH = "whisper-base"
WHISPER_BASE_PARAMS = 97_166_336
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 keeps 8 significant bits (u = 2^-8): the two frameworks round
# the residual stream, the positions and the MLP at different places, so
# values of magnitude up to ~4 may differ by a few roundings; held at 8 u
BF16_TOL = dict(rtol=2 ** -5, atol=2 ** -5)


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def _j_cfg(dtype="float32"):
    return dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _params(jcfg, dtype, seed=0):
    """A JAX ``Model.init`` tree with numpy leaves of the JAX dtype, the
    stacked matrices redrawn at 1/sqrt(fan_in of one layer) and the norm
    scales moved by noise so that they matter."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        stacked = path[0].key in ("enc", "dec")
        if stacked and v.ndim >= 3:
            v = rng.standard_normal(v.shape) / np.sqrt(v.shape[1])
        elif v.ndim == 1 or (stacked and v.ndim == 2):
            v = v + 0.1 * rng.standard_normal(v.shape)
        return np.asarray(jnp.asarray(v.astype(np.float32), dtype))
    return jax.tree_util.tree_map_with_path(
        leaf, JModel(jcfg).init(jax.random.PRNGKey(seed)))


def _port(cfg, tree, dtype):
    net = encdec.EncDec(cfg, device="cpu", dtype=dtype)
    net.load_state_dict(convert.params_from_jax(cfg, tree))
    return net


def _frames(cfg, b, f, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (b, f, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b, s, seed=4):
    return np.random.default_rng(seed).integers(2, cfg.vocab, (b, s))


# -- the config and the positions ----------------------------------------------------

def test_configs_equal_the_jax_configs_field_for_field():
    for mine, theirs in ((get_config(ARCH), j_get_config(ARCH)),
                         (get_smoke_config(ARCH), j_get_smoke_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_heads // cfg.n_kv_heads, cfg.dh,
            cfg.rope) == ("audio", 1, 64, "none")


@pytest.mark.parametrize("d", [16, 64, 512])
def test_sinusoidal_equals_jax(d):
    pos = np.arange(0, 1500, 7, dtype=np.int32)     # whisper's frames
    want = np.asarray(j_encdec.sinusoidal(jnp.asarray(pos), d))
    got = encdec.sinusoidal(_t(pos), d)
    assert got.dtype == torch.float32 and got.shape == (len(pos), d)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    # the two sides' float32 exp may round a frequency one ulp apart, which
    # moves an angle below 1500 by up to about one ulp of it (2^-13 =
    # 1.2e-4 in [1024, 2048)); sin and cos move by as much: held at 2 ulps
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 ** -12)


# -- flash attention at whisper's heads, S != T ----------------------------------------

# (B, KVH, G, S, T, dh): the encoder's S = T and the cross-attention's
# tokens against frames, not causal
CROSS_CASES = [(2, 2, 1, 8, 60, 64), (1, 3, 1, 1, 48, 64),
               (2, 2, 1, 33, 40, 16), (1, 2, 1, 60, 60, 64)]


@pytest.mark.parametrize("b,kvh,g,s,t,dh", CROSS_CASES)
def test_flash_plain_not_causal_s_ne_t_equals_jax(b, kvh, g, s, t, dh):
    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((b, kvh, g, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, kvh, t, dh)).astype(np.float32)
    scale = 1 / dh ** 0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = [j_flash(jq, jk, jv, causal=False, block_q=32, block_k=32,
                    interpret=True),
            j_flash_ref(jq, jk, jv, scale=scale, causal=False)]
    before = launches["flash_attention"]
    for got in (flash_attention(_t(q), _t(k), _t(v), causal=False),
                flash_attention_ref(_t(q), _t(k), _t(v), scale=scale,
                                    causal=False)):
        assert got.shape == q.shape
        for w in want:
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)
    assert launches["flash_attention"] == before     # CPU: no kernel launch


# -- the encoder and the teacher-forced decoder -------------------------------------

def test_encode_equals_jax():
    cfg, jcfg = _cfg(), _j_cfg()
    tree = _params(jcfg, jnp.float32)
    net = _port(cfg, tree, torch.float32)
    frames = _frames(cfg, 2, 37)      # no multiple of the 16-query chunk
    want = j_encdec.encode(jcfg, jax.tree.map(jnp.asarray, tree),
                           jnp.asarray(frames))
    got = encdec.encode(cfg, net, _t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_decode_train_equals_jax(backend):
    cfg, jcfg = _cfg(), _j_cfg()
    tree = _params(jcfg, jnp.float32, seed=1)
    jtree = jax.tree.map(jnp.asarray, tree)
    net = _port(cfg, tree, torch.float32)
    frames, toks = _frames(cfg, 2, 24), _tokens(cfg, 2, 19)
    enc = j_encdec.encode(jcfg, jtree, jnp.asarray(frames))
    want = j_encdec.decode_train(jcfg, jtree, jnp.asarray(toks, jnp.int32),
                                 enc)
    got = encdec.decode_train(cfg, net, _t(toks),
                              encdec.encode(cfg, net, _t(frames)), backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    fwd = Model(cfg).forward(net, _t(toks), frames=_t(frames))
    assert torch.equal(fwd, got)


# -- serving: the cross cache and decode ---------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_cross_then_decode_equals_jax(dtype, tol):
    """The port's prefill (frames only) and 5 decode steps from BOS against
    the JAX Model.prefill and encdec_decode_step: the cross K/V, each
    step's logits and the self-attention cache, carried both ways."""
    cfg, jcfg = _cfg(dtype), _j_cfg(dtype)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    tree = _params(jcfg, jdtype, seed=2)
    jtree = jax.tree.map(jnp.asarray, tree)
    net = _port(cfg, tree, tdtype)
    b, n_frames, gen, max_len = 2, 20, 5, 12
    frames = _frames(cfg, b, n_frames)
    toks = np.concatenate([np.ones((b, 1), np.int64),
                           _tokens(cfg, b, gen - 1)], 1)   # BOS first

    jm, model = JModel(jcfg), Model(cfg)
    none, jcache = jm.prefill(jtree, {"frames": jnp.asarray(frames, jdtype),
                                      "max_len": max_len})
    assert none is None
    jcross = {k: np.asarray(jcache[k], np.float32)
              for k in ("cross_k", "cross_v")}
    jlogits = []
    step = jax.jit(jm.decode_step)
    for t in range(gen):
        lg, jcache = step(jtree, jcache,
                          jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t))
        jlogits.append(np.asarray(lg, np.float32))
    jcache = jax.tree.map(lambda v: np.asarray(v, np.float32), jcache)

    none, cache = model.prefill(net, _t(frames).to(tdtype), max_len=max_len,
                                seed=3)
    assert none is None and len(cache) == cfg.n_layers
    back = convert.cache_to_jax(cfg, cache, max_len)
    for k in ("cross_k", "cross_v"):
        assert back[k].shape == (cfg.n_layers, b, n_frames, cfg.n_kv_heads,
                                 cfg.dh)
        np.testing.assert_allclose(back[k], jcross[k], **tol)
    got = []
    for t in range(gen):
        logits, cache = model.decode_step(net, cache, _t(toks[:, t:t + 1]), t)
        assert logits.dtype == tdtype and logits.shape == (b, cfg.vocab)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).float().numpy(),
                               np.stack(jlogits, 1), **tol)
    back = convert.cache_to_jax(cfg, cache, max_len)
    for k in ("self_k", "self_v", "cross_k", "cross_v"):
        assert back[k].shape == jcache[k].shape
        np.testing.assert_allclose(back[k], jcache[k], **tol)
    again = convert.cache_to_jax(cfg, convert.cache_from_jax(cfg, back),
                                 max_len)
    for k in back:
        np.testing.assert_array_equal(again[k], back[k])


def test_decode_steps_equal_the_teacher_forced_decoder():
    """Iterated decode_step over a token sequence gives the teacher-forced
    decoder's logits at every position (float32, the port alone)."""
    cfg, jcfg = _cfg(), _j_cfg()
    net = _port(cfg, _params(jcfg, jnp.float32, seed=6), torch.float32)
    frames, toks = _t(_frames(cfg, 3, 16)), _t(_tokens(cfg, 3, 7))
    model = Model(cfg)
    _, cache = model.prefill(net, frames, max_len=7)
    steps = []
    for t in range(7):
        logits, cache = model.decode_step(net, cache, toks[:, t:t + 1], t)
        steps.append(logits)
    hidden = model.forward(net, toks, frames=frames)
    want = encdec.unembed_logits(cfg, net.embed, hidden)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), want.numpy(),
                               **F32_TOL)


# -- the weights and the count -------------------------------------------------------

def test_full_width_params_convert_and_count():
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    assert count_params(cfg) == WHISPER_BASE_PARAMS == j_count_params(jcfg)
    abstract = JModel(jcfg).abstract_params()
    state = convert.params_from_jax(
        cfg, jax.tree.map(lambda s: np.zeros(s.shape, np.float32), abstract))
    meta = encdec.EncDec(cfg, device="meta").state_dict()
    assert state.keys() == meta.keys()
    assert all(state[k].shape == meta[k].shape for k in meta)
    assert sum(t.numel() for t in state.values()) == WHISPER_BASE_PARAMS
    assert len([k for k in meta if k.endswith("cross_attn.wq")]) == 6


def test_prefill_needs_max_len():
    cfg = _cfg()
    net = encdec.EncDec(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="max_len"):
        Model(cfg).prefill(net, torch.zeros(1, 4, cfg.d_model))


# -- the serve driver --------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_serve_cpu_starts_from_bos_and_matches_the_teacher_forced_pass(
        backend):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "24", "--gen", "4",
                      "--gs-backend", backend])
    cfg = get_smoke_config(ARCH)
    assert res.tokens.shape == (2, 5) and (res.tokens[:, 0] == 1).all()
    assert res.logits.shape == (2, 4, cfg.vocab)
    assert not any(res.launches_prefill.values())      # CPU: plain versions
    assert not any(res.launches_decode.values())
    assert torch.isfinite(res.logits.float()).all()
    assert torch.equal(res.logits.argmax(-1), res.tokens[:, 1:])
    # the frames the driver drew: after the prompts, from the same seed
    rng = np.random.default_rng(0)
    rng.integers(2, cfg.vocab, (2, 24))
    frames = torch.from_numpy(0.01 * rng.standard_normal(
        (2, 24 // cfg.frame_ratio, cfg.d_model))).to(torch.bfloat16)
    hidden = res.model.forward(res.params, res.tokens[:, :-1], frames=frames)
    tf = encdec.unembed_logits(cfg, res.params.embed, hidden)
    np.testing.assert_allclose(tf.float().numpy(), res.logits.float().numpy(),
                               **BF16_TOL)


def test_serve_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None runs on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_new_modules_import_no_jax():
    code = ("import sys; import repro_torch.models.encdec, "
            "repro_torch.models.zoo, repro_torch.launch.serve, "
            "repro_torch.configs.whisper_base, "
            "repro_torch.configs.kimi_k2_1t_a32b; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'triton')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
