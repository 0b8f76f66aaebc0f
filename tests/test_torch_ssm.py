"""repro_torch's Mamba serving path against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its port: the
selective scan (the JAX Pallas kernel in interpret mode and its oracle
against the port's plain version and wrapper), the mixer's prefill and
decode, and the whole model's forward, prefill and decode with their
caches.  The smoke config (2 layers, d_model 64, N 8) runs in float32 at
1e-5 (the two sides differ only in summation order), and once in bfloat16
at a tolerance stated there.
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
from repro.kernels.selective_scan import selective_scan as j_selective_scan
from repro.kernels.selective_scan.ref import (
    selective_scan_ref as j_selective_scan_ref)
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.models.common import abstract_tree
from repro.models.zoo import Model as JModel
from repro.models.zoo import count_params as j_count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import launches
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch import serve
from repro_torch.models import convert, ssm, transformer
from repro_torch.models.zoo import Model, count_params

ROOT = Path(__file__).resolve().parent.parent
ARCH = "falcon-mamba-7b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# (B, L, D, N): the four shapes of the JAX package's own scan test, and a
# ragged L that is no multiple of any block
SCAN_SHAPES = [(2, 32, 16, 8), (1, 64, 32, 16), (2, 128, 8, 4),
               (1, 48, 16, 8), (2, 33, 16, 8)]


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def _j_cfg(dtype="float32"):
    return dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype)


def _scan_inputs(b, l, d, n, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, l, d)).astype(f),
            (np.abs(rng.standard_normal((b, l, d))) * 0.1).astype(f),
            rng.standard_normal((b, l, n)).astype(f),
            rng.standard_normal((b, l, n)).astype(f),
            -np.abs(rng.standard_normal((n, d))).astype(f),
            rng.standard_normal((1, d)).astype(f))


# -- the selective scan ---------------------------------------------------------

@pytest.mark.parametrize("b,l,d,n", SCAN_SHAPES)
def test_scan_plain_equals_jax_kernel_and_oracle(b, l, d, n):
    ins = _scan_inputs(b, l, d, n)
    jy, jh = j_selective_scan(*map(jnp.asarray, ins), interpret=True)
    ry, rh = j_selective_scan_ref(*map(jnp.asarray, ins))
    t_ins = [torch.from_numpy(x) for x in ins]
    before = launches["selective_scan"]
    for fn in (selective_scan_ref, selective_scan):
        y, h = fn(*t_ins)
        assert y.dtype == torch.float32 and h.shape == (b, n, d)
        for want_y, want_h in ((jy, jh), (ry, rh)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                       **F32_TOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                       **F32_TOL)
    assert launches["selective_scan"] == before     # CPU: no kernel launch


def test_scan_wrapper_rejects_what_the_kernel_does_not_take():
    ins = [torch.from_numpy(x) for x in _scan_inputs(1, 5, 16, 8)]
    u, dt, b, c, a, dsk = ins
    with pytest.raises(ValueError, match="state size"):
        selective_scan(u, dt, b[..., :3].contiguous(), c[..., :3].contiguous(),
                       a[:3].contiguous(), dsk)
    with pytest.raises(TypeError, match="bfloat16"):
        selective_scan(u.double(), dt, b, c, a, dsk)
    with pytest.raises(TypeError):
        selective_scan(u, dt.bfloat16(), b, c, a, dsk)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.cat([b, c], -1)
        selective_scan(u, dt, wide[..., :8], c, a, dsk)
    with pytest.raises(ValueError, match="shape"):
        selective_scan(u, dt, b, c, a.T.contiguous(), dsk)


def test_scan_bfloat16_rounds_y_once():
    ins = [torch.from_numpy(x) for x in _scan_inputs(2, 20, 16, 16)]
    lo = [t.bfloat16() if i < 4 else t for i, t in enumerate(ins)]
    y, h = selective_scan(*lo)
    y32, h32 = selective_scan_ref(*[t.float() for t in lo])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y32.bfloat16())
    assert torch.equal(h, h32)


# -- the mixer -------------------------------------------------------------------

def _mixer_params(cfg, seed=0):
    """Random numpy leaves for every mixer parameter (zeros/ones leaves too,
    so that a_log, dt_bias, conv_b and d_skip matter)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in abstract_tree(j_ssm.mamba_defs(cfg), jnp.float32).items():
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) > 1 else 0.5
        out[k] = (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return out


def _port_mixer(cfg, np_params):
    m = ssm.Mamba(cfg, device="cpu", dtype=torch.float32)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in np_params.items()})
    return m


def test_mixer_prefill_equals_jax_and_its_cache_the_iterated_decode():
    cfg, jcfg = _cfg(), _j_cfg()
    npp = _mixer_params(jcfg)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    y, cache = ssm.mamba_prefill(cfg, _port_mixer(cfg, npp),
                                 torch.from_numpy(x))
    for use_kernel in (False, True):
        want = j_ssm.mamba_apply(jcfg, jp, jnp.asarray(x),
                                 use_scan_kernel=use_kernel)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **F32_TOL)
    jc = j_ssm.mamba_init_cache(jcfg, 2, jnp.float32)
    for t in range(x.shape[1]):
        _, jc = j_ssm.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc)
    assert cache["ssm"].shape == (2, 2 * cfg.d_model, cfg.ssm_state)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                   **F32_TOL)


def test_mixer_decode_equals_jax():
    cfg, jcfg = _cfg(), _j_cfg()
    npp = _mixer_params(jcfg, seed=2)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    m = _port_mixer(cfg, npp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal(
        (3, cfg.ssm_conv - 1, 2 * cfg.d_model)).astype(np.float32)
    h = rng.standard_normal(
        (3, 2 * cfg.d_model, cfg.ssm_state)).astype(np.float32)
    out, c = ssm.mamba_decode(cfg, m, torch.from_numpy(x),
                              {"conv": torch.from_numpy(conv),
                               "ssm": torch.from_numpy(h)})
    jout, jc = j_ssm.mamba_decode(jcfg, jp, jnp.asarray(x),
                                  {"conv": jnp.asarray(conv),
                                   "ssm": jnp.asarray(h)})
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]),
                                   **F32_TOL)


# -- the model ---------------------------------------------------------------------

def _model_params(jcfg, dtype, seed=0):
    """A JAX ``Model.init`` tree with numpy leaves of the JAX dtype.

    JAX's ``init_tree`` takes a stacked leaf's fan-in from its layer axis,
    so its matrices come out at 1/sqrt(n_layers); these are redrawn at
    1/sqrt(fan_in of one layer), as the port draws them, which keeps the
    smoke model's states near 1 and the bfloat16 case well conditioned.
    Zeros/ones leaves are moved by noise so that they matter.
    """
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        stacked = path[0].key == "stages"
        if stacked and v.ndim == 3:
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
    toks = _tokens(cfg, 2, 16)
    jh, _ = j_tf.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                         jnp.asarray(toks, jnp.int32))
    want = j_tf.unembed_logits(jcfg, jax.tree.map(jnp.asarray,
                                                  tree["embed"]), jh)
    hidden = transformer.forward(cfg, lm, torch.from_numpy(toks))
    got = transformer.unembed_logits(cfg, lm.embed, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _prefill_decode_vs_jax(dtype, jdtype, tol):
    """Port prefill of 8 tokens + decode x 4 against JAX decode_step
    iterated from init_cache over the same 12 tokens: logits and cache."""
    cfg, jcfg = _cfg(dtype), _j_cfg(dtype)
    tree = _model_params(jcfg, jdtype)
    jtree = jax.tree.map(jnp.asarray, tree)
    tdtype = getattr(torch, dtype)
    lm = _port_lm(cfg, tree, tdtype)
    jm, model = JModel(jcfg), Model(cfg)
    plen, gen, b = 8, 4, 2
    toks = _tokens(cfg, b, plen + gen)
    jcache = jm.init_cache(b, plen + gen)
    jlogits = []
    step = jax.jit(jm.decode_step)
    for t in range(plen + gen):
        lg, jcache = step(jtree, jcache,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.int32(t))
        jlogits.append(np.asarray(lg, np.float32))
        if t == plen - 1:
            jcache_prompt = jax.tree.map(lambda v: np.asarray(v, np.float32),
                                         jcache)
    jcache = jax.tree.map(lambda v: np.asarray(v, np.float32), jcache)

    t_toks = torch.from_numpy(toks)
    logits, cache = model.prefill(lm, t_toks[:, :plen])
    assert logits.dtype == tdtype and logits.shape == (b, cfg.vocab)
    prompt_cache = convert.cache_to_jax(cfg, cache)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(prompt_cache[0]["b0_mamba"][name],
                                   jcache_prompt[0]["b0_mamba"][name], **tol)
    got = [logits]                    # positions plen-1 .. plen+gen-1
    for t in range(plen, plen + gen):
        logits, cache = model.decode_step(lm, cache, t_toks[:, t:t + 1], t)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).float().numpy(),
                               np.stack(jlogits[plen - 1:], 1), **tol)
    back = convert.cache_to_jax(cfg, cache)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(back[0]["b0_mamba"][name],
                                   jcache[0]["b0_mamba"][name], **tol)
    # and the caches carry across both ways
    again = convert.cache_from_jax(cfg, back)
    assert all(torch.equal(a[k].float(), c[k].float())
               for a, c in zip(again, cache) for k in ("conv", "ssm"))


def test_prefill_then_decode_equals_jax_decode_float32():
    _prefill_decode_vs_jax("float32", jnp.float32, F32_TOL)


def test_prefill_then_decode_equals_jax_decode_bfloat16():
    # bfloat16 keeps 8 significant bits (u = 2^-8): the two frameworks round
    # the residual stream, the conv sum and silu at different places, so
    # values of magnitude up to ~4 may differ by a few roundings; held at 8 u
    _prefill_decode_vs_jax("bfloat16", jnp.bfloat16,
                           dict(rtol=2 ** -5, atol=2 ** -5))


# -- weights at full width ------------------------------------------------------------

def _zeros(shape):
    """A float32 array of ``shape`` that allocates one element."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape,
                                           (0,) * len(shape))


def test_full_width_params_convert_and_count():
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    want_n = 7_272_665_088
    assert count_params(cfg) == want_n == j_count_params(jcfg)
    abstract = JModel(jcfg).abstract_params()
    tree = jax.tree.map(lambda s: _zeros(s.shape), abstract)
    state = convert.params_from_jax(cfg, tree)
    meta = transformer.LM(cfg, device="meta").state_dict()
    assert state.keys() == meta.keys()
    assert all(state[k].shape == meta[k].shape for k in meta)
    assert sum(t.numel() for t in state.values()) == want_n
    # unstacked layer i is slice i of the JAX stage leaf
    stage = abstract["stages"][0]["b0_mamba"]
    assert len(transformer.LM(cfg, device="meta").layers) == cfg.n_layers
    for name, s in (("mixer.in_proj", stage["mixer"]["in_proj"]),
                    ("ln1.scale", stage["ln1"]["scale"])):
        shapes = {tuple(state[f"layers.{i}.{name}"].shape)
                  for i in range(cfg.n_layers)}
        assert s.shape[0] == cfg.n_layers and shapes == {tuple(s.shape[1:])}


def test_unported_archs_raise_naming_roadmap(monkeypatch):
    from repro_torch.configs import base
    # every architecture of the JAX package is ported: the rule is held on
    # a stand-in name
    assert base.NOT_PORTED == ()
    monkeypatch.setattr(base, "NOT_PORTED", ("stand-in-arch",))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("stand-in-arch")
    with pytest.raises(ValueError, match="unknown"):
        get_config("no-such-arch")


# -- serving ------------------------------------------------------------------------

def test_serve_cpu_prefill_cache_continues_the_prompt():
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    cfg = get_smoke_config(ARCH)
    assert res.tokens.shape == (2, 4) and res.logits.shape == (2, 4, 256)
    assert not any(res.launches_prefill.values())      # CPU: plain versions
    assert torch.isfinite(res.logits.float()).all()
    # teacher-forced forward over prompt + fed tokens gives, at each decode
    # position, the decode step's logits (bfloat16: same tolerance as above)
    seq = torch.cat([res.prompts, res.tokens[:, :-1]], 1)
    hidden = transformer.forward(cfg, res.params, seq)
    tf = transformer.unembed_logits(cfg, res.params.embed,
                                    hidden[:, res.prompt_len - 1:])
    np.testing.assert_allclose(tf.float().numpy(), res.logits.float().numpy(),
                               rtol=2 ** -5, atol=2 ** -5)
    assert torch.equal(res.logits.argmax(-1), res.tokens)


def test_serve_module_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
         "--gen", "2"], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] prefill: 2x6" in out.stdout
    assert "[serve] decode: 2 steps x batch 2" in out.stdout


def test_serve_and_model_without_device_raise_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None runs on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_smoke_config(ARCH)).init()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_smoke_config(ARCH)).init_cache(1, 8)
