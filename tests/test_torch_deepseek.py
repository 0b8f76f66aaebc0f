"""repro_torch's deepseek-v2-236b serving path against the JAX package, on
the CPU.

The same numpy weights (a JAX ``Model.init`` tree carried across by
``convert``) and tokens go through the JAX model and the port: the
forward's hidden state, the prefill's logits and latent caches, and 4
decode steps against the JAX ``decode_step`` iterated (the JAX prefill
spliced into its ``init_cache``, as its serve.py does), on the ``torch``
and ``hopper`` (on CPU tensors: the row kernels' plain versions)
backends of the embedding gather and the MoE dispatch.  The smoke config
(1 dense + 1 MoE layer, d_model 64, 4 heads, 8 experts top 2) runs in
float32 at 1e-5 (the two sides differ in summation order only); the
parameter count at full width is taken on the meta device.
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
from repro.models import transformer as j_tf
from repro.models.zoo import Model as JModel
from repro.models.zoo import count_params as j_count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import launches
from repro_torch.launch import serve
from repro_torch.models import convert, transformer
from repro_torch.models.zoo import Model, count_params

ROOT = Path(__file__).resolve().parent.parent
ARCH = "deepseek-v2-236b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
GS_BACKENDS = ("torch", "hopper")
# the depth chip_smoke.py serves at full width: 1 dense + 6 MoE layers
SERVED_LAYERS = 7
SERVED_PARAMS = 25_219_261_440


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def _j_cfg(dtype="float32"):
    return dataclasses.replace(j_get_smoke_config(ARCH), dtype=dtype)


def _model_params(jcfg, seed=0):
    """A JAX ``Model.init`` tree with float32 numpy leaves.

    JAX's ``init_tree`` takes a stacked leaf's fan-in from its layer axis;
    the stacked matrices (MLA's, the router, the experts) are redrawn at
    1/sqrt(their second axis), as the port draws one layer's.  Norm scales
    are moved by noise so that they matter.
    """
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        stacked = path[0].key == "stages"
        if stacked and v.ndim >= 3:
            v = rng.standard_normal(v.shape) / np.sqrt(v.shape[1])
        elif v.ndim == 1 or (stacked and v.ndim == 2):
            v = v + 0.1 * rng.standard_normal(v.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, JModel(jcfg).init(jax.random.PRNGKey(seed)))


def _port_lm(cfg, np_tree):
    lm = transformer.LM(cfg, device="cpu", dtype=torch.float32)
    lm.load_state_dict(convert.params_from_jax(cfg, np_tree))
    return lm


def _tokens(cfg, b, s, seed=4):
    return np.random.default_rng(seed).integers(2, cfg.vocab, (b, s))


def test_stage_layout_and_blocks():
    cfg = _cfg()
    assert transformer.stage_layout(cfg) == [(1, ("dense",)), (1, ("moe",))]
    lm = transformer.LM(cfg, device="meta")
    dense, moe_blk = lm.layers
    assert dense.kind == "dense" and moe_blk.kind == "moe"
    assert dense.mlp.wi.shape == (cfg.d_model, cfg.d_ff_dense)
    assert moe_blk.mlp.experts.wi.shape == (cfg.n_experts, cfg.d_model,
                                            cfg.d_ff_expert)
    assert moe_blk.mlp.shared.wi.shape == (
        cfg.d_model, cfg.d_ff_expert * cfg.n_shared_experts)
    assert type(dense.mixer).__name__ == type(moe_blk.mixer).__name__ == "MLA"


@pytest.mark.parametrize("gs_backend", GS_BACKENDS)
@pytest.mark.parametrize("s", [32, 37])       # chunked; ragged (one chunk)
def test_forward_hidden_equals_jax(s, gs_backend):
    cfg, jcfg = _cfg(), _j_cfg()
    tree = _model_params(jcfg)
    lm = _port_lm(cfg, tree)
    toks = _tokens(cfg, 2, s)
    jtree = jax.tree.map(jnp.asarray, tree)
    jh, _ = j_tf.forward(jcfg, jtree, jnp.asarray(toks, jnp.int32))
    before = dict(launches)
    hidden = transformer.forward(cfg, lm, torch.from_numpy(toks),
                                 gs_backend=gs_backend)
    assert launches == before                 # CPU: plain versions only
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), **F32_TOL)
    want = j_tf.unembed_logits(jcfg, jtree["embed"], jh)
    got = transformer.unembed_logits(cfg, lm.embed, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("gs_backend", GS_BACKENDS)
def test_prefill_then_decode_equals_jax(gs_backend):
    """Port prefill of 9 tokens + decode x 4 against the JAX Model.prefill,
    spliced into its init_cache as serve.py does, + decode_step x 4:
    logits and the latent caches, which also carry across both ways."""
    cfg, jcfg = _cfg(), _j_cfg()
    tree = _model_params(jcfg, seed=1)
    jtree = jax.tree.map(jnp.asarray, tree)
    lm = _port_lm(cfg, tree)
    jm, model = JModel(jcfg), Model(cfg)
    plen, gen, b = 9, 4, 3
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

    t_toks = torch.from_numpy(toks)
    logits, cache = model.prefill(lm, t_toks[:, :plen], max_len=max_len,
                                  gs_backend=gs_backend)
    assert logits.shape == (b, cfg.vocab) and len(cache) == cfg.n_layers
    assert all(c["c_kv"].shape == (b, max_len, cfg.kv_lora_rank)
               for c in cache)

    def check_cache(port, want):
        got = convert.cache_to_jax(cfg, port)
        for key in ("b0_dense", "b0_moe"):
            stage = 0 if key == "b0_dense" else 1
            for name in ("c_kv", "k_pe"):
                np.testing.assert_allclose(got[stage][key][name],
                                           want[stage][key][name], **F32_TOL)
        return got
    check_cache(cache, jcache_prompt)
    got = [logits]                    # positions plen-1 .. max_len-1
    for t in range(plen, max_len):
        logits, cache = model.decode_step(lm, cache, t_toks[:, t:t + 1], t,
                                          gs_backend=gs_backend)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               np.stack(jlogits, 1), **F32_TOL)
    back = check_cache(cache, jcache)
    again = convert.cache_to_jax(cfg, convert.cache_from_jax(cfg, back))
    for stage, key in ((0, "b0_dense"), (1, "b0_moe")):
        for name in ("c_kv", "k_pe"):
            np.testing.assert_array_equal(again[stage][key][name],
                                          back[stage][key][name])


def _zeros(shape):
    """A float32 array of ``shape`` that allocates one element."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape,
                                           (0,) * len(shape))


def test_served_depth_params_count_and_convert():
    # the published widths at the served depth, on the meta device
    cfg = dataclasses.replace(get_config(ARCH), n_layers=SERVED_LAYERS)
    jcfg = dataclasses.replace(j_get_config(ARCH), n_layers=SERVED_LAYERS)
    assert count_params(cfg) == SERVED_PARAMS == j_count_params(jcfg)
    abstract = JModel(jcfg).abstract_params()
    state = convert.params_from_jax(
        cfg, jax.tree.map(lambda s: _zeros(s.shape), abstract))
    meta = transformer.LM(cfg, device="meta").state_dict()
    assert state.keys() == meta.keys()
    assert all(state[k].shape == meta[k].shape for k in meta)
    assert sum(t.numel() for t in state.values()) == SERVED_PARAMS
    experts = abstract["stages"][1]["b0_moe"]["mlp"]["experts"]["wi"]
    assert experts.shape == (6, 160, 5120, 1536)
    assert {tuple(state[f"layers.{i}.mlp.experts.wi"].shape)
            for i in range(1, SERVED_LAYERS)} == {(160, 5120, 1536)}
    assert state["layers.0.mlp.wi"].shape == (5120, 12288)
    assert state["layers.3.mixer.kv_norm.scale"].shape == (512,)


def test_serve_cpu_hopper_equals_torch_and_launches_nothing():
    # bfloat16, the smoke config: the hopper backend's plain versions give
    # the torch backend's tokens and logits bit for bit on the CPU
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "19", "--gen", "3"]
    res = serve.main(argv + ["--gs-backend", "hopper"])
    ref = serve.main(argv)
    assert res.gs_backend == "hopper" and ref.gs_backend == "torch"
    assert res.tokens.shape == (2, 4) and res.logits.shape == (2, 4, 256)
    assert not any(res.launches_prefill.values())
    assert not any(res.launches_decode.values())
    assert torch.isfinite(res.logits.float()).all()
    assert torch.equal(res.logits, ref.logits)
    assert torch.equal(res.tokens, ref.tokens)


def test_serve_layers_cuts_the_depth():
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--layers", "3", "--batch", "1", "--prompt-len", "4",
                      "--gen", "1"])
    assert [b.kind for b in res.params.layers] == ["dense", "moe", "moe"]
    assert res.model.cfg.n_layers == 3


def test_serve_module_runs_deepseek_on_cpu_with_hopper():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--gs-backend", "hopper"], env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] prefill: 4x32" in out.stdout
    assert "[serve] decode: 16 steps x batch 4" in out.stdout


def test_served_config_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None runs on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(_cfg(), 1, 4, 1, gs_backend="hopper")


def test_new_modules_import_without_jax_or_building():
    code = ("import sys\n"
            "from repro_torch.kernels import _build\n"
            "from repro_torch.configs import deepseek_v2_236b\n"
            "from repro_torch.models import attention, moe, transformer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "assert not bad, bad\n"
            "assert not _build._libs, 'importing built a kernel'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
