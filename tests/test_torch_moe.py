"""repro_torch's MoE dispatch against the JAX package's, on the CPU.

The same numpy inputs and weights go through the JAX package's
``moe_apply_gspmd`` (the ``gspmd_sort`` dispatch) and the port's
``moe_apply`` on the ``torch``, ``hopper`` (on CPU tensors: the row
kernels' plain versions) and ``onehot`` backends: once at a token count
and routing where the capacity drops assignments (asserted), once at
decode size (N = B tokens).  deepseek-v2-236b's smoke config (8 experts,
top 2, 2 shared) in float32 at 1e-5: the two sides differ only in
summation order.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import moe as j_moe
from repro.models.common import abstract_tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import launches
from repro_torch.models import moe

ARCH = "deepseek-v2-236b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = ("torch", "hopper", "onehot")


def _cfgs(**kw):
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **kw),
            dataclasses.replace(j_get_smoke_config(ARCH), dtype="float32",
                                **kw))


def _params(jcfg, seed=0, hot=()):
    """Numpy weights in the JAX tree's layout, each leaf at 1/sqrt(its
    fan-in).  The router columns of the experts in ``hot`` get a common
    direction u (returned), so inputs along u route to them."""
    rng = np.random.default_rng(seed)
    tree = abstract_tree(j_moe.moe_defs(jcfg), jnp.float32)

    def draw(s):
        fan = s.shape[-2]
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(np.float32)
    out = {k: ({kk: draw(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else draw(v)) for k, v in tree.items()}
    u = rng.standard_normal(jcfg.d_model).astype(np.float32)
    for e in hot:
        out["router"][:, e] += u / np.linalg.norm(u)
    return out, u / np.linalg.norm(u)


def _port_moe(cfg, npp):
    m = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    state = {}
    for k, v in npp.items():
        if isinstance(v, dict):
            state.update({f"{k}.{kk}": torch.from_numpy(vv)
                          for kk, vv in v.items()})
        else:
            state[k] = torch.from_numpy(v)
    m.load_state_dict(state)
    return m


def _jax(jcfg, npp, x):
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in npp.items()}
    y, aux = j_moe.moe_apply_gspmd(jcfg, jp, jnp.asarray(x))
    return np.asarray(y), float(aux)


def _dropping_inputs(cfg, jcfg, b=3, s=32, seed=1):
    """Weights and x (B, S, d) whose tokens lean towards experts 0 and 1,
    so that those overflow the capacity."""
    npp, u = _params(jcfg, seed, hot=(0, 1))
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal((b, s, cfg.d_model))
         + 4.0 * u * rng.random((b, s, 1))).astype(np.float32)
    return npp, x


def _loads(cfg, p, x):
    """Assignments each expert receives, by numpy from the port's route."""
    tope, _, _ = moe.route(cfg, p, torch.from_numpy(x).reshape(-1,
                                                               cfg.d_model))
    return np.bincount(tope.reshape(-1).numpy(), minlength=cfg.n_experts)


@pytest.mark.parametrize("backend", BACKENDS)
def test_moe_with_capacity_drops_equals_jax(backend):
    cfg, jcfg = _cfgs()
    npp, x = _dropping_inputs(cfg, jcfg)
    p = _port_moe(cfg, npp)
    n = x.shape[0] * x.shape[1]
    cap = moe.capacity(cfg, n)
    assert cap == j_moe._capacity(jcfg, n)
    loads = _loads(cfg, p, x)
    assert loads.max() > cap                  # the capacity drops something
    want_y, want_aux = _jax(jcfg, npp, x)
    before = dict(launches)
    y, aux = moe.moe_apply(cfg, p, torch.from_numpy(x), backend)
    assert launches == before                 # CPU: plain versions only
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, **F32_TOL)
    np.testing.assert_allclose(float(aux), want_aux, **F32_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_moe_at_decode_size_equals_jax(backend):
    # N = B tokens: cap >= B, which no expert's load of <= B passes
    cfg, jcfg = _cfgs()
    npp, _ = _params(jcfg, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    p = _port_moe(cfg, npp)
    assert moe.capacity(cfg, 4) >= 4
    want_y, want_aux = _jax(jcfg, npp, x)
    y, aux = moe.moe_apply(cfg, p, torch.from_numpy(x), backend)
    np.testing.assert_allclose(y.numpy(), want_y, **F32_TOL)
    np.testing.assert_allclose(float(aux), want_aux, **F32_TOL)


def test_stable_sort_drops_the_latest_tokens():
    # every token names experts 0 and 1: each takes the first cap tokens
    cfg, _ = _cfgs()
    n, cap = 20, 8
    tope = torch.tensor([[0, 1]] * n)
    topw = torch.full((n, 2), 0.5)
    plan = moe.dispatch_plan(cfg, tope, topw, cap)
    e = cfg.n_experts
    keep = plan["keep"]
    assert int(keep.sum()) == 2 * cap
    assert plan["tok"][keep].tolist() == list(range(cap)) * 2
    assert plan["slot"][keep].tolist() == (list(range(cap))
                                           + list(range(cap, 2 * cap)))
    assert (plan["slot"][~keep] == e * cap).all()      # the scratch row
    assert (plan["back"][~keep] == e * cap - 1).all()  # clipped, as in JAX
    assert (plan["weight"][~keep] == 0).all()
    assert all(t.dtype == torch.int32
               for t in (plan["tok"], plan["slot"], plan["back"]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_scratch_row_never_leaks_into_y(backend):
    # the dropped rows pile up on the scratch row: the kept slots must be
    # exact, and y the JAX package's, which drops them
    cfg, jcfg = _cfgs()
    npp, x = _dropping_inputs(cfg, jcfg, seed=5)
    p = _port_moe(cfg, npp)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    n = xt.shape[0]
    cap = moe.capacity(cfg, n)
    tope, topw, _ = moe.route(cfg, p, xt)
    plan = moe.dispatch_plan(cfg, tope, topw, cap)
    keep = plan["keep"]
    assert (~keep).sum() > 0
    gathered, buffers = moe.fill(cfg, xt, plan, cap, backend)
    e = cfg.n_experts
    assert buffers.shape == (e * cap + 1, cfg.d_model)
    np.testing.assert_allclose(buffers[-1].numpy(),
                               gathered[~keep].sum(0).numpy(), **F32_TOL)
    assert buffers[-1].abs().max() > 1.0     # the scratch row is not empty
    kept = plan["slot"][keep].long()
    assert torch.equal(buffers[kept], gathered[keep])
    unused = torch.ones(e * cap, dtype=torch.bool)
    unused[kept] = False
    assert (buffers[:-1][unused] == 0).all()
    want_y, _ = _jax(jcfg, npp, x)
    y, _ = moe.moe_apply(cfg, p, torch.from_numpy(x), backend)
    np.testing.assert_allclose(y.numpy(), want_y, **F32_TOL)
    # the tokens that no expert kept get only the shared experts
    toks = plan["tok"].long()
    none_kept = [t for t in range(n) if not keep[toks == t].any()]
    assert none_kept
    shared = moe.mlp_apply(cfg, p.shared, xt[none_kept])
    np.testing.assert_allclose(y.reshape(n, -1)[none_kept].numpy(),
                               shared.numpy(), **F32_TOL)


def test_ep_shardmap_raises_naming_roadmap():
    cfg, jcfg = _cfgs(moe_impl="ep_shardmap")
    npp, _ = _params(jcfg)
    p = _port_moe(cfg, npp)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        moe.moe_apply(cfg, p, torch.zeros(1, 2, cfg.d_model))


def test_full_width_capacity_at_the_served_shapes():
    # the shapes chip_smoke.py serves: 4 x 2048 prefill tokens, 4 decode
    cfg = get_config(ARCH)
    assert moe.capacity(cfg, 4 * 2048) == 384
    assert moe.capacity(cfg, 4) == cfg.top_k == 6
    # the no-drop factor: cap >= n for the consistency checks' sizes
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    for n in (1, 2, 4, 5, 64, 128, 192, 2 * 96):
        assert moe.capacity(nodrop, n) >= n
