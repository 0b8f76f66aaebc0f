"""The gradients of the two recurrences (the selective scan, the RG-LRU)
against the JAX package, on the CPU.

``selective_scan_bwd_ref`` and ``rglru_scan_bwd_ref`` are the plain
versions of the backward kernels in ``csrc/selective_scan.cu`` and
``csrc/rglru_scan.cu``; autograd through the wrappers (``SelectiveScanFn``,
``RGLRUScanFn``) runs them on CPU tensors.  Each is held to ``jax.vjp`` of
the JAX function it differentiates on the same numpy draws, in float32:
the scan's oracle ``repro.kernels.selective_scan.ref.selective_scan_ref``
and the model's ``lax.scan`` over ``repro.models.ssm._scan_step``, the
RG-LRU's ``lax.scan`` over ``repro.models.rglru._step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import (
    selective_scan_ref as j_selective_scan_ref)
from repro.models import rglru as j_rglru
from repro.models import ssm as j_ssm
from repro_torch.kernels import launches
from repro_torch.kernels.rglru_scan.ops import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)
from repro_torch.kernels.selective_scan.ops import (CHUNK, selective_scan,
                                                    selective_scan_bwd)
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ckpt_ref,
                                                    selective_scan_ref)

# float32 on both sides; a gradient sums the terms of every later step (up
# to 129 here) in another order than XLA's: 1e-4 relative, with an atol of
# 1e-6 for entries near 0, times the tensor's largest magnitude where that
# passes 1 (du sums dy D and dt sum_n g B, which cancel: an entry of 0.0886
# in a du whose largest is 12.2 read 2.0e-6 from XLA's, 1.7e-7 of 12.2)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
D = 20                          # channels of the scan cases


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_draw(bsz, l, n, d=D, seed=0):
    """u, dt, b, c, a, d_skip and the cotangents dy, dh_final, float32, as
    the model makes them: dt = softplus(N(0, 1)), a = -exp(N(0, 1) / 2)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def rnd(*shape):
        return rng.standard_normal(shape).astype(f)
    u, b, c = rnd(bsz, l, d), rnd(bsz, l, n), rnd(bsz, l, n)
    dt = np.log1p(np.exp(rnd(bsz, l, d))).astype(f)
    a = -np.exp(0.5 * rnd(n, d)).astype(f)
    return u, dt, b, c, a, rnd(1, d), rnd(bsz, l, d), rnd(bsz, n, d)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    top = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               err_msg=name, rtol=GRAD_TOL["rtol"],
                               atol=GRAD_TOL["atol"] * top)


SCAN_NAMES = ("du", "ddt", "db", "dc", "da", "dd_skip")


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("l", [1, 7, 64, 129])
@pytest.mark.parametrize("bsz", [1, 2])
def test_scan_bwd_ref_equals_jax_vjp_of_the_oracle(bsz, l, n, with_dh):
    """Every gradient of the scan's plain backward against ``jax.vjp`` of
    the JAX oracle, with and without a cotangent of the final state (L 64
    and 129: whole and ragged chunks of the kernel's 8 steps)."""
    u, dt, b, c, a, d_skip, dy, dh = _scan_draw(bsz, l, n, seed=l + n)
    if not with_dh:
        dh = np.zeros_like(dh)
    _, vjp = jax.vjp(j_selective_scan_ref,
                     *map(jnp.asarray, (u, dt, b, c, a, d_skip)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = selective_scan_bwd_ref(*map(_t, (u, dt, b, c, a, d_skip, dy)),
                                 _t(dh) if with_dh else None)
    assert len(got) == 6
    for name, g, w in zip(SCAN_NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("bsz,l,n", [(2, 33, 4), (1, 17, 16), (2, 5, 8)])
def test_scan_bwd_ref_equals_jax_vjp_of_the_model_scan(bsz, l, n):
    """Against ``jax.vjp`` of the model's path: ``lax.scan`` over
    ``ssm._scan_step`` (state (B, D, N), parameters a_log (D, N) and d_skip
    (D,)); a = -exp(a_log) puts d a_log = da^T a."""
    u, dt, b, c, _, _, dy, _ = _scan_draw(bsz, l, n, seed=3)
    rng = np.random.default_rng(4)
    a_log = (0.5 * rng.standard_normal((D, n))).astype(np.float32)
    d_skip = rng.standard_normal(D).astype(np.float32)

    def model_scan(u, dt, b, c, a_log, d_skip):
        xs = tuple(jnp.moveaxis(x, 1, 0) for x in (u, dt, b, c))
        _, ys = jax.lax.scan(
            lambda h, i: j_ssm._scan_step(a_log, d_skip, h, i),
            jnp.zeros((bsz, D, n), jnp.float32), xs)
        return jnp.moveaxis(ys, 0, 1)
    _, vjp = jax.vjp(model_scan, *map(jnp.asarray,
                                      (u, dt, b, c, a_log, d_skip)))
    want = vjp(jnp.asarray(dy))
    a = -np.exp(a_log).T
    du, ddt, db, dc, da, dd = selective_scan_bwd_ref(
        *map(_t, (u, dt, b, c, np.ascontiguousarray(a), d_skip[None], dy)))
    for name, g, w in (("du", du, want[0]), ("ddt", ddt, want[1]),
                       ("db", db, want[2]), ("dc", dc, want[3]),
                       ("da_log", (da * _t(a)).T, want[4]),
                       ("d_skip", dd[0], want[5])):
        _close(g.numpy(), w, name)


# float32 on both sides, the same recurrence in the same order; exp and
# jnp.exp may differ by an ulp a step, and a state carries those of up to
# 3 CHUNK steps here: 1e-5 relative, 1e-6 of the largest state near 0
CKPT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("l", [1, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK - 1])
def test_scan_ckpt_ref_equals_jax_prefix_states(l, n):
    """The plain version of the checkpoint: entry k is the state before
    step k CHUNK, which is the h_final that the JAX oracle returns on the
    prefix of k CHUNK steps (entry 0 the zero state, the empty prefix's);
    L on the chunk's edges (one step, a step short of a chunk, a chunk, a
    step past it, three chunks less one)."""
    u, dt, b, c, a, d_skip, _, _ = _scan_draw(2, l, n, seed=5 * l + n)
    got = selective_scan_ckpt_ref(*map(_t, (u, dt, b, a)), CHUNK)
    assert got.dtype == torch.float32
    assert got.shape == (2, -(-l // CHUNK), n, D)
    for k in range(got.shape[1]):
        t = k * CHUNK
        _, want = j_selective_scan_ref(*(jnp.asarray(x[:, :t])
                                         for x in (u, dt, b, c)),
                                       jnp.asarray(a), jnp.asarray(d_skip))
        want = np.asarray(want)
        top = max(1.0, float(np.abs(want).max(initial=0.0)))
        np.testing.assert_allclose(got[:, k].numpy(), want,
                                   rtol=CKPT_TOL["rtol"],
                                   atol=CKPT_TOL["atol"] * top,
                                   err_msg=f"state before step {t}")


def test_scan_bwd_bf16_rounds_once():
    """bfloat16 operands: du, ddt, db, dc are the float32 gradient of the
    same (bf16-valued) inputs rounded once to bfloat16; da and dd_skip stay
    float32 and equal it."""
    u, dt, b, c, a, d_skip, dy, dh = _scan_draw(2, 40, 8, seed=7)
    bf = [_t(x).to(torch.bfloat16) for x in (u, dt, b, c)]
    dy_bf = _t(dy).to(torch.bfloat16)
    got = selective_scan_bwd_ref(*bf, _t(a), _t(d_skip), dy_bf, _t(dh))
    want = selective_scan_bwd_ref(*(x.float() for x in bf), _t(a),
                                  _t(d_skip), dy_bf.float(), _t(dh))
    for name, g, w in zip(SCAN_NAMES, got, want):
        if name in ("da", "dd_skip"):
            assert g.dtype == torch.float32 and torch.equal(g, w), name
        else:
            assert g.dtype == torch.bfloat16, name
            assert torch.equal(g, w.to(torch.bfloat16)), name


@pytest.mark.parametrize("use_h", [False, True])
def test_scan_function_on_cpu_is_the_plain_backward(use_h):
    """Autograd through ``selective_scan`` with grad on (the CPU:
    ``SelectiveScanFn`` with the plain versions, no launch) gives
    ``selective_scan_bwd_ref``'s result bit for bit, with h_final's
    cotangent where the loss reads it; and the forward is the plain one."""
    u, dt, b, c, a, d_skip, dy, dh = _scan_draw(2, 23, 4, seed=11)
    ins = [_t(x).requires_grad_() for x in (u, dt, b, c, a, d_skip)]
    before = dict(launches)
    y, h = selective_scan(*ins)
    y0, h0 = selective_scan_ref(*(x.detach() for x in ins))
    assert torch.equal(y.detach(), y0) and torch.equal(h.detach(), h0)
    loss = (y * _t(dy)).sum() + ((h * _t(dh)).sum() if use_h else 0.0)
    got = torch.autograd.grad(loss, ins)
    want = selective_scan_bwd_ref(*(x.detach() for x in ins), _t(dy),
                                  _t(dh) if use_h else None)
    assert dict(launches) == before
    for name, g, w in zip(SCAN_NAMES, got, want):
        assert torch.equal(g, w), name


def test_scan_grad_checks_shapes_and_dtypes():
    """The wrapper's checks hold under grad, and the backward's own: dy in
    u's dtype and shape, dh_final float32 (B, N, D), N in 4, 8, 16."""
    u, dt, b, c, a, d_skip, dy, dh = map(_t, _scan_draw(1, 5, 4, seed=2))
    ins = [u, dt, b, c, a, d_skip]
    with pytest.raises(ValueError, match="dt: expected shape"):
        selective_scan(u.requires_grad_(), dt[:, :4], b, c, a, d_skip)
    with pytest.raises(TypeError, match="a: expected torch.float32"):
        selective_scan(u, dt, b, c, a.double().requires_grad_(), d_skip)
    with pytest.raises(ValueError, match="state size N=3"):
        selective_scan(u, dt, b[..., :3], c[..., :3], a[:3], d_skip)
    u = u.detach()
    ins[0] = u
    with pytest.raises(ValueError, match="dy: expected shape"):
        selective_scan_bwd(*ins, dy[:, :3])
    with pytest.raises(TypeError, match="dy: expected torch.float32"):
        selective_scan_bwd(*ins, dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dh_final: expected shape"):
        selective_scan_bwd(*ins, dy, dh[:, :2])
    with pytest.raises(TypeError, match="dh_final: expected torch.float32"):
        selective_scan_bwd(*ins, dy, dh.double())
    # the CPU needs no checkpoint: the plain backward rebuilds every state
    assert all(torch.equal(g, w) for g, w in zip(
        selective_scan_bwd(*ins, dy, dh), selective_scan_bwd_ref(
            *ins, dy, dh)))


def _rglru_draw(bsz, s, w=24, seed=0):
    """a in (0, 1), beta = sqrt(1 - a^2), gx, h0 and the cotangents dhs,
    dh_last, float32, as the model's gates give them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    a = rng.uniform(0.05, 0.999, (bsz, s, w)).astype(f)
    beta = np.sqrt(np.maximum(1 - a * a, 1e-12)).astype(f)
    return (a, beta, (3 * rng.standard_normal((bsz, s, w))).astype(f),
            rng.standard_normal((bsz, w)).astype(f),
            rng.standard_normal((bsz, s, w)).astype(f),
            rng.standard_normal((bsz, w)).astype(f))


RGLRU_NAMES = ("da", "dbeta", "dgx", "dh0")


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("bsz,s", [(1, 1), (2, 2), (2, 63), (1, 129)])
def test_rglru_bwd_ref_equals_jax_vjp_of_the_model_scan(bsz, s, with_dh):
    """da, dbeta, dgx and dh0 of the plain backward against ``jax.vjp`` of
    ``lax.scan`` over ``rglru._step`` (the model's recurrence) from h0,
    with and without a cotangent of h_S."""
    a, beta, gx, h0, dhs, dh = _rglru_draw(bsz, s, seed=s)
    if not with_dh:
        dh = np.zeros_like(dh)

    def model_scan(a, beta, gx, h0):
        xs = tuple(jnp.moveaxis(x, 1, 0) for x in (a, beta, gx))
        h, hs = jax.lax.scan(j_rglru._step, h0, xs)
        return jnp.moveaxis(hs, 0, 1), h
    (j_hs, _), vjp = jax.vjp(model_scan,
                             *map(jnp.asarray, (a, beta, gx, h0)))
    want = vjp((jnp.asarray(dhs), jnp.asarray(dh)))
    ins = list(map(_t, (a, beta, gx, h0)))
    hs, _ = rglru_scan_ref(*ins)
    np.testing.assert_allclose(hs.numpy(), np.asarray(j_hs), rtol=1e-5,
                               atol=1e-5)
    got = rglru_scan_bwd_ref(*ins, hs, _t(dhs), _t(dh) if with_dh else None)
    for name, g, w in zip(RGLRU_NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("use_h", [False, True])
def test_rglru_function_on_cpu_is_the_plain_backward(use_h):
    """Autograd through ``rglru_scan`` with grad on (``RGLRUScanFn`` with
    the plain versions on the CPU, no launch) gives ``rglru_scan_bwd_ref``'s
    result bit for bit, dh0 included."""
    a, beta, gx, h0, dhs, dh = _rglru_draw(2, 37, seed=5)
    ins = [_t(x).requires_grad_() for x in (a, beta, gx, h0)]
    before = dict(launches)
    hs, h_last = rglru_scan(*ins)
    want_hs, want_last = rglru_scan_ref(*(x.detach() for x in ins))
    assert torch.equal(hs.detach(), want_hs)
    assert torch.equal(h_last.detach(), want_last)
    loss = (hs * _t(dhs)).sum() + ((h_last * _t(dh)).sum() if use_h else 0.0)
    got = torch.autograd.grad(loss, ins)
    want = rglru_scan_bwd_ref(*(x.detach() for x in ins), want_hs, _t(dhs),
                              _t(dh) if use_h else None)
    assert dict(launches) == before
    for name, g, w in zip(RGLRU_NAMES, got, want):
        assert torch.equal(g, w), name


def test_rglru_bwd_without_steps_passes_dh_last_to_h0():
    """S = 0: h_S is h0, so dh0 is dh_last and the step gradients are
    empty."""
    a, beta, gx, h0, dhs, dh = map(_t, _rglru_draw(2, 0, seed=1))
    da, dbeta, dgx, dh0 = rglru_scan_bwd(a, beta, gx, h0, a.clone(), dhs, dh)
    assert da.shape == dbeta.shape == dgx.shape == (2, 0, 24)
    assert torch.equal(dh0, dh)


def test_rglru_grad_checks_shapes_and_dtypes():
    """The wrapper's checks hold under grad, and the backward's own: hs and
    dhs (B, S, W), dh_last (B, W), all float32."""
    a, beta, gx, h0, dhs, dh = map(_t, _rglru_draw(1, 6, seed=2))
    with pytest.raises(ValueError, match="gx: expected shape"):
        rglru_scan(a.requires_grad_(), beta, gx[:, :5], h0)
    with pytest.raises(TypeError, match="h0: expected torch.float32"):
        rglru_scan(a, beta, gx, h0.double().requires_grad_())
    a = a.detach()
    hs, _ = rglru_scan_ref(a, beta, gx, h0)
    with pytest.raises(ValueError, match="dhs: expected shape"):
        rglru_scan_bwd(a, beta, gx, h0, hs, dhs[:, :5])
    with pytest.raises(TypeError, match="hs: expected torch.float32"):
        rglru_scan_bwd(a, beta, gx, h0, hs.double(), dhs)
    with pytest.raises(ValueError, match="dh_last: expected shape"):
        rglru_scan_bwd(a, beta, gx, h0, hs, dhs, dh[:, :3])
