"""The port's Spatter path on bfloat16 and float16 tables, against the JAX
package at the same dtype.

Draws stay float32 numpy in both packages; ``host.as_dtype`` makes the
16-bit operand, bit for bit what ``jnp.asarray(x, dtype)`` makes.  So for
gathers and store-mode scatters every port backend must give the
reference ``xla`` backend's sha256 at the same dtype (``demux`` hashes
the 2-byte words).  Adds sum in the dtype in another order, so they are
held to ``add_error_bound`` at the dtype's unit roundoff (2^-8 for
bfloat16, 2^-11 for float16; rows with K * u >= 1/2 get no bound).  On
the CPU the hopper backend runs its kernels' plain versions, in the
table's dtype.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import cost as j_cost
from repro.core import plan as j_plan
from repro_torch import GSEngine, backends, bandwidth, host, plan
from repro_torch.analysis import cost
from repro_torch.diskcache import DiskTier
from repro_torch.kernels import _build, autotune, launches
from repro_torch.kernels.gather_rows import ops as gather_ops
from repro_torch.kernels.scatter_rows import ops as scatter_ops
from repro_torch.kernels.scatter_rows.ref import (UNIT_ROUNDOFF,
                                                  add_error_bound)
from test_torch_placement import _cpus
from test_torch_plan import _j, _suite

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
SUITES = ("demo", "apps", "widelane", "appdb")
PLACED = [(1, 2), (2, 1), (2, 2)]

_REF = {}


def _ref_digests(name, dname):
    """The reference's ``xla`` digests of a capped suite at a dtype."""
    if (name, dname) not in _REF:
        pats = [_j(p) for p in _suite(name)]
        res = j_plan.run_plan(j_plan.SuitePlan.build(pats), backend="xla",
                              runs=1, digest=True, dtype=DTYPES[dname][1],
                              cache=j_plan.ExecutorCache())
        _REF[name, dname] = [r.out_digest for r in res]
    return _REF[name, dname]


def _run(name, backend, dname, **kw):
    return plan.run_plan(plan.SuitePlan.build(_suite(name)), backend=backend,
                         runs=1, digest=True, device="cpu",
                         dtype=DTYPES[dname][0], cache=plan.ExecutorCache(),
                         **kw)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("backend", ["torch", "scalar", "hopper", "onehot"])
@pytest.mark.parametrize("name", SUITES)
def test_digests_equal_reference(name, backend, dname):
    # onehot too: these capped draws hold no payload that rounds to -0.0
    # (test_onehot_store_drops_the_sign_of_minus_zero has one)
    res = _run(name, backend, dname)
    assert [r.out_digest for r in res] == _ref_digests(name, dname)
    assert all(r.elem_bytes == 2 and r.time_s > 0 for r in res)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("backend", ["torch", "scalar", "hopper", "onehot"])
def test_add_mode_within_bound_of_reference(backend, dname):
    tdt, jdt = DTYPES[dname]
    pats = _suite("demo")
    mine = plan.SuitePlan.build(pats)
    ref = j_plan.SuitePlan.build([_j(p) for p in pats])
    works = plan.make_work(mine, backend=backend, runs=1, mode="add",
                           digest=True, device="cpu", dtype=tdt)
    for work, bucket in zip(works, ref.buckets):
        res = plan.launch((work,), plan.ExecutorCache())
        want = j_plan.execute_bucket(ref, bucket, backend="xla", mode="add",
                                     dtype=jdt, cache=j_plan.ExecutorCache())
        for i, p in enumerate(work.patterns):
            n = res.real_lanes[i] if p.kind == "gather" else p.footprint()
            got = res.out[i, :n]
            assert got.dtype == tdt
            w = torch.from_numpy(np.asarray(want[i]).astype(np.float64))
            if p.kind == "gather":
                assert torch.equal(got.double(), w)
                continue
            _, idx, vals, _ = host.make_host_buffers(p, 1, seed=0)
            bound = add_error_bound(torch.from_numpy(idx)[None],
                                    host.as_dtype(vals, tdt)[None],
                                    p.footprint())[0]
            assert bool(((got.double() - w).abs() <= bound).all())


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("shape", PLACED)
@pytest.mark.parametrize("name", ["demo", "appdb"])
def test_placed_gathers_and_stores_give_reference_digests(name, shape,
                                                          dname):
    res = _run(name, "hopper", dname, mesh=_cpus(shape))
    assert [r.out_digest for r in res] == _ref_digests(name, dname)
    assert all(r.elem_bytes == 2 for r in res)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("shape", PLACED)
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_placed_adds_within_bound_of_reference(backend, shape, dname):
    # a lane split sums each row's shard partials in the dtype (the
    # reference's psum form); that is one more order of the same sum, so
    # the unplaced bound holds
    tdt, jdt = DTYPES[dname]
    pats = _suite("demo")
    ref = j_plan.SuitePlan.build([_j(p) for p in pats])
    works = plan.make_work(plan.SuitePlan.build(pats), backend=backend,
                           runs=1, mode="add", digest=True, device="cpu",
                           dtype=tdt, mesh=_cpus(shape))
    cache = plan.ExecutorCache()
    n_scatters = 0
    for work, bucket in zip(works, ref.buckets):
        assert work.placement.grid == shape
        res = plan.launch((work,), cache)
        want = j_plan.execute_bucket(ref, bucket, backend="xla", mode="add",
                                     dtype=jdt, cache=j_plan.ExecutorCache())
        for i, p in enumerate(work.patterns):
            if p.kind == "gather":
                continue
            got = res.out[i, :p.footprint()]
            assert got.dtype == tdt
            w = torch.from_numpy(np.asarray(want[i]).astype(np.float64))
            _, idx, vals, _ = host.make_host_buffers(p, 1, seed=0)
            bound = add_error_bound(torch.from_numpy(idx)[None],
                                    host.as_dtype(vals, tdt)[None],
                                    p.footprint())[0]
            assert bool(((got.double() - w).abs() <= bound).all())
            n_scatters += 1
    assert n_scatters > 0


def test_onehot_store_drops_the_sign_of_minus_zero():
    # a float32 draw below 2^-25 in magnitude is -0.0 in float16: the
    # torch, scalar and hopper stores move its bits, as the reference's
    # xla store does; the one-hot store adds it to +0.0 and keeps +0.0
    # (the reference's one-hot store does the same)
    vals32 = np.array([[-2.0 ** -26], [1.5], [-3.0]], np.float32)
    vals = host.as_dtype(vals32, torch.float16)
    assert torch.signbit(vals[0, 0]) and vals[0, 0] == 0
    idx = torch.tensor([0, 2, 3], dtype=torch.int32)
    keep = torch.ones(3, dtype=torch.bool)
    ref = np.array(jnp.zeros((4, 1), jnp.float16).at[np.array([0, 2, 3])]
                   .set(jnp.asarray(vals32, jnp.float16)))
    out = {}
    for b in ("torch", "scalar", "hopper", "onehot"):
        dst = torch.zeros(4, 1, dtype=torch.float16)
        out[b] = backends.scatter(dst, idx, vals, mode="store", backend=b,
                                  keep=keep).view(torch.int16)
    ref_bits = torch.from_numpy(ref.view(np.int16))
    for b in ("torch", "scalar", "hopper"):
        assert torch.equal(out[b], ref_bits), b
    assert out["onehot"][0, 0] == 0 and ref_bits[0, 0] == -(1 << 15)
    assert torch.equal(out["onehot"][1:], ref_bits[1:])


@pytest.mark.parametrize("dname", DTYPES)
def test_as_dtype_matches_jax_bit_for_bit(dname):
    tdt, jdt = DTYPES[dname]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1 << 14, dtype=np.float32)
    x[:6] = [-0.0, 65520.0, 2.0 ** -26, -2.0 ** -27, 3.0e38, 1e-40]
    got = host.as_dtype(x, tdt).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x, jdt)).view(np.int16)
    assert np.array_equal(got, want)
    assert host.as_dtype(x, torch.float32).data_ptr() == \
        torch.from_numpy(x).data_ptr()                  # float32: no copy


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("backend", backends.BACKENDS)
@pytest.mark.parametrize("kind", ["gather", "scatter"])
def test_engine_runs_every_backend(kind, backend, dname):
    tdt = DTYPES[dname][0]
    p = next(x for x in _suite("demo") if x.kind == kind)
    eng = GSEngine(p, backend=backend, dtype=tdt, device="cpu")
    fn, args = eng.build()
    got = fn(*args)
    assert got.dtype == tdt
    ref_fn, ref_args = GSEngine(p, backend="torch", dtype=tdt,
                                device="cpu").build()
    assert torch.equal(got.view(torch.int16),
                       ref_fn(*ref_args).view(torch.int16))
    r = eng.run(runs=1)
    assert r.elem_bytes == 2 and r.device == "cpu"
    assert r.measured_gbs == pytest.approx(
        bandwidth.paper_bandwidth(p, r.time_s, 2) / 1e9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.uint8])
def test_other_dtypes_raise(dtype):
    table = torch.zeros(1, 8, 1, dtype=dtype)
    idx = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32.*bfloat16.*float16"):
        gather_ops.gather_rows(table, idx)
    with pytest.raises(TypeError, match="float32.*bfloat16.*float16"):
        scatter_ops.scatter_add_rows_(table, idx, torch.zeros(
            1, 4, 1, dtype=dtype))
    with pytest.raises(TypeError, match="float32.*bfloat16.*float16"):
        backends.check_dtype(dtype)
    with pytest.raises(TypeError, match="float32.*bfloat16.*float16"):
        _build.spatter_instance("gather_rows", dtype)


def test_vals_must_have_dst_dtype():
    dst = torch.zeros(1, 8, 1, dtype=torch.bfloat16)
    idx = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(TypeError, match="vals.*bfloat16.*float16"):
        scatter_ops.scatter_add_rows_(dst, idx, torch.zeros(
            1, 4, 1, dtype=torch.float16))


@pytest.mark.parametrize("dname", DTYPES)
def test_cpu_wrappers_run_the_plain_versions_in_the_dtype(dname):
    tdt = DTYPES[dname][0]
    before = dict(launches)
    table = torch.randn(2, 9, 3).to(tdt)
    idx = torch.tensor([[0, 8, 9, -1], [3, 3, 2, 1]], dtype=torch.int32)
    got = gather_ops.gather_rows(table, idx)
    assert got.dtype == tdt and torch.equal(got[0, 0], table[0, 0])
    assert torch.equal(got[0, 2:].view(torch.int16),
                       torch.zeros(2, 3, dtype=torch.int16))
    vals = torch.randn(2, 4, 3).to(tdt)
    dst = scatter_ops.scatter_add_rows_(torch.zeros(2, 9, 3, dtype=tdt), idx,
                                        vals)
    assert dst.dtype == tdt and torch.equal(dst[0, 8], vals[0, 1])
    assert launches == before


@pytest.mark.parametrize("dtype,u", [(torch.float32, 2.0 ** -24),
                                     (torch.bfloat16, 2.0 ** -8),
                                     (torch.float16, 2.0 ** -11)])
def test_add_error_bound_takes_the_dtype_roundoff(dtype, u):
    assert UNIT_ROUNDOFF[dtype] == u
    # K = 4 values of 1 on row 0, K = 1 on row 1, none on row 2
    idx = torch.tensor([[0, 0, 0, 0, 1]], dtype=torch.int32)
    vals = torch.ones(1, 5, 1, dtype=dtype)
    got = add_error_bound(idx, vals, 3)[0, :, 0]
    want = [2 * 4 * u / (1 - 4 * u) * 4, 2 * u / (1 - u), 0.0]
    assert got.tolist() == pytest.approx(want)


def test_add_error_bound_is_inf_where_k_u_reaches_one_half():
    # bfloat16: u = 2^-8, so 128 values a row (K u = 1/2) have no bound;
    # 127 do, and a row of zeros sums to 0 whatever its K
    idx = torch.tensor([[0] * 127 + [1] * 128 + [2] * 200],
                       dtype=torch.int32)
    vals = torch.ones(1, 455, 1, dtype=torch.bfloat16)
    vals[0, 255:] = 0
    got = add_error_bound(idx, vals, 3)[0, :, 0]
    assert torch.isfinite(got[0]) and got[0] > 0
    assert torch.isinf(got[1]) and got[2] == 0


def test_elem_bytes_follow_the_dtype():
    pats = _suite("demo")
    works = plan.make_work(plan.SuitePlan.build(pats), backend="torch",
                           runs=1, digest=True, device="cpu",
                           dtype=torch.bfloat16)
    res = plan.launch((works[0],), plan.ExecutorCache())
    out = plan.demux(res, works[0])
    assert {r.elem_bytes for _, r in out} == {2}
    assert works[0].dtype == "bfloat16" and res.key.dtype == "bfloat16"
    assert res.out.dtype == torch.bfloat16


def test_cost_bytes_equal_the_reference_at_bfloat16():
    pats = _suite("demo")
    mine = cost.cost_plan(pats, backend="torch", dtype=torch.bfloat16,
                          device="cpu", census=False)
    ref = j_cost.cost_plan([_j(p) for p in pats], backend="xla",
                           dtype=jnp.bfloat16, lowered=False)
    fields = ("io_bytes", "useful_bytes", "pad_bytes", "table_bytes",
              "index_bytes", "keep_bytes")
    assert [[getattr(u, f) for f in fields] for u in mine.units] == \
        [[getattr(u, f) for f in fields] for u in ref.units]
    f32 = cost.cost_plan(pats, backend="torch", device="cpu", census=False)
    assert sum(u.table_bytes for u in mine.units) * 2 == \
        sum(u.table_bytes for u in f32.units)


def test_lint_and_cost_of_a_bfloat16_plan_are_clean():
    from repro_torch.analysis import lint
    pats = _suite("demo")
    for backend in ("torch", "hopper"):
        rep = lint.lint_plan(pats, backend=backend, dtype=torch.bfloat16,
                             device="cpu")
        # one unit a bucket and one for the plan
        assert rep.ok and rep.n_units == plan.SuitePlan.build(
            pats).n_buckets + 1
        assert not [v for v in rep.violations
                    if v.rule == "no-f64-promotion-drift"]
        crep = cost.cost_plan(pats, backend=backend, dtype=torch.bfloat16,
                              device="cpu")
        assert crep.ok
        assert all(u.lowered_bytes == u.io_bytes for u in crep.units)


def _key(op, lanes, rows, width, dtype, platform="cpu"):
    return autotune.TileKey(op=op, batch=1, lanes=lanes, rows=rows,
                            width=width, dtype=dtype, platform=platform)


def test_sixteen_bit_keys_count_eight_lane_vectors():
    f32 = _key("gather_global", 1 << 20, 1 << 20, 1, "float32")
    b16 = dataclasses.replace(f32, dtype="bfloat16")
    assert autotune._work(f32) == (1 << 20) // 4
    assert autotune._work(b16) == (1 << 20) // 8
    assert autotune._work(dataclasses.replace(b16, width=16)) == \
        (1 << 20) * 2                                      # uint4 rows
    assert autotune._work(dataclasses.replace(b16, width=4)) == \
        (1 << 20) * 4                                      # 2-byte elements
    assert autotune._global_bytes(b16) == (1 << 20) * (4 + 2 * 2)
    assert autotune._global_bytes(dataclasses.replace(
        b16, op="scatter_store")) == (1 << 20) * (4 + 1 + 2 * 2)


def test_sixteen_bit_keys_take_their_own_choices():
    autotune.reset()
    try:
        # 6M lanes: the legacy rule is deep for float32 (1.5M vectors of
        # 4 lanes fill the card 4 deep) and shallow for 16 bits (750K)
        f32 = _key("gather_global", 6_000_000, 1 << 23, 1, "float32")
        b16 = dataclasses.replace(f32, dtype="bfloat16")
        assert autotune.legacy_vecs(f32) == 4 and autotune.legacy_vecs(b16) == 1
        autotune.choose(f32)
        autotune.choose(b16)
        assert autotune.stats()["searched"] == 2
        assert autotune.lookup(b16) is not None
        # a table of 100,000 one-element rows fits 227 KB only at 2 bytes
        g32 = _key("gather", 200_000, 100_000, 1, "float32")
        g16 = dataclasses.replace(g32, dtype="float16")
        assert not autotune.smem_feasible(g32) and autotune.smem_feasible(g16)
        assert autotune.smem_cost(g16, 256) < autotune.smem_cost(
            dataclasses.replace(g16, dtype="float32"), 256)
        wire = autotune.to_wire({b16: autotune.choose(b16)})
        assert autotune.key_from_wire(next(iter(wire))) == b16
    finally:
        autotune.reset()


def test_smem_switch_at_two_bytes():
    limit = gather_ops.SMEM_TABLE_BYTES
    assert limit // 2 == 116224
    assert gather_ops.use_smem(116224, 116224, 1, 2)
    assert not gather_ops.use_smem(116225, 116225, 1, 2)
    assert gather_ops.use_smem(58112, 58112, 1, 4)
    assert not gather_ops.use_smem(58113, 58113, 1, 4)
    with pytest.raises(ValueError, match="exceeds"):
        gather_ops.gather_rows_smem(
            torch.zeros(1, 116225, 1, dtype=torch.bfloat16),
            torch.zeros(1, 4, dtype=torch.int32))
    got = gather_ops.gather_rows_smem(
        torch.ones(1, 116224, 1, dtype=torch.bfloat16),
        torch.zeros(1, 4, dtype=torch.int32))
    assert got.dtype == torch.bfloat16 and bool((got == 1).all())


def test_the_six_entries_are_bound():
    want = {("gather_rows", "bfloat16"): "gather_rows_b16",
            ("gather_rows", "float16"): "gather_rows_b16",
            ("gather_rows_smem", "bfloat16"): "gather_rows_smem_b16",
            ("scatter_store_rows", "float16"): "scatter_store_rows_b16",
            ("scatter_store_rows_cov", "bfloat16"):
                "scatter_store_rows_cov_b16",
            ("scatter_add_rows", "bfloat16"): "scatter_add_rows_bf16",
            ("scatter_add_rows", "float16"): "scatter_add_rows_f16",
            ("scatter_add_rows", "float32"): "scatter_add_rows"}
    lib = {"gather_rows": "gather_rows", "gather_rows_smem": "gather_rows"}
    for (kernel, dtype), name in want.items():
        got, fn = _build.spatter_instance(kernel, dtype)
        assert got == name and got in _build.KERNELS
        assert fn in _build._SIGNATURES[lib.get(kernel, "scatter_rows")]
    entries = {fn for fns in _build._SIGNATURES.values() for fn in fns}
    assert {"gather_rows_b16", "gather_rows_smem_b16",
            "scatter_store_rows_b16", "scatter_store_rows_cov_b16",
            "scatter_add_rows_bf16", "scatter_add_rows_f16"} <= entries
    # the cluster query takes the element size: a 2-byte table's answer is
    # not a 4-byte table's
    assert len(_build._SIGNATURES["gather_rows"]
               ["gather_rows_smem_clusters"]) == 4


def test_disk_tier_keeps_dtypes_apart(tmp_path):
    pats = _suite("demo")[:3]
    sp = plan.SuitePlan.build(pats)

    def run(dtype, cache):
        return [r.out_digest for r in plan.run_plan(
            sp, backend="hopper", runs=1, digest=True, device="cpu",
            dtype=dtype, cache=cache)]
    bf = run(torch.bfloat16, plan.ExecutorCache(
        disk=DiskTier(str(tmp_path), device="cpu")))
    cold = plan.ExecutorCache()
    cold.attach_disk(DiskTier(str(tmp_path), device="cpu"), preload=False)
    f32 = run(torch.float32, cold)
    assert cold.stats().disk_hits == 0 and cold.stats().misses == sp.n_buckets
    assert f32 != bf
    warm = plan.ExecutorCache()
    warm.attach_disk(DiskTier(str(tmp_path), device="cpu"), preload=False)
    assert run(torch.bfloat16, warm) == bf
    assert warm.stats().disk_hits == sp.n_buckets and warm.stats().misses == 0
