"""repro_torch placements (ROADMAP A5) against the JAX package.

A placement's shards lie on repeated CPU devices (``["cpu"] * n``), the
counterpart of the reference's faked host devices.  The oracle is the
reference's single-device ``run_plan(digest=True)``: its multi-device
tests do not run on this jax.  Placed gathers and stores must give its
digests (a store whose payload holds ``-0.0`` included: the port's combine
selects by the coverage map); placed adds are held within
``add_error_bound`` of its launch output.  The coverage store's plain
version must equal the reference's ``with_covered`` kernel in interpret
mode bit for bit; the geometry, the placement strings and the cost
model's choices must equal the reference's.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import cost as j_cost
from repro.core import pattern as j_pattern
from repro.core import plan as j_plan
from repro.kernels.scatter_rows import ops as j_scatter
from repro_torch import appdb, backends, cost, pattern, plan
from repro_torch.__main__ import main as cli
from repro_torch.diskcache import DiskTier, exec_key_str
from repro_torch.engine import GSEngine
from repro_torch.host import keep_last_mask, make_host_buffers
from repro_torch.kernels.scatter_rows import ops as scatter_ops
from repro_torch.kernels.scatter_rows.ref import (add_error_bound,
                                                  scatter_store_rows_ref_)
from repro_torch.plan import ExecutorCache, Placement, SuitePlan
from repro_torch.serve import ServerError, SpatterClient, SpatterDaemon
from repro_torch.sharding import gs_specs

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
INT32_MAX = np.iinfo(np.int32).max
SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1)]
BACKENDS = ("torch", "hopper")
# the reference's backend playing the same role as each port backend
J_BACKEND = {"torch": "xla", "hopper": "pallas"}


def _cpus(shape):
    b, l = shape
    return Placement.create(shape, devices=["cpu"] * (b * l))


def _capped(pats, max_lanes=256, max_footprint=1 << 12):
    """Counts cut so every pattern stays small; shapes are untouched."""
    out = []
    for p in pats:
        count = max(1, min(p.count, max_lanes // p.index_len))
        if p.delta > 0:
            count = max(1, min(count, (max_footprint - p.span) // p.delta))
        out.append(dataclasses.replace(p, count=count))
    return out


def _j(p):
    return j_pattern.Pattern(name=p.name, kind=p.kind, index=p.index,
                             delta=p.delta, count=p.count, source=p.source)


def _suite(name):
    if name == "demo":
        return _capped(pattern.load_suite(str(ROOT / "suites" / "demo.json")))
    # a seeded subset of appdb: its scatters and five of its gathers
    pats = _capped(appdb.ALL_PATTERNS)
    rng = np.random.default_rng(0)
    gathers = [p for p in pats if p.kind == "gather"]
    pick = rng.choice(len(gathers), 5, replace=False)
    return [p for p in pats if p.kind == "scatter"] + \
        [gathers[i] for i in sorted(pick)]


_REF = {}


def _reference(name, mode):
    """The reference's single-device digests and launch outputs (xla)."""
    if (name, mode) not in _REF:
        jp = j_plan.SuitePlan.build([_j(p) for p in _suite(name)])
        works = j_plan.make_work(jp, backend="xla", runs=1, mode=mode,
                                 digest=True)
        digests, outs = {}, {}
        for w in works:
            res = j_plan.launch((w,), j_plan.ExecutorCache())
            for i, (pos, r) in enumerate(j_plan.demux(res, w)):
                digests[pos] = r.out_digest
                outs[pos] = np.asarray(res.out[i])
        _REF[name, mode] = (digests, outs)
    return _REF[name, mode]


# ---------------------------------------------------------------------------
# geometry, strings and axis rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 9, 100, 1000])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 6, 8])
def test_pad_helpers_match_reference(n, shards):
    assert plan.pad_batch(n, shards) == j_plan.pad_batch(n, shards)
    assert plan.pad_lanes(n, shards) == j_plan.pad_lanes(n, shards)


@pytest.mark.parametrize("shape,want", [
    (1, "data=1/1dev"), (8, "data=8/8dev"), ((8, 1), "data=8/8dev"),
    ((1, 8), "lane:lane=8/8dev"), ((4, 2), "data=4xlane=2/8dev"),
    ((2, 3), "data=2xlane=3/6dev")])
def test_placement_strings_and_parsers_match_reference(shape, want):
    b, l = (shape, 1) if isinstance(shape, int) else shape
    pl = Placement.create(shape, devices=["cpu"] * (b * l))
    assert pl.placement == want and pl.grid == (b, l)
    for s in (want, ""):
        assert plan.placement_grid(s) == j_plan.placement_grid(s)
        assert plan.placement_axes(s) == j_plan.placement_axes(s)
    assert plan.placement_grid(want) == (b, l, b * l)


def test_single_device_placement_string_equals_the_reference_object():
    # the reference can build a placement over its one CPU device here
    assert Placement.create(1, devices=["cpu"]).placement == \
        j_plan.Placement.create(1).placement


@pytest.mark.parametrize("kind", ["gather", "scatter"])
@pytest.mark.parametrize("axes", [("data", None), (None, "lane"),
                                  ("data", "lane")])
def test_axis_rules_match_reference(kind, axes):
    from repro.runtime.sharding import gs_specs as j_gs_specs
    b, l = axes
    for batched in (True, False):
        if not batched and b is not None:
            with pytest.raises(ValueError):
                gs_specs(kind, batched=False, batch_axis=b, lane_axis=l)
            continue
        got = gs_specs(kind, batched=batched, batch_axis=b, lane_axis=l)
        want = j_gs_specs(kind, batched=batched, batch_axis=b, lane_axis=l)
        assert [tuple(s) for s in want[0]] == list(got[0])
        assert tuple(want[1]) == got[1]


@pytest.mark.parametrize("name", ["demo", "apps", "widelane", "appdb"])
def test_pad_waste_matches_reference(name):
    pats = (appdb.ALL_PATTERNS if name == "appdb" else
            pattern.load_suite(str(ROOT / "suites" / f"{name}.json")))
    mine = SuitePlan.build(pats)
    ref = j_plan.SuitePlan.build([_j(p) for p in pats])
    for grid in [(1, 1), (2, 1), (1, 2), (2, 2), (1, 3), (4, 2)]:
        assert mine.pad_waste(*grid) == pytest.approx(ref.pad_waste(*grid))
    grids = [(1, 2) if i % 2 else (2, 1) for i in range(mine.n_buckets)]
    assert mine.pad_waste_for(
        [_cpus(g) for g in grids]) == pytest.approx(ref.pad_waste_for(
            [_JGrid(g) for g in grids]))


@dataclasses.dataclass
class _JGrid:
    """What the reference's ``pad_waste_for`` reads of a placement."""
    grid: tuple


def test_create_never_runs_on_fewer_devices():
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        Placement.create((2, 2), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="needs 2 devices, have 0 CUDA"):
        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA devices")
        Placement.create(2)
    pl = Placement.create(2, devices=["cpu"] * 5)
    assert len(pl.devices) == 2 and pl.placement == "data=2/2dev"
    with pytest.raises(ValueError, match="devices"):
        Placement(devices=("cpu",), grid=(1, 2), batch_axis=None,
                  lane_axis="lane")


# ---------------------------------------------------------------------------
# the coverage store against the reference's with_covered kernel
# ---------------------------------------------------------------------------

def _store_inputs(b, v, d, n, seed, kernel=True, neg_zero=False):
    """dst, idx, vals, keep: duplicates dropped by the keep mask; with
    ``kernel`` (the store kernel's contract, wider than the other
    backends') also out-of-range and negative lanes and kept lanes turned
    off; with ``neg_zero`` -0.0 payloads."""
    rng = np.random.default_rng(seed)
    dst = rng.standard_normal((b, v, d), dtype=np.float32)
    idx = rng.integers(0, v, (b, n), dtype=np.int32)
    if kernel:
        idx[:, :3] = np.array([INT32_MAX, -1, v], np.int32)[:min(3, n)]
    vals = rng.standard_normal((b, n, d), dtype=np.float32)
    if neg_zero:
        vals[:, 1::5] = -0.0
    keep = np.stack([keep_last_mask(row) for row in idx])
    if kernel:
        keep &= rng.random((b, n)) > 0.1
    return dst, idx, vals, keep


def _reference_with_covered(dst, idx, vals, keep):
    safe = np.where(keep, idx, INT32_MAX).astype(np.int32)
    out, cov = j_scatter.scatter_store_rows_batched(
        jnp.asarray(dst), jnp.asarray(safe), jnp.asarray(vals),
        with_covered=True, interpret=True)
    return np.asarray(out), np.asarray(cov)


def _store_with_coverage(store, dst, idx, vals, keep):
    out = torch.from_numpy(dst.copy())
    cov = torch.zeros(dst.shape[:2], dtype=torch.int32)
    store(out, torch.from_numpy(idx), torch.from_numpy(keep),
          torch.from_numpy(vals), cov)
    assert cov.dtype == torch.int32
    return out.numpy(), cov.numpy()


@pytest.mark.parametrize("b,v,d,n", [(1, 40, 1, 5), (3, 40, 3, 100),
                                     (2, 300, 17, 130), (3, 64, 8, 513)])
def test_coverage_store_equals_reference_with_covered(b, v, d, n):
    dst, idx, vals, keep = _store_inputs(b, v, d, n, seed=b * n)
    want_out, want_cov = _reference_with_covered(dst, idx, vals, keep)
    for store in (scatter_store_rows_ref_, scatter_ops.scatter_store_rows_):
        out, cov = _store_with_coverage(store, dst, idx, vals, keep)
        assert out.tobytes() == want_out.tobytes()
        assert cov.tobytes() == want_cov.tobytes()


def test_coverage_store_keeps_negative_zero_the_reference_drops():
    # the reference's store is a one-hot contraction: 1 * (-0.0) summed
    # with the other rows' +0.0 products is +0.0.  The port stores the
    # payload itself, as the reference's xla store does; the coverage
    # maps agree
    b, v, d, n = 3, 64, 8, 513
    dst, idx, vals, keep = _store_inputs(b, v, d, n, seed=3, neg_zero=True)
    want_out, want_cov = _reference_with_covered(dst, idx, vals, keep)
    out, cov = _store_with_coverage(scatter_store_rows_ref_, dst, idx, vals,
                                    keep)
    assert cov.tobytes() == want_cov.tobytes()
    assert np.array_equal(out, want_out)             # equal as numbers
    differ = np.signbit(out) != np.signbit(want_out)
    assert differ.any() and (out[differ] == 0).all()
    assert np.signbit(out[differ]).all()


@pytest.mark.parametrize("backend", backends.BACKENDS)
def test_every_backend_stores_with_coverage(backend):
    b, v, d, n = 3, 40, 3, 100
    dst, idx, vals, keep = _store_inputs(b, v, d, n, seed=1, kernel=False)
    want_out, want_cov = _reference_with_covered(dst, idx, vals, keep)

    def store(out, idx, keep, vals, cov):
        backends.scatter_batched(out, idx, vals, mode="store",
                                 backend=backend, keep=keep, cov=cov)
    out, cov = _store_with_coverage(store, dst, idx, vals, keep)
    assert out.tobytes() == want_out.tobytes()
    assert cov.tobytes() == want_cov.tobytes()


def test_coverage_store_checks_its_operand():
    dst = torch.zeros(2, 8, 1)
    idx = torch.zeros(2, 4, dtype=torch.int32)
    keep = torch.ones(2, 4, dtype=torch.bool)
    vals = torch.ones(2, 4, 1)
    for bad in (torch.zeros(2, 8), torch.zeros(2, 7, dtype=torch.int32),
                torch.zeros(1, 8, dtype=torch.int32)):
        with pytest.raises((TypeError, ValueError)):
            scatter_ops.scatter_store_rows_(dst, idx, keep, vals, bad)
    with pytest.raises(ValueError, match="store"):
        backends.scatter_batched(dst, idx, vals, mode="add", keep=keep,
                                 cov=torch.zeros(2, 8, dtype=torch.int32))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (1, 3)])
@pytest.mark.parametrize("backend", backends.BACKENDS)
def test_lane_split_store_keeps_negative_zero(shape, backend):
    # a lane-split store equals the backend's one-device store bit for
    # bit.  Its shards store into zeros: a psum of them (the reference's
    # combine) would turn -0.0 into +0.0, the port's select does not
    b, v, d, n = 2, 64, 3, 96
    _, idx, vals, keep = _store_inputs(b, v, d, n, seed=7, neg_zero=True,
                                       kernel=backend == "hopper")
    fn = plan._bucket_fn(backend, "scatter", "store")
    t_idx, t_vals, t_keep = (torch.from_numpy(a) for a in (idx, vals, keep))
    want = fn(torch.zeros(b, v, d), t_idx, t_vals, t_keep)
    pl = _cpus(shape)
    shards = pl.place("scatter", [t_idx, t_vals, t_keep])
    dst = torch.zeros(b, v, d)
    scratch = pl.scratch("store", dst)
    got = pl.run(fn, "scatter", "store", shards, scratch, dst)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    if backend != "onehot":             # its one-hot product drops -0.0 too
        assert (torch.signbit(want) & (want == 0)).any()
        # (the scalar backend writes every lane of a shard, kept or not:
        # only the select, not a sum, recovers its rows)
        if pl.batch_shards == 1 and backend != "scalar":
            summed = sum(out for out, _ in scratch)       # the psum form
            assert torch.equal(summed, want)
            assert not torch.equal(torch.signbit(summed),
                                   torch.signbit(want))


# ---------------------------------------------------------------------------
# placed suites against the reference's single-device digests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["demo", "appdb"])
def test_placed_gathers_and_stores_give_reference_digests(shape, backend,
                                                          name):
    pats = _suite(name)
    want, _ = _reference(name, "store")
    res = plan.run_plan(SuitePlan.build(pats), backend=backend, runs=1,
                        digest=True, device="cpu", mesh=_cpus(shape),
                        cache=ExecutorCache())
    assert [r.out_digest for r in res] == [want[i] for i in range(len(pats))]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["demo", "appdb"])
def test_placed_adds_within_bound_of_reference(shape, backend, name):
    pats = _suite(name)
    want_dg, want_out = _reference(name, "add")
    works = plan.make_work(SuitePlan.build(pats), backend=backend, runs=1,
                           mode="add", digest=True, device="cpu",
                           mesh=_cpus(shape))
    cache = ExecutorCache()
    for work in works:
        assert work.placement.grid == shape
        res = plan.launch((work,), cache)
        assert res.key.placement == work.placement.placement
        for i, (pos, r) in enumerate(plan.demux(res, work)):
            p = work.patterns[i]
            if p.kind == "gather":
                assert r.out_digest == want_dg[pos]
                continue
            got = res.out[i, :p.footprint()].double().numpy()
            ref = want_out[pos][:p.footprint()].astype(np.float64)
            _, idx, vals, _ = make_host_buffers(p, 1, seed=0)
            bound = add_error_bound(torch.from_numpy(idx)[None],
                                    torch.from_numpy(vals)[None],
                                    p.footprint())[0].numpy()
            assert np.all(np.abs(got - ref) <= bound), p.name


def test_non_pow2_lane_split_pads_lanes_and_keeps_digests():
    pats = _suite("demo")
    want, _ = _reference("demo", "store")
    res = plan.run_plan(SuitePlan.build(pats), backend="hopper", runs=1,
                        digest=True, device="cpu", mesh=_cpus((2, 3)),
                        cache=ExecutorCache())
    assert [r.out_digest for r in res] == [want[i] for i in range(len(pats))]


def test_placed_and_unplaced_keys_never_collide():
    sp = SuitePlan.build(_suite("demo"))
    cache = ExecutorCache()
    keys = {}
    for mesh in (None, _cpus((1, 2)), _cpus((2, 1)), _cpus((2, 2))):
        before = cache.stats()
        plan.run_plan(sp, backend="hopper", runs=1, device="cpu", mesh=mesh,
                      cache=cache)
        assert cache.stats().delta(before).misses == sp.n_buckets
        before = cache.stats()
        plan.run_plan(sp, backend="hopper", runs=1, device="cpu", mesh=mesh,
                      cache=cache)
        assert cache.stats().delta(before).misses == 0     # warm repeat
        works = plan.make_work(sp, backend="hopper", device="cpu",
                               mesh=mesh)
        keys[mesh.placement if mesh else ""] = {w.family for w in works}
    fams = list(keys.values())
    assert all(not (a & b) for i, a in enumerate(fams) for b in fams[i + 1:])
    assert len(cache) == 4 * sp.n_buckets


def test_run_suite_mesh_forms_and_rules():
    from repro_torch.suite import run_suite
    pats = _suite("demo")
    want, _ = _reference("demo", "store")
    for mesh in ("auto", "auto-suite", 1, (1, 1)):
        st = run_suite(pats, backend="hopper", runs=1, digest=True,
                       device="cpu", mesh=mesh, cache=ExecutorCache())
        assert [r.out_digest for r in st.results] == \
            [want[i] for i in range(len(pats))]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        run_suite(pats, runs=1, device="cpu", mesh=2)
    with pytest.raises(ValueError, match="batched planner"):
        run_suite(pats, runs=1, device="cpu", mesh=_cpus((1, 2)),
                  batch=False)
    with pytest.raises(ValueError, match="mesh string"):
        run_suite(pats, runs=1, device="cpu", mesh="turbo")


def test_gsengine_sharded_is_lane_only_and_exact():
    for kind in ("gather", "scatter"):
        p = pattern.make_pattern("UNIFORM:8:4", kind=kind, delta=2,
                                 count=32)
        eng = GSEngine(p, backend="hopper", device="cpu")
        fn, args = eng.build()
        want = fn(*args).clone()
        for shape in ((1, 2), (1, 4)):
            sfn, sargs = eng.sharded(_cpus(shape))
            assert sfn(*sargs).numpy().tobytes() == want.numpy().tobytes()
        for shape in ((2, 1), (2, 2), 1):
            with pytest.raises(ValueError, match="lane-only"):
                eng.sharded(_cpus(shape if shape != 1 else (1, 1)))
        with pytest.raises(ValueError, match="divisible"):
            eng.sharded(_cpus((1, 3)))


# ---------------------------------------------------------------------------
# the cost model and auto placements against the reference
# ---------------------------------------------------------------------------

def _geometry_plans():
    out = {}
    for name in ("demo", "apps", "widelane"):
        out[name] = pattern.load_suite(str(ROOT / "suites" / f"{name}.json"))
    out["appdb"] = appdb.ALL_PATTERNS
    return out


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("backend", BACKENDS + ("onehot",))
def test_select_shape_and_auto_placements_match_reference(n_dev, backend):
    jb = J_BACKEND.get(backend, backend)
    for pats in _geometry_plans().values():
        mine = SuitePlan.build(pats)
        ref = j_plan.SuitePlan.build([_j(p) for p in pats])
        assert cost.candidate_shapes(n_dev) == j_cost.candidate_shapes(n_dev)
        assert cost.select_shape(mine, n_devices=n_dev, backend=backend) == \
            j_cost.select_shape(ref, n_devices=n_dev, backend=jb)
        for shape in j_cost.candidate_shapes(n_dev):
            a = cost.shape_cost(mine, shape, backend=backend)
            b = j_cost.shape_cost(ref, shape, backend=jb)
            assert a == b
        devices = ["cpu"] * n_dev
        per_bucket = plan.auto_placements(mine, "auto", backend=backend,
                                          devices=devices)
        for bucket, pl in zip(ref.buckets, per_bucket):
            sub = j_plan.SuitePlan(
                patterns=tuple(ref.patterns[i] for i in bucket.members),
                buckets=(j_plan.Bucket(spec=bucket.spec, members=tuple(
                    range(len(bucket.members)))),))
            want = j_cost.auto_placement(sub, n_devices=n_dev, backend=jb)
            assert (pl.grid if pl else None) == want
        suite = plan.auto_placements(mine, "auto-suite", backend=backend,
                                     devices=devices)
        want = j_cost.auto_placement(ref, n_devices=n_dev, backend=jb)
        assert (suite.grid if suite else None) == want
        if n_dev == 1:
            assert per_bucket == [None] * mine.n_buckets and suite is None


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (4, 2)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_key_cost_matches_reference(shape, backend):
    sp = SuitePlan.build(_suite("demo"))
    jp = j_plan.SuitePlan.build([_j(p) for p in _suite("demo")])
    b, l = shape
    pl = None if shape == (1, 1) else _cpus(shape)
    jb = J_BACKEND[backend]
    for bucket, jbucket in zip(sp.buckets, jp.buckets):
        key = plan.bucket_key(backend, bucket.spec, torch.float32, 1,
                              "store", len(bucket.members), pl)
        jkey = j_plan.ExecKey(
            backend=jb, kind=key.kind, idx_len=key.idx_len,
            footprint=key.footprint, dtype="float32", row_width=1,
            mode=key.mode, batch=key.batch, placement=key.placement)
        real = sum(p.count * p.index_len
                   for p in (sp.patterns[i] for i in bucket.members))
        got = dataclasses.asdict(cost.key_cost(key, real_elems=real))
        want = j_cost.key_cost(jkey, real_elems=real).to_json()
        for field, value in got.items():
            if field not in ("exec_key", "backend"):
                assert value == want[field], field


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_mesh_beyond_the_devices_names_the_count(capsys):
    with pytest.raises(SystemExit):
        cli(["--json", str(ROOT / "suites" / "demo.json"), "--device", "cpu",
             "-r", "1", "--mesh", "2"])
    assert "needs 2 devices, have 1" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli(["-p", "UNIFORM:8:1", "-l", "16", "--device", "cpu", "--mesh",
             "2"])
    assert "--json" in capsys.readouterr().err


def test_cli_mesh_auto_prints_each_bucket(tmp_path, capsys):
    suite = tmp_path / "s.json"
    suite.write_text(pattern.dump_suite(_suite("demo")))
    stats = cli(["--json", str(suite), "--device", "cpu", "-r", "1", "-b",
                 "hopper", "--mesh", "auto"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("mesh :")]
    assert len(lines) == stats.plan.n_buckets
    assert all(ln.endswith(": single") for ln in lines)


# ---------------------------------------------------------------------------
# spatterd over repeated CPU devices, the locks, the disk key
# ---------------------------------------------------------------------------

DEMO = json.loads((ROOT / "suites" / "demo.json").read_text())


def _digests(resp):
    return [t["digest"] for t in resp["stats"]["table"]]


@pytest.mark.parametrize("workers", [0, 2])
def test_daemon_places_over_its_devices(workers):
    small = [dict(d, count=min(d["count"], 64)) for d in DEMO]
    with SpatterDaemon(port=0, cache=ExecutorCache(), device="cpu",
                       devices=["cpu"] * 2, workers=workers) as d:
        c = SpatterClient(d.url)
        assert c.health()["n_devices"] == 2
        r0 = c.run_suite(small, backend="hopper", runs=1, mesh=1)
        for mesh, want in ((2, "data=2/2dev"), ([1, 2], "lane:lane=2/2dev"),
                           ([2, 1], "data=2/2dev")):
            r = c.run_suite(small, backend="hopper", runs=1, mesh=mesh)
            assert r["ok"] and _digests(r) == _digests(r0)
            assert r["plan"]["placement"] == want
        for mesh in ("auto", 0, "auto-suite"):
            r = c.run_suite(small, backend="hopper", runs=1, mesh=mesh)
            assert _digests(r) == _digests(r0)
            names = r["plan"]["placement"]
            names = names if isinstance(names, list) else [names]
            assert set(names) <= {"single", "data=2/2dev",
                                  "lane:lane=2/2dev"}
        warm = c.run_suite(small, backend="hopper", runs=1, mesh=[1, 2])
        assert warm["cache"]["misses"] == 0
        for mesh in (4, [2, 2], [1, 3]):
            with pytest.raises(ServerError) as e:
                c.run_suite(small, runs=1, mesh=mesh)
            assert e.value.status == 400
            assert "have 2 devices listed" in str(e.value)
        w = c.warm(small, backend="hopper", mesh=[2, 1])
        assert w["ok"] and w["cache"]["misses"] == 0


def test_daemon_placed_keys_restore_from_disk(tmp_path):
    small = [dict(d, count=min(d["count"], 64)) for d in DEMO]
    kw = dict(port=0, device="cpu", devices=["cpu"] * 2,
              cache_dir=str(tmp_path))
    with SpatterDaemon(cache=ExecutorCache(), **kw) as d:
        r1 = SpatterClient(d.url).run_suite(small, backend="hopper", runs=1,
                                            mesh=[1, 2])
    with SpatterDaemon(cache=ExecutorCache(), **kw) as d:
        r2 = SpatterClient(d.url).run_suite(small, backend="hopper", runs=1,
                                            mesh=[1, 2])
    assert r1["cache"]["misses"] == r1["plan"]["n_buckets"]
    assert r2["cache"]["misses"] == 0 and _digests(r1) == _digests(r2)


def test_device_locks_take_one_order(monkeypatch):
    taken = []
    real = plan.device_lock

    def recording(name):
        taken.append(name)
        return real(name)
    monkeypatch.setattr(plan, "device_lock", recording)
    for devices in (["cpu:0", "cpu"], ["cpu", "cpu:0", "cpu"]):
        taken.clear()
        with plan.device_locks(devices):
            pass
        assert taken == ["cpu", "cpu:0"]


def test_opposite_placements_in_two_threads_finish():
    # "cpu" and "cpu:0" name one device two ways, so they are two locks:
    # launches over [d0, d1] and [d1, d0] must not wait on each other
    sp = SuitePlan.build(_suite("demo"))
    cache = ExecutorCache()
    meshes = [Placement.create((1, 2), devices=devs)
              for devs in (["cpu", "cpu:0"], ["cpu:0", "cpu"])]
    errors = []

    def worker(mesh):
        try:
            for _ in range(20):
                plan.run_plan(sp, backend="hopper", runs=1, device="cpu",
                              mesh=mesh, cache=cache)
        except BaseException as e:      # reported by the main thread
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(m,)) for m in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "placed launches hung"
    assert not errors, errors


def test_single_device_exec_key_string_is_unchanged():
    key = plan.ExecKey(backend="hopper", kind="scatter", idx_len=64,
                       footprint=128, dtype="float32", row_width=1,
                       mode="store", batch=2)
    assert exec_key_str(key) == (
        "backend=hopper|kind=scatter|idx_len=64|footprint=128|"
        "dtype=float32|row_width=1|mode=store|batch=2")
    placed = dataclasses.replace(key, placement="lane:lane=2/2dev")
    assert exec_key_str(placed) == exec_key_str(key) + \
        "|placement=lane:lane=2/2dev"


def test_placed_entry_has_its_own_file(tmp_path):
    tier = DiskTier(str(tmp_path), device="cpu")
    key = plan.ExecKey(backend="torch", kind="gather", idx_len=64,
                       footprint=128, dtype="float32", row_width=1, mode="",
                       batch=2)
    placed = dataclasses.replace(key, placement="data=2/2dev")
    assert tier.path_for(key) != tier.path_for(placed)
    fn = plan._bucket_fn("torch", "gather", "")
    assert tier.store(key, fn) and tier.store(placed, fn)
    assert {k for k, _ in tier.load_all()} == {key, placed}


def test_new_modules_import_without_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import repro_torch, repro_torch.cost, repro_torch.sharding, "
            "repro_torch.plan, repro_torch.engine, repro_torch.suite, "
            "repro_torch.serve.daemon, repro_torch.__main__; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')); "
            "assert not bad, bad; print('OK')" % SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
