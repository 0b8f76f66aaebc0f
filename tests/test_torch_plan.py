"""repro_torch planner, suite runner and CLI against the JAX package.

The oracle is the reference's per-pattern output digest
(``repro.core.plan.run_plan(digest=True)``): for gathers and store-mode
scatters every port backend must give the same sha256.  Add mode differs
in summation order, so it is held to ``add_error_bound`` instead (see
tests/test_torch_kernels.py for the bound's derivation).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import pattern as j_pattern
from repro.core import plan as j_plan
from repro_torch import appdb, pattern, plan, suite
from repro_torch.__main__ import main as cli
from repro_torch.host import make_host_buffers
from repro_torch.kernels.scatter_rows.ref import add_error_bound

ROOT = Path(__file__).resolve().parent.parent
SUITES = ("demo", "apps", "widelane")
BACKENDS = ("torch", "onehot", "scalar", "hopper")


def _capped(pats, max_lanes=256, max_footprint=1 << 12):
    """Counts cut so every pattern stays small; shapes are untouched."""
    out = []
    for p in pats:
        count = max(1, min(p.count, max_lanes // p.index_len))
        if p.delta > 0:
            count = max(1, min(count, (max_footprint - p.span) // p.delta))
        out.append(dataclasses.replace(p, count=count))
    return out


def _suite(name, capped=True):
    pats = (appdb.ALL_PATTERNS if name == "appdb" else
            pattern.load_suite(str(ROOT / "suites" / f"{name}.json")))
    return _capped(pats) if capped else pats


def _j(p):
    return j_pattern.Pattern(name=p.name, kind=p.kind, index=p.index,
                             delta=p.delta, count=p.count, source=p.source)


_REF_DIGESTS = {}


def _ref_digests(name):
    """JAX ``run_plan(backend="xla", digest=True)`` digests, once per suite."""
    if name not in _REF_DIGESTS:
        pats = [_j(p) for p in _suite(name)]
        res = j_plan.run_plan(j_plan.SuitePlan.build(pats), backend="xla",
                              runs=1, digest=True,
                              cache=j_plan.ExecutorCache())
        _REF_DIGESTS[name] = [r.out_digest for r in res]
    return _REF_DIGESTS[name]


@pytest.mark.parametrize("name", SUITES + ("appdb",))
@pytest.mark.parametrize("capped", [True, False])
def test_buckets_match_reference(name, capped):
    pats = _suite(name, capped)
    mine = plan.SuitePlan.build(pats)
    ref = j_plan.SuitePlan.build([_j(p) for p in pats])
    assert [(b.spec.kind, b.spec.idx_len, b.spec.footprint, b.members)
            for b in mine.buckets] == \
        [(b.spec.kind, b.spec.idx_len, b.spec.footprint, b.members)
         for b in ref.buckets]
    assert mine.pad_waste() == pytest.approx(ref.pad_waste())
    if name == "demo" and not capped:
        assert (len(pats), mine.n_buckets) == (10, 4)


def test_pad_helpers_match_reference():
    for n in range(1, 300):
        assert plan.next_pow2(n) == j_plan.next_pow2(n)
        for shards in (1, 3, 4):
            assert plan.pad_batch(n, shards) == j_plan.pad_batch(n, shards)
            assert plan.pad_lanes(n, shards) == j_plan.pad_lanes(n, shards)


@pytest.mark.parametrize("name", SUITES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_digests_equal_reference(name, backend):
    pats = _suite(name)
    res = plan.run_plan(plan.SuitePlan.build(pats), backend=backend, runs=1,
                        digest=True, device="cpu",
                        cache=plan.ExecutorCache())
    assert [r.out_digest for r in res] == _ref_digests(name)
    assert all(r.device == "cpu" and r.time_s > 0 for r in res)


@pytest.mark.parametrize("backend", BACKENDS)
def test_add_mode_within_bound_of_reference(backend):
    pats = _suite("demo")
    mine = plan.SuitePlan.build(pats)
    ref = j_plan.SuitePlan.build([_j(p) for p in pats])
    works = plan.make_work(mine, backend=backend, runs=1, mode="add",
                           digest=True, device="cpu")
    for work, bucket in zip(works, ref.buckets):
        res = plan.launch((work,), plan.ExecutorCache())
        want = j_plan.execute_bucket(ref, bucket, backend="xla", mode="add",
                                     cache=j_plan.ExecutorCache())
        for i, p in enumerate(work.patterns):
            n = res.real_lanes[i] if p.kind == "gather" else p.footprint()
            got = res.out[i, :n].numpy()
            if p.kind == "gather":
                assert got.tobytes() == np.asarray(want[i]).tobytes()
                continue
            _, idx, vals, _ = make_host_buffers(p, 1, seed=0)
            bound = add_error_bound(torch.from_numpy(idx)[None],
                                    torch.from_numpy(vals)[None],
                                    p.footprint())[0].numpy()
            assert np.all(np.abs(got.astype(np.float64) - want[i]) <= bound)


def test_second_identical_run_builds_nothing():
    cache = plan.ExecutorCache()
    sp = plan.SuitePlan.build(_suite("apps"))
    first = plan.run_plan(sp, backend="hopper", runs=1, digest=True,
                          cache=cache, device="cpu")
    s1 = cache.stats()
    assert s1.misses == sp.n_buckets and s1.hits == 0
    second = plan.run_plan(sp, backend="hopper", runs=1, digest=True,
                           cache=cache, device="cpu")
    d = cache.stats().delta(s1)
    assert (d.misses, d.hits, d.size) == (0, sp.n_buckets, 0)
    assert [r.out_digest for r in first] == [r.out_digest for r in second]


def test_shrunk_bucket_reuses_larger_batch():
    cache = plan.ExecutorCache()
    pats = _suite("demo")[1:5]                 # one gather bucket, 4 members
    plan.run_plan(plan.SuitePlan.build(pats), runs=1, cache=cache,
                  device="cpu")
    before = cache.stats()
    res = plan.run_plan(plan.SuitePlan.build(pats[:2]), runs=1, cache=cache,
                        device="cpu", digest=True)
    d = cache.stats().delta(before)
    assert (d.misses, d.hits, d.batch_hits) == (0, 1, 1)   # 2 -> warm 4
    plan.run_plan(plan.SuitePlan.build(pats[:3]), runs=1, cache=cache,
                  device="cpu")
    d = cache.stats().delta(before)
    assert (d.misses, d.hits, d.batch_hits) == (0, 2, 1)   # 3 -> batch 4
    ref = j_plan.run_plan(j_plan.SuitePlan.build([_j(p) for p in pats[:2]]),
                          runs=1, digest=True, cache=j_plan.ExecutorCache())
    assert [r.out_digest for r in res] == [r.out_digest for r in ref]


def test_cache_lru_evicts_and_counts():
    cache = plan.ExecutorCache(maxsize=2)
    keys = [plan.ExecKey("torch", "gather", 8, 8, "float32", 1, "", b)
            for b in (1, 2, 4)]
    for k in keys:
        fn, served, built = cache.serve_poly_info(k, lambda: (lambda: None))
        assert (served, built) == (k, True)
    assert len(cache) == 2 and cache.stats().misses == 3
    assert cache.best_batch(keys[0]) == keys[1]            # 1 evicted
    cache.clear()
    assert cache.stats() == plan.CacheStats(0, 0, 0, 0)


def test_demux_attributes_time_by_lane_share():
    sp = plan.SuitePlan.build(_suite("demo")[1:4])          # 3 members -> 4
    (work,) = plan.make_work(sp, runs=1, device="cpu")
    res = plan.launch((work,))
    out = plan.demux(res, work)
    assert res.batch == 4 and res.n_members == 3
    total = sum(r.time_s for _, r in out)
    assert total == pytest.approx(res.t_bucket * 3 / 4)
    assert [pos for pos, _ in out] == list(work.positions)


def test_run_suite_on_cpu():
    pats = _suite("demo")
    st = suite.run_suite(pats, runs=2, device="cpu", stream_r=True,
                         stream_n=1 << 12)
    assert len(st.results) == 10 and st.plan.n_buckets == 4
    assert 0 < st.min_gbs <= st.hmean_gbs <= st.max_gbs
    assert st.stream_gbs > 0 and st.stream_r is None
    doc = json.loads(json.dumps(st.to_json()))
    assert doc["device"] == "cpu" and doc["stream_r"] is None
    assert doc["table"][0]["gbs"] == st.results[0].measured_gbs
    per = suite.run_suite(pats, runs=1, device="cpu", batch=False)
    assert per.plan is None and len(per.results) == 10
    with pytest.raises(ValueError, match="digest"):
        suite.run_suite(pats, device="cpu", batch=False, digest=True)
    with pytest.raises(ValueError, match="metric"):
        suite.run_suite(pats, device="cpu", metric="modeled")
    with pytest.raises(ValueError, match="mode"):
        suite.run_suite(pats, device="cpu", mode="max")


def test_engine_runs_every_backend_on_cpu():
    from repro_torch import GSEngine
    for kind in ("gather", "scatter"):
        p = pattern.make_pattern("UNIFORM:8:2", kind=kind, delta=8, count=16)
        for backend in BACKENDS:
            for mode in ("store", "add"):
                r = GSEngine(p, backend=backend, mode=mode, row_width=3,
                             device="cpu").run(runs=2)
                assert r.time_s > 0 and r.elem_bytes == 12
                assert r.row()["device"] == "cpu"


@pytest.mark.parametrize("argv", [
    ["-l", "256", "-r", "2"],
    ["-k", "Scatter", "-p", "BROADCAST:8:4", "-l", "256", "--mode", "add",
     "-b", "hopper", "--row-width", "3"],
    ["--json", "suites/demo.json", "-r", "1", "-b", "hopper"],
    ["--json", "suites/widelane.json", "-r", "1", "--no-batch"],
    ["--json", "suites/demo.json", "-r", "1", "--stream-r"],
])
def test_cli_runs_on_cpu(argv, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    out = cli(["--device", "cpu"] + argv)
    text = capsys.readouterr().out
    assert "cpu" in text and "GB/s" in text
    if "--json" in argv:
        assert isinstance(out, suite.SuiteStats)
        assert ("shape buckets" in text) == ("--no-batch" not in argv)
    else:
        assert out.time_s > 0


def test_cli_rejects_bad_options(capsys):
    for argv in (["-r", "0"], ["--stream-r"], ["-b", "pallas"]):
        with pytest.raises(SystemExit):
            cli(["--device", "cpu"] + argv)
