"""repro_torch.analysis (spatterlint on the port) against repro.analysis.

Every rule of the reference's registry has its port rule (the three that
read a jaxpr or HLO there read the census here), and each fires on a
synthetic unit made to break it, as the reference's ``test_rule_fires_*``
do.  On the CPU the hopper backend runs its kernels' plain versions,
which launch nothing and index by masks, so the launch and host-sync
rules bind only censuses taken on a card: here they fire on real
censuses of poisoned callables relabelled as a card's.  The suites lint
clean, the enumerated keys equal the live cache's, spatterd's ``/lint``
and ``/cost`` leave the cache's counters and the launch counts as they
were, and the two packages' reports parse in each other's ``from_json``.
All comparisons here are exact.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import ast_lint as j_ast_lint
from repro.analysis import report as j_report
from repro.analysis import rules as j_rules
from repro_torch import pattern
from repro_torch.__main__ import main as cli
from repro_torch.analysis import ast_lint, census, cost, lint, rules
from repro_torch.analysis.__main__ import main as matrix
from repro_torch.analysis.__main__ import parse_devices
from repro_torch.analysis.report import LintReport, Violation
from repro_torch.kernels import _build
from repro_torch.plan import (ExecKey, ExecutorCache, Placement, SuitePlan,
                             enumerate_executables, run_plan)
from repro_torch.serve import SpatterClient, SpatterDaemon

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
SUITES = ("demo", "apps", "widelane")
# the reference's rules that read a jaxpr or HLO, and the port rule that
# reads the census for the same invariant; every other name is shared
RENAMED = {
    "single-pallas-call-per-bucket": "single-kernel-launch-per-bucket",
    "no-host-callback-or-device-put-in-timed-region":
        "no-host-sync-in-timed-region",
    "donation-honored": "held-operands-unchanged",
}
SMALL = [{"name": "g", "kernel": "Gather", "pattern": "UNIFORM:4:1",
          "delta": 4, "count": 16},
         {"name": "s", "kernel": "Scatter", "pattern": "UNIFORM:4:2",
          "delta": 2, "count": 16}]


def _suite(name):
    return pattern.load_suite(str(ROOT / "suites" / f"{name}.json"))


def _ops(kind="gather", b=1, n=8, f=16):
    idx = torch.zeros((b, n), dtype=torch.int32)
    table = torch.zeros((b, f, 1))
    if kind == "gather":
        return table, idx
    return (table, idx, torch.zeros((b, n, 1)),
            torch.zeros((b, n), dtype=torch.bool))


def _gather(table, idx):
    return table.gather(1, idx.long()[..., None])


def _on_card(unit):
    """The unit with its census relabelled as taken on a card."""
    c = unit.census
    moved = dataclasses.replace(
        c, device="cuda:0",
        calls=tuple(("cuda:0", shapes) for _, shapes in c.calls))
    return dataclasses.replace(unit, _census=moved)


def _fired(unit, name):
    return [v for v in lint.run_rules(unit, [name]) if v.rule == name]


def _key(**kw):
    base = dict(backend="hopper", kind="gather", idx_len=64, footprint=128,
                dtype="float32", row_width=1, mode="", batch=1)
    base.update(kw)
    return ExecKey(**base)


# ---------------------------------------------------------------------------
# the registry against the reference's
# ---------------------------------------------------------------------------

def test_every_reference_rule_has_a_port_rule():
    want = {RENAMED.get(n, n): r.scope for n, r in j_rules.RULES.items()}
    assert {n: r.scope for n, r in rules.RULES.items()} == want


def test_host_sync_rule_names_the_backends_it_binds():
    assert rules.SYNC_FREE_BACKENDS == ("hopper",)
    assert "torch" in rules.SYNC_EXEMPT
    rep = lint.lint_plan(_suite("demo"),
                         backend="torch", device="cpu")
    assert "torch" in rep.meta["exempt"]["no-host-sync-in-timed-region"]
    assert "exempt" not in lint.lint_plan(
        _suite("demo"), backend="hopper", device="cpu").meta


# ---------------------------------------------------------------------------
# each rule fires on a unit made to break it
# ---------------------------------------------------------------------------

def test_rule_fires_no_sort_in_hot_path():
    def sorting(table, idx):
        return _gather(table, torch.sort(idx, dim=1).values)
    unit = lint.unit_for(sorting, _ops(), backend="torch", kind="gather")
    (v,) = _fired(unit, "no-sort-in-hot-path")
    assert "sort x1" in v.location
    assert not _fired(lint.unit_for(_gather, _ops(), backend="torch",
                                    kind="gather"), "no-sort-in-hot-path")


def test_rule_fires_single_kernel_launch_per_bucket():
    one = census.Census(device="cuda:0", launches={"gather_rows": 1},
                        launch_devices=("cuda:0",),
                        calls=(("cuda:0", ((1, 9, 1), (1, 8))),))
    twice = dataclasses.replace(one, launches={"gather_rows": 2},
                                launch_devices=("cuda:0",) * 2)
    unit = lint.unit_for(_gather, _ops(), backend="hopper", kind="gather",
                         census=twice)
    (v,) = _fired(unit, "single-kernel-launch-per-bucket")
    assert "2 kernel launch(es)" in v.message
    assert not _fired(dataclasses.replace(unit, _census=one),
                      "single-kernel-launch-per-bucket")
    # other backends launch none; a lane-split store runs the _cov store
    assert _fired(dataclasses.replace(unit, key=dataclasses.replace(
        unit.key, backend="torch")), "single-kernel-launch-per-bucket")
    key = _key(kind="scatter", mode="store", placement="lane:lane=2/2dev",
               idx_len=8, footprint=8, batch=1)
    shard = ((1, 9, 1), (1, 4), (1, 4, 1), (1, 4), (1, 9))
    cov = census.Census(device="cuda:0",
                        launches={"scatter_store_rows_cov": 2},
                        launch_devices=("cuda:0",) * 2,
                        calls=(("cuda:0", shard),) * 2)
    unit = rules.ExecUnit(key=key, _census=cov)
    assert not _fired(unit, "single-kernel-launch-per-bucket")
    plain = dataclasses.replace(cov, launches={"scatter_store_rows": 2})
    assert _fired(dataclasses.replace(unit, _census=plain),
                  "single-kernel-launch-per-bucket")
    # a census taken on the CPU binds nothing (plain versions launch none)
    assert not _fired(dataclasses.replace(
        unit, _census=dataclasses.replace(twice, device="cpu")),
        "single-kernel-launch-per-bucket")


def test_rule_fires_no_host_sync_in_timed_region():
    def reads_back(table, idx):
        top = int(idx.max().item())
        return _gather(table, idx.clamp(max=top))
    unit = _on_card(lint.unit_for(reads_back, _ops(), backend="hopper",
                                  kind="gather"))
    (v,) = _fired(unit, "no-host-sync-in-timed-region")
    assert "_local_scalar_dense x1" in v.location

    def masked(dst, idx, vals, keep):
        dst[0, idx[0][keep[0]].long()] = vals[0][keep[0]]
        return dst
    unit = _on_card(lint.unit_for(masked, _ops("scatter"), backend="hopper",
                                  kind="scatter", mode="store"))
    (v,) = _fired(unit, "no-host-sync-in-timed-region")
    assert census.MASK_INDEX in v.location
    # the torch backend synchronises by design and is exempt by name; the
    # same census taken on the CPU binds nothing
    assert not _fired(dataclasses.replace(unit, key=dataclasses.replace(
        unit.key, backend="torch")), "no-host-sync-in-timed-region")
    assert not _fired(lint.unit_for(masked, _ops("scatter"),
                                    backend="hopper", kind="scatter",
                                    mode="store"),
                      "no-host-sync-in-timed-region")


def test_rule_fires_held_operands_unchanged():
    def scribbles(dst, idx, vals, keep):
        idx.clamp_(max=0)
        vals.mul_(2)
        return dst
    unit = lint.unit_for(scribbles, _ops("scatter"), backend="torch",
                         kind="scatter", mode="add")
    (v,) = _fired(unit, "held-operands-unchanged")
    assert "idx" in v.message and "vals" in v.message

    def writes_dst(dst, idx, vals, keep):
        return dst.index_add_(1, idx[0].long(), vals)
    assert not _fired(lint.unit_for(writes_dst, _ops("scatter"),
                                    backend="torch", kind="scatter",
                                    mode="add"), "held-operands-unchanged")


def test_rule_fires_no_f64_promotion_drift():
    def promotes(table, idx):
        return _gather(table.double(), idx).float()
    unit = lint.unit_for(promotes, _ops(), backend="torch", kind="gather")
    (v,) = _fired(unit, "no-f64-promotion-drift")
    assert "float64" in v.location
    assert not _fired(lint.unit_for(_gather, _ops(), backend="torch",
                                    kind="gather"), "no-f64-promotion-drift")


def test_rule_fires_sharding_spec_consistency():
    plan = SuitePlan.build(_suite("demo")[:1])
    (key, builder, _), = enumerate_executables(plan, device="cpu")
    unplaced = census.of_key(key, builder(), device="cpu")
    unit = rules.ExecUnit(key=key, _census=unplaced)
    assert not _fired(unit, "sharding-spec-consistency")
    # the key promises two batch shards of two patterns, the call ran one
    placed = dataclasses.replace(key, batch=4, placement="data=2/2dev")
    msgs = [v.message for v in _fired(dataclasses.replace(unit, key=placed),
                                      "sharding-spec-consistency")]
    assert any("1 shard call(s)" in m for m in msgs)
    assert any("idx shapes" in m for m in msgs)
    bad = dataclasses.replace(key, placement="data=2/4dev")
    assert any("does not make 4 devices" in v.message for v in _fired(
        dataclasses.replace(unit, key=bad), "sharding-spec-consistency"))


def test_rule_fires_canonical_exec_key():
    unit = rules.ExecUnit(key=_key(), _census=census.Census(device="cpu"))
    assert not _fired(unit, "canonical-exec-key")
    for bad, field in ((dict(idx_len=63), "idx_len"),
                       (dict(batch=3), "batch"),
                       (dict(dtype="float"), "dtype"),
                       (dict(dtype="torch.float32"), "dtype"),
                       (dict(backend="pallas"), "backend"),
                       (dict(mode="store"), "mode"),
                       (dict(placement="8 devices"), "placement")):
        (v,) = _fired(dataclasses.replace(unit, key=_key(**bad)),
                      "canonical-exec-key")
        assert v.location.startswith(field)


def test_rule_fires_pad_waste_threshold():
    tiny = pattern.make_pattern("UNIFORM:4:1", kind="gather", delta=4,
                                count=1)
    unit = rules.PlanUnit(plan=SuitePlan.build([tiny]), grid=(64, 1),
                          label="tiny @ 64x1")
    (v,) = rules.RULES["pad-waste-threshold"].check(unit)
    assert "exceeds" in v.message
    assert not rules.RULES["pad-waste-threshold"].check(
        dataclasses.replace(unit, grid=(1, 1)))


def test_rule_fires_cache_key_purity():
    keys = iter([[(_key(), None, None)], [(_key(batch=2), None, None)]])
    unit = rules.PlanUnit(plan=None, grid=(1, 1), label="drift",
                          enumerate=lambda: next(keys))
    (v,) = rules.RULES["cache-key-purity"].check(unit)
    assert "different ExecKeys" in v.message
    odd = _key(placement=object())
    unit = rules.PlanUnit(plan=None, grid=(1, 1), label="identity",
                          enumerate=lambda: [(odd, None, None)])
    assert any("not str/int" in v.message
               for v in rules.RULES["cache-key-purity"].check(unit))


def test_rule_fires_traffic_conservation():
    plan = SuitePlan.build(_suite("demo")[:1])
    (key, builder, _), = enumerate_executables(plan, device="cpu")
    c = census.of_key(key, builder(), device="cpu")
    assert c.operand_bytes + c.result_bytes == cost.key_cost(key).io_bytes
    unit = rules.ExecUnit(key=key, _census=c)
    assert not _fired(unit, "traffic-conservation")
    extra = dataclasses.replace(c, result_bytes=2 * c.result_bytes)
    (v,) = _fired(dataclasses.replace(unit, _census=extra),
                  "traffic-conservation")
    assert "unaccounted" in v.message


def test_rule_fires_auto_placement_sane(tmp_path, monkeypatch):
    plan = SuitePlan.build(_suite("demo"))
    shape = cost.select_shape(plan, n_devices=4)
    name = "single" if shape == (1, 1) else f"{shape[0]}x{shape[1]}"
    other = "2x2" if name != "2x2" else "4x1"
    record = {"meta": {"platform": "cuda", "device": "NVIDIA H100",
                       "power_limit": "700.00 W"},
              "mesh_sweep": {"n_dev": 4, "suites": {"demo": {"shapes": {
                  name: {"hmean_gbs": 1.0, "pad_waste": 0.5},
                  other: {"hmean_gbs": 9.0, "pad_waste": 0.1}}}}}}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(record))
    unit = rules.PlanUnit(plan=plan, grid=(1, 1),
                          label="suites/demo.json @ auto")
    monkeypatch.delenv(cost.BENCH_ENV, raising=False)
    assert not rules.RULES["auto-placement-sane"].check(unit)
    monkeypatch.setenv(cost.BENCH_ENV, str(path))
    (v,) = rules.RULES["auto-placement-sane"].check(unit)
    assert f"dominated-by={other}" in v.location


def test_rule_fires_cost_regression(tmp_path, monkeypatch):
    key = _key()
    unit = rules.ExecUnit(key=key)          # key-only: takes no census
    path = tmp_path / "base.json"
    cost.write_baseline({cost.key_id(key): 1}, str(path))
    monkeypatch.setenv(cost.BASELINE_ENV, str(path))
    (v,) = _fired(unit, "cost-regression")
    assert "grew 1 ->" in v.message
    cost.write_baseline({cost.key_id(key): cost.key_cost(key).io_bytes},
                        str(path))
    assert not _fired(unit, "cost-regression")


BAD_SERVE = '''
import threading, time
class D:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0
    def locked(self):
        with self._lock:
            self.n += 1
            time.sleep(1)
    def racy(self):
        self.n += 1
'''


@pytest.mark.parametrize("name", ["serve-lock-discipline",
                                  "serve-blocking-under-lock"])
def test_rule_fires_serve_rules_like_the_reference(tmp_path, name):
    path = tmp_path / "bad.py"
    path.write_text(BAD_SERVE)
    rep = lint.lint_serve([str(path)], rules=[name])
    (v,) = rep.violations
    want = [w for w in j_ast_lint.lint_source(BAD_SERVE, str(path))
            if w.rule == name]
    assert [v.to_json()] == [w.to_json() for w in want]


def test_ast_lint_is_the_references_over_the_ports_serve_layer():
    rep = lint.lint_serve()
    assert rep.ok and rep.n_units == len(ast_lint.serve_sources()) >= 6
    assert all("repro_torch" in p for p in ast_lint.serve_sources())
    for p in ast_lint.serve_sources():
        src = Path(p).read_text()
        assert ast_lint.lint_source(src, p) == [] \
            and j_ast_lint.lint_source(src, p) == []


# ---------------------------------------------------------------------------
# the suites, the enumeration and the live cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [None, (1, 2), (2, 1), "auto"])
@pytest.mark.parametrize("suite", SUITES)
def test_suites_lint_clean_on_the_cpu(suite, mesh):
    rep = lint.lint_suite_file(str(ROOT / "suites" / f"{suite}.json"),
                               mesh=mesh, device="cpu",
                               devices=["cpu"] * 2)
    assert rep.ok, rep.summary()
    n_buckets = SuitePlan.build(_suite(suite)).n_buckets
    assert rep.n_units == 2 * (n_buckets + 1)


@pytest.mark.parametrize("mode", ["store", "add"])
@pytest.mark.parametrize("mesh", [None, (1, 2), (2, 1)])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_enumeration_matches_live_cache_keys(backend, mesh, mode):
    plan = SuitePlan.build(_suite("demo"))
    devices = ["cpu"] * 2
    place = Placement.create(mesh, devices=devices) if mesh else None
    cache = ExecutorCache()
    run_plan(plan, backend=backend, runs=1, mode=mode, cache=cache,
             device="cpu", mesh=place)
    keys = [k for k, _, _ in enumerate_executables(
        plan, backend=backend, mode=mode, placement=place, device="cpu")]
    assert sorted(map(str, keys)) == sorted(str(k) for k, _, _ in
                                            cache.entries())
    # each entry kept the census of its building launch's warm-up, and the
    # live-cache lint reads it without running anything
    entries = cache.entries()
    assert all(c is not None and len(c.calls) == (place.grid[0] *
                                                  place.grid[1]
                                                  if place else 1)
               for _, _, c in entries)
    before = cache.stats()
    rep = lint.lint_cache(cache)
    assert rep.ok and rep.n_units == len(entries)
    assert cache.stats() == before and cache.entries() == entries


def test_census_records_only_its_own_thread_and_the_launch_hook(
        monkeypatch):
    import threading

    # _build.launch itself, with the C call and the CUDA queries faked
    monkeypatch.setattr(_build, "c_function", lambda lib, fn: lambda *a: 0)
    monkeypatch.setattr(_build, "current_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "launches", {k: 0 for k in _build.KERNELS})
    dev = torch.device("cuda", 0)
    elsewhere = []

    def other():
        with _build.observe_launches() as seen:
            torch.ones(3).add_(1)
            _build.launch("scatter_add_rows", dev, "scatter_rows", "f")
        elsewhere.extend(seen)

    def run(wrap):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
        out = wrap(_gather)(*_ops())
        _build.launch("gather_rows", dev, "gather_rows", "f")
        return out
    with _build.observe_launches() as outer:
        c, _ = census.take(run, device="cpu",
                           operands={"table": [_ops()[0]]})
    assert "add_" not in c.ops and "gather" in c.ops
    assert len(c.calls) == 1
    assert c.launches == {"gather_rows": 1}
    assert c.launch_devices == ("cuda:0",)
    assert outer == [("gather_rows", "cuda:0")]
    assert elsewhere == [("scatter_add_rows", "cuda:0")]
    assert _build.launches["gather_rows"] == 1


def test_live_cache_lint_fires_on_a_poisoned_census():
    cache = ExecutorCache()
    plan = SuitePlan.build(_suite("demo")[:1])
    run_plan(plan, backend="torch", runs=1, cache=cache, device="cpu")
    (key, _, c), = cache.entries()
    cache.set_census(key, dataclasses.replace(c, ops={**c.ops, "sort": 1}))
    rep = lint.lint_cache(cache)
    assert [v.rule for v in rep.violations] == ["no-sort-in-hot-path"]


def test_daemon_lint_and_cost_leave_counters_and_launches_unchanged():
    with SpatterDaemon(port=0, cache=ExecutorCache(), device="cpu") as d:
        c = SpatterClient(d.url)
        c.run_suite(SMALL, runs=1, backend="hopper")
        c.warm(SMALL, runs=1, backend="torch")
        before = (d.cache.stats(), dict(_build.launches), d.cache.entries())
        lint_doc, cost_doc = c.lint(), c.cost()
        after = (d.cache.stats(), dict(_build.launches), d.cache.entries())
    assert before == after
    assert lint_doc["ok"] and cost_doc["ok"]
    assert lint_doc["report"]["n_units"] == cost_doc["report"]["n_units"] \
        == before[0].size == 4
    assert lint_doc["report"]["meta"]["restored"] == 0
    for u in cost_doc["report"]["units"]:
        assert u["lowered_bytes"] == u["io_bytes"] > 0


# ---------------------------------------------------------------------------
# reports and front ends
# ---------------------------------------------------------------------------

def test_report_schema_roundtrips_and_parses_in_the_reference():
    rep = lint.lint_serve().merge(lint.lint_suite_file(
        str(ROOT / "suites" / "demo.json"), device="cpu"))
    rep.violations.append(Violation(rule="r", message="m", exec_key="k",
                                    location="l"))
    doc = json.loads(json.dumps(rep.to_json()))
    assert LintReport.from_json(doc).to_json() == doc
    assert j_report.LintReport.from_json(doc).to_json() == doc
    ref = j_report.LintReport(violations=[j_report.Violation(
        rule="no-sort-in-hot-path", message="m", severity="warning")],
        n_units=3, rules=("no-sort-in-hot-path",), meta={"cells": []})
    assert LintReport.from_json(ref.to_json()).to_json() == ref.to_json()
    assert not LintReport.from_json(doc).ok


def test_analysis_imports_without_jax_torch_for_the_schema():
    code = ("import sys; sys.path.insert(0, %r); "
            "sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.analysis.report, "
            "repro_torch.analysis.ast_lint, repro_torch.analysis.cost; "
            "assert 'torch' not in sys.modules, 'the schema pulls torch'; "
            "import repro_torch.analysis, repro_torch.analysis.lint, "
            "repro_torch.analysis.rules, repro_torch.analysis.census, "
            "repro_torch.analysis.__main__; "
            "from repro_torch.analysis import lint_serve; "
            "assert lint_serve().ok; "
            "bad = sorted(m for m in sys.modules if sys.modules[m] is not "
            "None and m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('OK')" % SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]


def test_cli_lint_and_cost_exit_zero_with_reports(tmp_path, capsys):
    demo = str(ROOT / "suites" / "demo.json")
    rep = cli(["--lint", demo, "--device", "cpu", "--lint-out",
               str(tmp_path / "l.json")])
    assert rep.ok and "clean" in capsys.readouterr().out
    doc = json.loads((tmp_path / "l.json").read_text())
    assert j_report.LintReport.from_json(doc).ok
    rep = cli(["--cost", demo, "--device", "cpu", "-b", "hopper",
               "--cost-out", str(tmp_path / "c.json")])
    assert rep.ok and {u.backend for u in rep.units} == {"hopper"}
    assert json.loads((tmp_path / "c.json").read_text())["ok"]


@pytest.mark.parametrize("argv,needle", [
    (["--lint", "D", "-r", "3"], "--runs: not applicable to --lint"),
    (["--cost", "D", "--json", "D"], "--json: not applicable to --cost"),
    (["--lint", "D", "--cost", "D"], "separate audits"),
    (["--lint-out", "x.json"], "--lint-out requires --lint"),
    (["--lint", "D", "--mesh", "2"], "needs 2 devices, have 1"),
])
def test_cli_refuses_run_options_with_an_audit(argv, needle, capsys):
    demo = str(ROOT / "suites" / "demo.json")
    with pytest.raises(SystemExit) as e:
        cli([demo if a == "D" else a for a in argv] + ["--device", "cpu"])
    assert e.value.code == 2 and needle in capsys.readouterr().err


def test_matrix_runner_exit_codes(tmp_path):
    demo = str(ROOT / "suites" / "demo.json")
    assert matrix(["--suite", demo, "--device", "cpu", "--mesh", "2"]) == 2
    out = tmp_path / "LINT_report.json"
    assert matrix(["--suite", demo, "--device", "cpu", "--devices", "cpu*2",
                   "--mesh", "0", "--mesh", "1x2", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] and len(doc["meta"]["cells"]) == 4
    assert parse_devices("cuda:0*3,cpu") == ["cuda:0"] * 3 + ["cpu"]
    with pytest.raises(ValueError, match="DEV"):
        parse_devices("cpu*x")
