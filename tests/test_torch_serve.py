"""The port's spatterd (repro_torch/serve) against the reference's.

Mirrors tests/test_serve.py, test_scheduler.py and test_faults.py for
every subject the port has, on the CPU (``device="cpu"``: the hopper
backend runs its kernels' plain versions).  ``/lint`` and ``/cost``
answer from the live cache and leave its counters as they were; the
modeled metric is the H100 sector model's, and the reference's TPU
column (``modeled_v5e_gbs``) is an unknown metric.  A mesh of more devices
than the daemon has is a 400 naming its device count (placements over
several devices, ROADMAP A5, are tested in test_torch_placement.py).  The parity tests send the same suites to the
JAX daemon and the port's and compare per-pattern digests and plan
telemetry; adds are held within ``add_error_bound``.
"""
import ast
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ExecutorCache as JExecutorCache
from repro.core import pattern as j_pattern
from repro.core import plan as j_plan
from repro.serve import SpatterClient as JClient
from repro.serve import SpatterDaemon as JDaemon
from repro_torch import pattern, plan
from repro_torch.host import make_host_buffers
from repro_torch.kernels.scatter_rows.ref import add_error_bound
from repro_torch.plan import ExecutorCache, SuitePlan, make_work, run_plan
from repro_torch.serve import (FaultInjector, InjectedFault, ServerError,
                               SpatterClient, SpatterDaemon, WorkerKilled)
from repro_torch.serve.faults import ENV_SPEC, _parse_rule
from repro_torch.serve.scheduler import (QUARANTINE_AFTER, DeadlineExceeded,
                                         FamilyQuarantined, QueueFull,
                                         RequestCancelled, Scheduler,
                                         SchedulerStopped)
from repro_torch.serve.schema import SuiteRequest

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
WORKERS = int(os.environ.get("CHAOS_WORKERS", "2"))

SUITE = [
    {"name": "g1", "kernel": "Gather", "pattern": "UNIFORM:4:1",
     "delta": 4, "count": 64},
    {"name": "g2", "kernel": "Gather", "pattern": "UNIFORM:4:2",
     "delta": 4, "count": 64},
    {"name": "s1", "kernel": "Scatter", "pattern": "UNIFORM:4:2",
     "delta": 2, "count": 64},
]
ONE = [SUITE[0]]
DEMO = json.loads((ROOT / "suites" / "demo.json").read_text())
# store- and add-mode scatter suites: distinct rows, duplicates, broadcast
SCATTERS = [
    {"name": "s-u1", "kernel": "Scatter", "pattern": "UNIFORM:8:1",
     "delta": 8, "count": 256},
    {"name": "s-u4", "kernel": "Scatter", "pattern": "UNIFORM:8:4",
     "delta": 2, "count": 256},
    {"name": "s-ms1", "kernel": "Scatter", "pattern": "MS1:8:4:64",
     "delta": 8, "count": 128},
    {"name": "s-bc", "kernel": "Scatter", "pattern": "BROADCAST:8:4",
     "delta": 1, "count": 256},
]

# the scheduler tests' plans: one bucket, and three across kinds/shapes
SINGLE = SuitePlan.build(
    [pattern.make_pattern("UNIFORM:8:2", kind="gather", delta=2, count=32)])
MIXED = SuitePlan.build([
    pattern.make_pattern("UNIFORM:8:1", kind="gather", delta=8, count=16),
    pattern.make_pattern("UNIFORM:8:4", kind="gather", delta=4, count=64),
    pattern.make_pattern("UNIFORM:8:2", kind="scatter", delta=2, count=16),
])


def _daemon(spec=None, seed=0, **kw):
    faults = FaultInjector.from_spec(spec, seed=seed) if spec else None
    kw.setdefault("workers", WORKERS)
    return SpatterDaemon(port=0, cache=ExecutorCache(), faults=faults,
                         device="cpu", **kw)


@pytest.fixture()
def served():
    with _daemon() as d:
        yield SpatterClient(d.url)


def _wait(pred, timeout=60.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "condition never became true"
        time.sleep(0.01)


def _digests(resp):
    return [t["digest"] for t in resp["stats"]["table"]]


def _work(p, **kw):
    kw.setdefault("device", "cpu")
    return make_work(p, **kw)


def _serial_reference(p, runs):
    return [r.out_digest for r in run_plan(p, runs=runs, cache=ExecutorCache(),
                                           digest=True, device="cpu")]


def _ticket_digests(ticket, n):
    assert sorted(ticket.results) == list(range(n))
    return [ticket.results[i].out_digest for i in range(n)]


# ---------------------------------------------------------------------------
# request schema
# ---------------------------------------------------------------------------

def test_schema_accepts_bare_suite_list():
    req = SuiteRequest.from_json(SUITE)
    assert req.patterns == tuple(SUITE)
    assert req.backend == "torch" and req.mode == "store"
    assert len(req.build_patterns()) == 3


def test_schema_envelope_roundtrip():
    req = SuiteRequest.from_json({"patterns": SUITE, "backend": "scalar",
                                  "mode": "add", "runs": 5, "mesh": 2,
                                  "stream_r": True})
    assert (req.backend, req.mode, req.runs, req.mesh,
            req.stream_r) == ("scalar", "add", 5, 2, True)
    assert SuiteRequest.from_json(req.to_json()) == req


def test_schema_mesh_accepts_2d_shapes():
    req = SuiteRequest.from_json({"patterns": SUITE, "mesh": [4, 2]})
    assert req.mesh == (4, 2) and req.devices_needed == 8
    assert req.to_json()["mesh"] == [4, 2]
    assert SuiteRequest.from_json(req.to_json()) == req
    assert SuiteRequest.from_json(
        {"patterns": SUITE, "mesh": (4, 2)}).mesh == (4, 2)


def test_schema_mesh_accepts_auto():
    req = SuiteRequest.from_json({"patterns": SUITE, "mesh": "auto"})
    assert req.mesh == "auto" and req.to_json()["mesh"] == "auto"
    assert SuiteRequest.from_json(req.to_json()) == req
    with pytest.raises(ValueError, match="mesh"):
        SuiteRequest.from_json({"patterns": SUITE, "mesh": "turbo"})


def test_parse_mesh():
    from repro_torch.serve.schema import parse_mesh
    assert parse_mesh("8") == 8
    assert parse_mesh("4x2") == (4, 2)
    assert parse_mesh(" 2X4 ") == (2, 4)
    assert parse_mesh("auto") == "auto"
    assert parse_mesh(" AUTO ") == "auto"
    for bad in ("4y2", "x", "4x", "4x2x1", "a"):
        with pytest.raises(ValueError, match="mesh"):
            parse_mesh(bad)


def test_schema_rejects_bad_requests():
    cases = [
        ([], "at least one pattern"),
        ({"patterns": SUITE, "backend": "cuda"}, "backend"),
        ({"patterns": SUITE, "backend": "xla"}, "backend"),
        ({"patterns": SUITE, "mode": "max"}, "mode"),
        ({"patterns": SUITE, "metric": "measurd"}, "metric"),
        ({"patterns": SUITE, "metric": "modeled_h100"}, "metric"),
        ({"patterns": SUITE, "metric": "modeled_v5e_gbs"}, "metric"),
        ({"patterns": SUITE, "runs": 0}, "runs"),
        ({"patterns": SUITE, "runs": "3"}, "runs"),
        ({"patterns": SUITE, "runs": 10 ** 9}, "runs"),
        ({"patterns": SUITE, "row_width": 10 ** 6}, "row_width"),
        ({"patterns": SUITE, "mesh": -1}, "mesh"),
        ({"patterns": SUITE, "mesh": True}, "mesh"),
        ({"patterns": SUITE, "mesh": [4]}, "mesh"),
        ({"patterns": SUITE, "mesh": [4, 2, 1]}, "mesh"),
        ({"patterns": SUITE, "mesh": [0, 2]}, "mesh"),
        ({"patterns": SUITE, "mesh": [True, 2]}, "mesh"),
        ({"patterns": SUITE, "mesh": ["4", 2]}, "mesh"),
        ({"patterns": SUITE, "mesh": [1 << 20, 2]}, "mesh"),
        ({"patterns": SUITE, "mesh": "4x2"}, "mesh"),
        ({"patterns": SUITE, "stream_r": 1}, "stream_r"),
        ({"patterns": SUITE, "stream_n": 4}, "stream_n"),
        ({"patterns": SUITE, "stream_n": 2 ** 40}, "stream_n"),
        ({"patterns": SUITE, "seed": -1}, "seed"),
        ({"patterns": SUITE, "deadline_ms": -1}, "deadline_ms"),
        ({"patterns": SUITE, "mesh_axis": "a b"}, "mesh_axis"),
        ({"patterns": SUITE, "mod": "add"}, "unknown request fields"),
        ({"backend": "torch"}, "patterns"),
        ("42", "list or object"),
        ([{"name": "x"}, 7], r"patterns\[1\] is not an object"),
    ]
    for doc, needle in cases:
        with pytest.raises(ValueError, match=needle):
            SuiteRequest.from_json(doc)


def test_schema_bad_pattern_entry_is_value_error():
    req = SuiteRequest.from_json([{"name": "nope", "kernel": "Gather"}])
    with pytest.raises(ValueError, match="bad pattern entry"):
        req.build_patterns()
    for spec in ("UNIFORM", "MS1:8"):
        short = SuiteRequest.from_json(
            [{"name": "short", "kernel": "Gather", "pattern": spec,
              "delta": 1, "count": 1}])
        with pytest.raises(ValueError, match="bad pattern entry"):
            short.build_patterns()


def test_schema_bounds_pattern_geometry():
    huge = [{"name": "huge", "kernel": "Gather", "pattern": "UNIFORM:8:1",
             "delta": 8, "count": 2 ** 40}]
    with pytest.raises(ValueError, match="too large to serve"):
        SuiteRequest.from_json(huge).build_patterns()
    gen = [{"name": "gen", "kernel": "Gather",
            "pattern": "UNIFORM:2000000000:1", "delta": 8, "count": 1}]
    with pytest.raises(ValueError, match="index buffer"):
        SuiteRequest.from_json(gen).build_patterns()
    wide = {"patterns": [{"name": "w", "kernel": "Gather",
                          "pattern": "UNIFORM:8:1", "delta": 8,
                          "count": 2 ** 20}], "row_width": 4096}
    with pytest.raises(ValueError, match="too large to serve"):
        SuiteRequest.from_json(wide).build_patterns()
    # the CLI's 2^27-lane pattern is within the budget
    cli = [{"name": "cli", "kernel": "Gather", "pattern": "UNIFORM:8:1",
            "delta": 8, "count": 2 ** 24}]
    from repro_torch.serve.schema import _spec_index_len
    assert _spec_index_len(cli[0]["pattern"]) == 8
    SuiteRequest.from_json(cli)          # validates without building


def test_spec_index_len_mirror_tracks_generate_index():
    from repro.core.pattern import generate_index as j_generate_index
    from repro_torch.serve.schema import MAX_INDEX_LEN, _spec_index_len
    for spec in ("UNIFORM:8:1", "UNIFORM:128:4", "MS1:8:4:64",
                 "LAPLACIAN:2:2:100", "LAPLACIAN:3:1:10", "BROADCAST:8:4",
                 "STREAM:16", "CUSTOM:0,4,8,12", "0,4,8,12", [0, 3, 10]):
        real = pattern.generate_index(spec)
        assert real == j_generate_index(spec)
        assert _spec_index_len(spec) >= len(real), spec
    assert _spec_index_len("HASH:2000000000:1") > MAX_INDEX_LEN


def test_wire_choice_sets_match_the_port():
    from repro_torch import backends as B
    from repro_torch.__main__ import _parser
    from repro_torch.suite import _METRIC_COLUMNS
    from repro_torch.serve.schema import (DEFAULT_BACKEND, WIRE_BACKENDS,
                                          WIRE_METRICS, WIRE_MODES)
    assert WIRE_BACKENDS == B.BACKENDS
    assert WIRE_MODES == B.SCATTER_MODES
    assert set(WIRE_METRICS) == set(_METRIC_COLUMNS)
    assert DEFAULT_BACKEND == _parser().get_default("backend")


def test_client_and_schema_import_the_stdlib_only():
    code = ("import sys; sys.path.insert(0, %r); "
            "import repro_torch.serve.client, repro_torch.serve.schema; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'torch', 'numpy')); "
            "assert not bad, bad; print('OK')" % SRC)
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]


def test_serve_and_diskcache_import_without_jax_or_repro():
    code = ("import sys; sys.path.insert(0, %r); "
            "import repro_torch.serve.daemon, repro_torch.serve.scheduler, "
            "repro_torch.serve.client, repro_torch.serve.faults, "
            "repro_torch.diskcache; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'triton')); "
            "assert not bad, bad; print('OK')" % SRC)
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]


def test_no_module_of_the_port_imports_jax_or_repro():
    bad = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "repro")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# daemon round trips
# ---------------------------------------------------------------------------

def test_health_and_cache_endpoints(served):
    h = served.health()
    assert h["ok"] and h["service"] == "spatterd"
    assert h["device"] == "cpu" and h["n_devices"] == 1
    assert "hopper" in h["backends"]
    assert served.cache()["cache"] == {"hits": 0, "misses": 0, "size": 0,
                                       "batch_hits": 0, "disk_hits": 0,
                                       "degraded": 0}


def test_daemon_asks_for_cuda_by_default(monkeypatch):
    # no CPU path when CUDA is missing: only an explicit device="cpu" runs
    from repro_torch.serve import daemon
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpatterDaemon(port=0, cache=ExecutorCache())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        daemon.main(["--port", "0"])


@pytest.mark.parametrize("path", ["/lint", "/cost"])
def test_lint_and_cost_answer_501_naming_a3(served, path):
    # ported since: a 200 and a clean report over the live cache, which
    # the audit reads without moving its counters
    served.run_suite(SUITE, runs=1)
    before = served.cache()["cache"]
    doc = served._request(path)
    assert doc["ok"] and doc["report"]["ok"]
    assert doc["report"]["n_units"] == before["size"] > 0
    assert doc["report"]["meta"]["restored"] == 0
    assert served.cache()["cache"] == before
    assert served.health()["ok"]


def test_cost_answers_501_on_restored_entries(tmp_path):
    # ported since: restored entries have no census, so /cost gives their
    # key's geometry and the key-only rules (a 200, not a 501)
    root = str(tmp_path)
    with _daemon(cache_dir=root) as d:
        SpatterClient(d.url).run_suite(SUITE, runs=1)
    with _daemon(cache_dir=root) as d:
        c = SpatterClient(d.url)
        assert c.run_suite(SUITE, runs=1)["cache"]["misses"] == 0
        n = c.cache()["cache"]["size"]
        doc = c.cost()
        assert doc["ok"] and doc["report"]["meta"]["restored"] == n > 0
        assert all(u["lowered_bytes"] == -1 and u["io_bytes"] > 0
                   for u in doc["report"]["units"])
        lint = c.lint()
        assert lint["ok"] and lint["report"]["meta"]["restored"] == n


def test_mesh_auto_request_resolves_and_stays_warm(served):
    r1 = served.run_suite(SUITE, runs=1)
    r2 = served.run_suite(SUITE, runs=1, mesh="auto")
    assert r2["ok"]
    placement = r2["plan"]["placement"]
    assert isinstance(placement, list) and set(placement) == {"single"}
    assert len(placement) == r2["plan"]["n_buckets"]
    assert r2["cache"]["misses"] == 0
    assert _digests(r2) == _digests(r1)


def test_mesh_auto_suite_request_picks_one_shape(served):
    r1 = served.run_suite(SUITE, runs=1)
    r2 = served.run_suite(SUITE, runs=1, mesh="auto-suite")
    assert r2["ok"] and r2["plan"]["placement"] == "single"
    assert r2["cache"]["misses"] == 0
    assert _digests(r2) == _digests(r1)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_second_request_compiles_nothing_and_is_bit_identical(served,
                                                              backend):
    r1 = served.run_suite(SUITE, backend=backend, runs=2)
    r2 = served.run_suite(SUITE, backend=backend, runs=2)
    assert r1["ok"] and r2["ok"]
    assert r1["cache"]["misses"] == r1["plan"]["n_buckets"]
    assert r2["cache"]["misses"] == 0
    assert r2["cache"]["hits"] == r2["plan"]["n_buckets"]
    assert _digests(r1) == _digests(r2) and all(_digests(r1))
    assert r2["cache"]["lifetime"]["misses"] == r1["cache"]["misses"]


def test_client_accepts_envelope_documents(served):
    env = {"patterns": SUITE, "runs": 1, "mode": "store"}
    r = served.run_suite(env)
    assert r["ok"] and r["stats"]["n_patterns"] == len(SUITE)
    r2 = served.run_suite(json.dumps(env), metric="measured_gbs")
    assert r2["stats"]["metric"] == "measured_gbs"
    r3 = served.run_suite(env, digest=False)
    assert all(row["digest"] is None for row in r3["stats"]["table"])


def test_response_stats_document(served):
    r = served.run_suite(SUITE, backend="hopper", runs=1)
    stats = r["stats"]
    assert stats["metric"] == "measured_gbs" and stats["device"] == "cpu"
    assert stats["n_patterns"] == len(SUITE)
    assert [row["name"] for row in stats["table"]] == ["g1", "g2", "s1"]
    for row in stats["table"]:
        assert row["gbs"] == row["measured_gbs"] > 0
        assert row["backend"] == "hopper"
    assert 0 <= r["plan"]["pad_waste"] < 1
    assert r["elapsed_s"] > 0


def test_modeled_metric_is_a_400_naming_a2(served):
    # ported since: "modeled" serves the H100 sector model's column; the
    # reference's TPU column is the 400
    r = served.run_suite(SUITE, runs=1, metric="modeled")
    assert r["stats"]["metric"] == "modeled_h100_gbs"
    for row in r["stats"]["table"]:
        assert row["gbs"] == row["modeled_h100_gbs"] > 0
        assert row["measured_gbs"] > 0
    with pytest.raises(ServerError) as e:
        served._request("/run", {"patterns": SUITE,
                                 "metric": "modeled_v5e_gbs"})
    assert e.value.status == 400 and "metric" in str(e.value)


def test_mode_add_reaches_the_executable(served):
    dup = [{"name": "dup", "kernel": "Scatter", "pattern": "BROADCAST:4:2",
            "delta": 0, "count": 8}]
    r_store = served.run_suite(dup, runs=1, mode="store", backend="hopper")
    r_add = served.run_suite(dup, runs=1, mode="add", backend="hopper")
    assert r_add["cache"]["misses"] > 0      # distinct bucket callable
    assert _digests(r_store) != _digests(r_add)
    again = served.run_suite(dup, runs=1, mode="add", backend="hopper")
    assert again["cache"]["misses"] == 0
    assert _digests(again) == _digests(r_add)


def test_stream_r_surfaces_in_response(served):
    pats = [{"name": f"g{s}", "kernel": "Gather",
             "pattern": f"UNIFORM:8:{s}", "delta": 8, "count": 64}
            for s in (1, 16, 64)]
    r = served.run_suite(pats, runs=1, row_width=8, stream_r=True,
                         stream_n=1024)
    assert r["stats"]["stream_gbs"] and r["stats"]["stream_gbs"] > 0
    # Eq. 1's R of the measured against the modeled column
    assert -1 <= r["stats"]["stream_r"] <= 1
    r2 = served.run_suite(pats, runs=1)
    assert r2["stats"]["stream_gbs"] is None
    r3 = served.run_suite(pats, runs=1, row_width=8, stream_r=True,
                          stream_n=1024)
    assert r3["stats"]["stream_gbs"] == r["stats"]["stream_gbs"]  # memoized
    assert r3["cache"]["misses"] == 0


def test_mesh_request_single_device(served):
    r1 = served.run_suite(SUITE, runs=1, mesh=1)
    r2 = served.run_suite(SUITE, runs=1, mesh=[1, 1])
    assert r2["cache"]["misses"] == 0
    r0 = served.run_suite(SUITE, runs=1)
    assert _digests(r0) == _digests(r1) == _digests(r2)


@pytest.mark.parametrize("mesh", [2, 8, [4, 2], [1, 2], 4096])
def test_multi_device_mesh_is_a_400_naming_a5(served, mesh):
    # since A5 the daemon places meshes over its devices; one beyond them
    # is a 400 that names the count (the CPU daemon has one device)
    with pytest.raises(ServerError) as e:
        served.run_suite(SUITE, runs=1, mesh=mesh)
    assert e.value.status == 400 and "have 1 devices listed" in str(e.value)
    assert served.cache()["cache"]["misses"] == 0     # before any work
    with pytest.raises(ServerError) as e:
        served.warm(SUITE, mesh=mesh)
    assert e.value.status == 400


def test_http_error_codes(served):
    with pytest.raises(ServerError) as e:
        served._request("/run", {"patterns": SUITE, "mode": "max"})
    assert e.value.status == 400
    with pytest.raises(ServerError) as e:
        served._request("/nope", {})
    assert e.value.status == 404
    with pytest.raises(ValueError, match="mode"):
        served.run_suite(SUITE, mode="max")
    assert served.health()["ok"]


def test_keep_alive_connection_survives_404(served):
    import http.client
    host, port = served.url[len("http://"):].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        hdr = {"Content-Type": "application/json"}
        conn.request("POST", "/runs", body=json.dumps(SUITE), headers=hdr)
        r1 = conn.getresponse()
        assert r1.status == 404 and not json.loads(r1.read())["ok"]
        conn.request("POST", "/run", headers=hdr,
                     body=json.dumps({"patterns": SUITE, "runs": 1}))
        r2 = conn.getresponse()
        doc = json.loads(r2.read())
        assert r2.status == 200 and doc["ok"]
    finally:
        conn.close()


def test_bad_framing_gets_an_error_response(served):
    import socket
    host, port = served.url[len("http://"):].rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=60) as s:
        s.sendall(b"POST /run HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: abc\r\n\r\n")
        head = s.recv(4096).decode()
    assert head.startswith("HTTP/1.1 400"), head
    assert served.health()["ok"]


def test_concurrent_requests_keep_exact_telemetry(served):
    before = served.stats()["cache"]["misses"]
    results = []

    def post():
        results.append(served.run_suite(SUITE, runs=1, backend="hopper"))

    threads = [threading.Thread(target=post) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(results) == 4 and all(r["ok"] for r in results)
    n_buckets = results[0]["plan"]["n_buckets"]
    compiles = served.stats()["cache"]["misses"] - before
    assert sum(r["cache"]["misses"] for r in results) == compiles
    assert compiles >= n_buckets
    assert len({tuple(_digests(r)) for r in results}) == 1
    assert all(r["serve"]["launches"] == n_buckets for r in results)


def test_stats_endpoint_reports_scheduler_snapshot(served):
    s0 = served.stats()
    assert s0["ok"] and s0["n_requests"] == 0 and s0["uptime_s"] >= 0
    assert s0["cache"]["misses"] == 0
    sched = s0["scheduler"]
    assert sched["workers"] >= 1 and sched["queue_depth"] == 0
    assert sched["submitted"] == 0 and sched["total_launches"] == 0
    assert set(s0["kernels"]) == {"launches", "nvcc_runs"}
    served.run_suite(SUITE, runs=1)
    s1 = served.stats()
    assert s1["n_requests"] == 1 and s1["cache"]["misses"] > 0
    assert s1["scheduler"]["submitted"] == 1
    assert s1["scheduler"]["completed"] == 1
    assert s1["scheduler"]["total_launches"] >= 1
    assert s1["scheduler"]["lock_wait_ms"] >= 0


def test_serial_baseline_daemon_has_no_scheduler():
    with _daemon(workers=0) as d:
        c = SpatterClient(d.url)
        assert c.stats()["scheduler"] is None
        r = c.run_suite(SUITE, runs=1)
        assert r["ok"] and r["serve"] is None
        assert r["cache"]["misses"] == r["plan"]["n_buckets"]
        assert c.run_suite(SUITE, runs=1)["cache"]["misses"] == 0


def test_client_keep_alive_reuses_socket(served):
    served.health()
    conn = served._conn()
    sock = conn.sock
    assert sock is not None
    served.cache()
    served.stats()
    assert served._conn() is conn and conn.sock is sock
    served.close()
    assert getattr(served._local, "conn", None) is None


def test_client_retries_get_across_daemon_restart():
    d1 = _daemon().start()
    port = d1.port
    c = SpatterClient(d1.url)
    assert c.health()["ok"]
    assert c._conn().sock is not None
    d1.stop()
    with SpatterDaemon(port=port, cache=ExecutorCache(), device="cpu") as d2:
        assert d2.port == port
        assert c.health()["ok"]
    c.close()
    with pytest.raises(ServerError) as e:
        c.health()
    assert e.value.status == 0


def test_backpressure_503_with_retry_after():
    with _daemon(workers=1, max_queue=2) as d:
        c = SpatterClient(d.url)
        d.scheduler.pause()
        results, threads = [], []
        for _ in range(2):
            t = threading.Thread(
                target=lambda: results.append(c.run_suite(ONE, runs=1)))
            t.start()
            threads.append(t)
        _wait(lambda: d.scheduler.snapshot()["queue_depth"] == 2)
        import http.client
        conn = http.client.HTTPConnection(d.host, d.port, timeout=60)
        try:
            conn.request("POST", "/run",
                         body=json.dumps({"patterns": ONE, "runs": 1}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            doc = json.loads(resp.read())
            assert resp.status == 503
            assert int(resp.getheader("Retry-After")) >= 1
            assert not doc["ok"] and doc["retry_after_s"] >= 1
            assert "queue full" in doc["error"]
        finally:
            conn.close()
        assert d.cache.stats().misses == 0
        d.scheduler.resume()
        for t in threads:
            t.join(timeout=300)
        assert len(results) == 2 and all(r["ok"] for r in results)


def test_acceptance_16_clients_coalesce_to_one_compile():
    with _daemon() as d:
        c = SpatterClient(d.url)
        d.scheduler.pause()
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(
                c.run_suite(ONE, runs=1, backend="hopper")))
            for _ in range(16)]
        for t in threads:
            t.start()
        _wait(lambda: d.scheduler.snapshot()["queue_depth"] == 16, 120)
        d.scheduler.resume()
        for t in threads:
            t.join(timeout=600)
        snap = d.scheduler.snapshot()
        compiles = d.cache.stats().misses
    assert len(results) == 16 and all(r["ok"] for r in results)
    assert compiles == 1
    assert sum(r["cache"]["misses"] for r in results) == 1
    assert snap["total_launches"] == 1 and snap["coalesced_launches"] == 1
    assert all(r["serve"]["launches"] == 1 for r in results)
    assert all(r["serve"]["coalesced_launches"] == 1 for r in results)
    # equal to the port's serial path and to the reference's
    pats = SuiteRequest.from_json(ONE).build_patterns()
    ref = _serial_reference(SuitePlan.build(pats), runs=1)
    jpats = [j_pattern.Pattern(name=p.name, kind=p.kind, index=p.index,
                            delta=p.delta, count=p.count) for p in pats]
    jref = [r.out_digest for r in j_plan.run_plan(
        j_plan.SuitePlan.build(jpats), runs=1, cache=JExecutorCache(),
        digest=True)]
    assert all(ref) and ref == jref
    for r in results:
        assert _digests(r) == ref


# ---------------------------------------------------------------------------
# warm start: POST /warm, the disk tier across restarts, crash safety
# ---------------------------------------------------------------------------

def test_warm_endpoint_makes_run_execute_only(served):
    w = served.warm(SUITE, backend="hopper")
    assert w["ok"] and w["n_executables"] == 3
    assert w["compiled"] == w["n_executables"]
    assert w["cache"]["misses"] == w["compiled"]
    r = served.run_suite(SUITE, runs=1, backend="hopper")
    assert r["ok"] and r["cache"]["misses"] == 0
    assert all(_digests(r))
    w2 = served.warm(SUITE, backend="hopper")
    assert w2["compiled"] == 0 and w2["cache"]["misses"] == 0


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_warm_restart_zero_builds_bit_identical(tmp_path, backend):
    root = str(tmp_path)
    with _daemon(cache_dir=root) as d:
        r1 = SpatterClient(d.url).run_suite(SUITE, runs=1, backend=backend)
        n_buckets = r1["plan"]["n_buckets"]
        assert d.disk.stats()["stores"] == n_buckets
    with _daemon(cache_dir=root) as d:
        c = SpatterClient(d.url)
        r2 = c.run_suite(SUITE, runs=1, backend=backend)
        assert r2["cache"]["misses"] == 0
        assert r2["cache"]["lifetime"]["misses"] == 0
        assert r2["cache"]["lifetime"]["disk_hits"] == n_buckets
        assert _digests(r2) == _digests(r1)
        assert c.stats()["disk"]["quarantined"] == 0


CRASH_PHASE1 = textwrap.dedent("""\
    import json, os, signal, sys
    sys.path.insert(0, %r)
    from repro_torch.plan import ExecutorCache
    from repro_torch.serve import SpatterClient, SpatterDaemon

    SUITE = %s
    root, out = sys.argv[1], sys.argv[2]
    d = SpatterDaemon(port=0, cache=ExecutorCache(), cache_dir=root,
                      device="cpu").start()
    r = SpatterClient(d.url).run_suite(SUITE, runs=1, backend="hopper")
    json.dump({"digests": [t["digest"] for t in r["stats"]["table"]],
               "n_buckets": r["plan"]["n_buckets"],
               "stores": d.disk.stats()["stores"]}, open(out, "w"))
    os.kill(os.getpid(), signal.SIGKILL)   # hard crash: no atexit, no drain
    """)

CRASH_PHASE2 = textwrap.dedent("""\
    import json, sys
    sys.path.insert(0, %r)
    from repro_torch.plan import ExecutorCache
    from repro_torch.serve import SpatterClient, SpatterDaemon

    SUITE = %s
    root, ref_path = sys.argv[1], sys.argv[2]
    ref = json.load(open(ref_path))
    with SpatterDaemon(port=0, cache=ExecutorCache(), cache_dir=root,
                       device="cpu") as d:
        r = SpatterClient(d.url).run_suite(SUITE, runs=1, backend="hopper")
        assert r["cache"]["misses"] == 0, r["cache"]
        assert [t["digest"] for t in r["stats"]["table"]] == ref["digests"]
        assert d.disk.stats()["quarantined"] == 1, d.disk.stats()
    print("OK")
    """)


def test_crash_safety_sigkill_then_warm_restart(tmp_path):
    # a SIGKILLed daemon leaves a directory a fresh one can trust: whole
    # entries restore, and a torn copy planted beside them is quarantined
    import glob
    root = str(tmp_path / "cache")
    out = str(tmp_path / "phase1.json")
    r1 = subprocess.run(
        [sys.executable, "-c", CRASH_PHASE1 % (SRC, json.dumps(SUITE)),
         root, out], capture_output=True, text=True, timeout=300)
    assert r1.returncode == -signal.SIGKILL, (r1.stdout, r1.stderr[-3000:])
    ref = json.load(open(out))
    assert ref["stores"] == ref["n_buckets"]
    victim = sorted(glob.glob(os.path.join(root, "*.spx")))[0]
    raw = Path(victim).read_bytes()
    Path(root, "f" * 40 + ".spx").write_bytes(raw[:len(raw) - 7])
    r2 = subprocess.run(
        [sys.executable, "-c", CRASH_PHASE2 % (SRC, json.dumps(SUITE)),
         root, out], capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, (r2.stdout[-1000:], r2.stderr[-3000:])
    assert "OK" in r2.stdout


def _spawn_daemon(*extra):
    env = {**os.environ, "PYTHONPATH": SRC, "PYTHONUNBUFFERED": "1"}
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.daemon", "--port", "0",
         "--device", "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    line = p.stdout.readline()
    assert "listening on" in line, (line, p.stderr.read()[-3000:])
    return p, SpatterClient(line.split("listening on")[1].split()[0])


def test_sigterm_graceful_drain_cli():
    p, c = _spawn_daemon()
    try:
        assert c.run_suite(ONE, runs=1)["ok"]
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=120)
    finally:
        p.kill()
    assert p.returncode == 0, (out, err[-3000:])
    assert "drained cleanly" in out
    c.close()
    with pytest.raises(ServerError) as e:
        c.health()
    assert e.value.status == 0


def test_sigterm_during_a_request_lets_it_finish():
    # the launch fault's delay holds the request in flight while SIGTERM
    # arrives: the drain waits for it, it answers 200, the process exits 0
    p, c = _spawn_daemon("--faults", "launch:delay:1:2.0")
    try:
        got = []
        t = threading.Thread(
            target=lambda: got.append(c.run_suite(ONE, runs=1)))
        t.start()
        probe = SpatterClient(c.url)
        _wait(lambda: probe.stats()["scheduler"]["busy"] == 1)
        p.send_signal(signal.SIGTERM)
        t.join(timeout=120)
        out, err = p.communicate(timeout=120)
    finally:
        p.kill()
    assert len(got) == 1 and got[0]["ok"] and all(_digests(got[0]))
    assert p.returncode == 0, (out, err[-3000:])
    assert "drained cleanly" in out


# ---------------------------------------------------------------------------
# parity with the JAX daemon
# ---------------------------------------------------------------------------

def _jax_serve(suite, **opts):
    with JDaemon(port=0, cache=JExecutorCache()) as d:
        return JClient(d.url).run_suite(suite, **opts)


def _port_serve(suite, **opts):
    with _daemon() as d:
        return SpatterClient(d.url).run_suite(suite, **opts)


@pytest.mark.parametrize("suite,port_backend", [
    ("demo", "torch"), ("demo", "hopper"),
    ("scatters", "torch"), ("scatters", "hopper"),
])
def test_digests_equal_the_jax_daemon(suite, port_backend):
    pats = DEMO if suite == "demo" else SCATTERS
    want = _jax_serve(pats, backend="xla", runs=1)
    got = _port_serve(pats, backend=port_backend, runs=1)
    assert _digests(got) == _digests(want) and all(_digests(got))
    for k in ("n_buckets", "pad_waste"):
        assert got["plan"][k] == want["plan"][k]
    assert got["cache"]["misses"] == want["cache"]["misses"]


def test_digests_equal_the_jax_daemon_pallas():
    # the JAX pallas backend in interpret mode, as its tests run it here
    small = [SUITE[0], SUITE[2], SCATTERS[3]]
    want = _jax_serve(small, backend="pallas", runs=1)
    got = _port_serve(small, backend="hopper", runs=1)
    assert _digests(got) == _digests(want) and all(_digests(got))
    assert got["plan"]["n_buckets"] == want["plan"]["n_buckets"]
    assert got["plan"]["pad_waste"] == want["plan"]["pad_waste"]


@pytest.mark.parametrize("port_backend", ["torch", "hopper"])
def test_add_mode_within_bound_of_the_jax_daemon(port_backend):
    # the daemons answer with digests; each daemon's digests equal its own
    # serial path's, whose outputs are held within add_error_bound
    got = _port_serve(SCATTERS, backend=port_backend, runs=1, mode="add")
    want = _jax_serve(SCATTERS, backend="xla", runs=1, mode="add")
    pats = [pattern.Pattern.from_json(d) for d in SCATTERS]
    sp = SuitePlan.build(pats)
    jp = j_plan.SuitePlan.build([j_pattern.Pattern(
        name=p.name, kind=p.kind, index=p.index, delta=p.delta,
        count=p.count) for p in pats])
    mine = dict(zip(range(len(pats)), _digests(got)))
    theirs = dict(zip(range(len(pats)), _digests(want)))
    works = make_work(sp, backend=port_backend, runs=1, mode="add",
                      digest=True, device="cpu")
    jworks = j_plan.make_work(jp, backend="xla", runs=1, mode="add",
                              digest=True)
    for work, jwork in zip(works, jworks):
        res = plan.launch((work,), ExecutorCache())
        jres = j_plan.launch((jwork,), JExecutorCache())
        for (pos, r), (jpos, jr) in zip(plan.demux(res, work),
                                        j_plan.demux(jres, jwork)):
            assert pos == jpos
            assert r.out_digest == mine[pos]
            assert jr.out_digest == theirs[pos]
        for i, p in enumerate(work.patterns):
            got_v = res.out[i, :p.footprint()].numpy().astype(np.float64)
            want_v = np.asarray(jres.out[i, :p.footprint()], np.float64)
            _, idx, vals, _ = make_host_buffers(p, 1, seed=0)
            bound = add_error_bound(torch.from_numpy(idx)[None],
                                    torch.from_numpy(vals)[None],
                                    p.footprint())[0].numpy()
            assert np.all(np.abs(got_v - want_v) <= bound), p.name
    assert got["plan"]["n_buckets"] == want["plan"]["n_buckets"]
    assert got["plan"]["pad_waste"] == want["plan"]["pad_waste"]


# ---------------------------------------------------------------------------
# the device lock: timed regions never overlap on one device
# ---------------------------------------------------------------------------

def test_timed_regions_never_overlap_on_one_device(monkeypatch):
    calls, guard = [], threading.Lock()
    real = plan._bucket_fn

    def recording(backend, kind, mode):
        fn = real(backend, kind, mode)

        def rec(*args):
            t0 = time.perf_counter()
            time.sleep(0.002)            # widen the window a race needs
            out = fn(*args)
            with guard:
                calls.append((t0, time.perf_counter()))
            return out
        return rec

    monkeypatch.setattr(plan, "_bucket_fn", recording)
    sched = Scheduler(ExecutorCache(), workers=4)
    try:
        tickets = [sched.submit(_work(MIXED, runs=3, digest=True, seed=s))
                   for s in range(6)]
        for t in tickets:
            t.wait(timeout=300)
    finally:
        sched.stop()
    assert len(calls) >= 3 * 4
    calls.sort()
    for (_, end), (start, _) in zip(calls, calls[1:]):
        assert start >= end, "two launches' calls overlapped on the device"
    ref = _serial_reference(MIXED, runs=1)
    assert _ticket_digests(tickets[0], len(ref)) == ref


# ---------------------------------------------------------------------------
# the scheduler (tests/test_scheduler.py)
# ---------------------------------------------------------------------------

def test_identical_concurrent_requests_one_compile_fewer_launches():
    cache = ExecutorCache()
    sched = Scheduler(cache, workers=2)
    n = 8
    try:
        sched.pause()
        tickets = [sched.submit(_work(SINGLE, runs=2, digest=True))
                   for _ in range(n)]
        assert sched.snapshot()["queue_depth"] == n
        sched.resume()
        for t in tickets:
            t.wait(timeout=300)
    finally:
        sched.stop()
    snap = sched.snapshot()
    assert snap["total_launches"] == 1 and snap["coalesced_launches"] == 1
    assert snap["submitted"] == n and snap["completed"] == n
    assert sum(t.misses for t in tickets) == 1
    assert cache.stats().misses == 1
    assert sum(1 for t in tickets if t.misses == 1) == 1
    assert all(t.launches == 1 and t.coalesced_launches == 1
               for t in tickets)
    assert all(t.queued_ms >= 0.0 and t.lock_wait_ms >= 0.0 for t in tickets)
    ref = _serial_reference(SINGLE, runs=2)
    assert all(d is not None for d in ref)
    for t in tickets:
        assert _ticket_digests(t, len(ref)) == ref


def test_mixed_suite_concurrency_matches_serial_digests():
    cache = ExecutorCache()
    sched = Scheduler(cache, workers=2)
    try:
        sched.pause()
        mixed = [sched.submit(_work(MIXED, runs=1, digest=True))
                 for _ in range(3)]
        single = [sched.submit(_work(SINGLE, runs=1, digest=True))
                  for _ in range(3)]
        sched.resume()
        for t in mixed + single:
            t.wait(timeout=300)
    finally:
        sched.stop()
    ref_mixed = _serial_reference(MIXED, runs=1)
    ref_single = _serial_reference(SINGLE, runs=1)
    for t in mixed:
        assert _ticket_digests(t, len(ref_mixed)) == ref_mixed
    for t in single:
        assert _ticket_digests(t, len(ref_single)) == ref_single
    assert sum(t.misses for t in mixed + single) == cache.stats().misses
    assert sched.snapshot()["total_launches"] < 6 * 2


def test_coalesce_member_cap_splits_launches():
    cache = ExecutorCache()
    sched = Scheduler(cache, workers=1, max_coalesce_members=1)
    try:
        sched.pause()
        tickets = [sched.submit(_work(SINGLE, runs=1, digest=True))
                   for _ in range(3)]
        sched.resume()
        for t in tickets:
            t.wait(timeout=300)
    finally:
        sched.stop()
    snap = sched.snapshot()
    assert snap["total_launches"] == 3 and snap["coalesced_launches"] == 0
    assert all(t.coalesced_launches == 0 for t in tickets)
    assert cache.stats().misses == 1
    assert sum(t.misses for t in tickets) == 1


def test_queue_full_rejects_before_any_launch():
    cache = ExecutorCache()
    sched = Scheduler(cache, workers=1, max_queue=2)
    try:
        sched.pause()
        t1 = sched.submit(_work(SINGLE, runs=1))
        t2 = sched.submit(_work(SINGLE, runs=1))
        with pytest.raises(QueueFull) as ei:
            sched.submit(_work(SINGLE, runs=1))
        assert ei.value.depth == 2 and ei.value.limit == 2
        assert cache.stats().misses == 0
        assert sched.snapshot()["total_launches"] == 0
        sched.resume()
        t1.wait(timeout=300)
        t2.wait(timeout=300)
    finally:
        sched.stop()
    assert sched.snapshot()["completed"] == 2


def test_submit_is_all_or_nothing():
    sched = Scheduler(ExecutorCache(), workers=1, max_queue=4)
    try:
        sched.pause()
        sched.submit(_work(MIXED, runs=1))
        with pytest.raises(QueueFull):
            sched.submit(_work(MIXED, runs=1))
        assert sched.snapshot()["queue_depth"] == 3
        assert sched.snapshot()["submitted"] == 1
        sched.resume()
    finally:
        sched.stop()


def test_stop_drains_queued_work():
    sched = Scheduler(ExecutorCache(), workers=2)
    sched.pause()
    tickets = [sched.submit(_work(MIXED, runs=1, digest=True))
               for _ in range(3)]
    sched.stop(drain=True)
    ref = _serial_reference(MIXED, runs=1)
    for t in tickets:
        assert t.done.is_set()
        t.wait(timeout=0.1)
        assert _ticket_digests(t, len(ref)) == ref
    snap = sched.snapshot()
    assert snap["queue_depth"] == 0
    assert snap["completed"] == 3 and snap["failed"] == 0
    assert snap["stopping"] is True
    with pytest.raises(SchedulerStopped):
        sched.submit(_work(SINGLE, runs=1))


def test_stop_without_drain_fails_queued_tickets():
    sched = Scheduler(ExecutorCache(), workers=1)
    sched.pause()
    tickets = [sched.submit(_work(SINGLE, runs=1)) for _ in range(2)]
    sched.stop(drain=False)
    for t in tickets:
        assert t.done.is_set()
        with pytest.raises(SchedulerStopped):
            t.wait(timeout=0.1)
    assert sched.snapshot()["failed"] == 2


def test_launch_failure_fails_only_its_ticket():
    sched = Scheduler(ExecutorCache(), workers=1)
    sched.pause()
    good = sched.submit(_work(SINGLE, runs=1, digest=True))
    victim = sched.submit(_work(MIXED, runs=1, digest=True))
    with sched._cv:
        victim.error = RuntimeError("injected: earlier bucket failed")
        victim.done.set()
    sched.resume()
    good.wait(timeout=300)
    sched.stop()
    assert good.error is None and len(good.results) == 1
    assert victim.results == {}
    assert sched.snapshot()["queue_depth"] == 0


def test_deadline_expired_in_queue_never_launches():
    cache = ExecutorCache()
    sched = Scheduler(cache, workers=1)
    try:
        sched.pause()
        doomed = sched.submit(_work(SINGLE, runs=1), deadline_s=0.05)
        fine = sched.submit(_work(SINGLE, runs=1, digest=True))
        time.sleep(0.2)
        sched.resume()
        with pytest.raises(DeadlineExceeded):
            doomed.wait(timeout=300)
        fine.wait(timeout=300)
    finally:
        sched.stop()
    snap = sched.snapshot()
    assert snap["deadline_expired"] == 1
    assert snap["failed"] == 1 and snap["completed"] == 1
    assert doomed.results == {} and doomed.launches == 0
    assert snap["total_launches"] == fine.launches == 1
    assert cache.stats().misses == 1 and fine.misses == 1


def test_unexpired_deadline_is_harmless():
    sched = Scheduler(ExecutorCache(), workers=1)
    try:
        t = sched.submit(_work(SINGLE, runs=1, digest=True),
                         deadline_s=300.0)
        t.wait(timeout=300)
    finally:
        sched.stop()
    assert t.error is None and len(t.results) == 1
    assert sched.snapshot()["deadline_expired"] == 0


def test_cancel_removes_queued_items_before_launch():
    cache = ExecutorCache()
    sched = Scheduler(cache, workers=1)
    try:
        sched.pause()
        victim = sched.submit(_work(MIXED, runs=1))
        survivor = sched.submit(_work(SINGLE, runs=1, digest=True))
        assert sched.cancel(victim) == 3
        assert sched.snapshot()["queue_depth"] == 1
        sched.resume()
        with pytest.raises(RequestCancelled):
            victim.wait(timeout=300)
        survivor.wait(timeout=300)
    finally:
        sched.stop()
    snap = sched.snapshot()
    assert snap["cancelled"] == 1 and snap["failed"] == 1
    assert victim.results == {} and victim.launches == 0
    assert snap["total_launches"] == 1
    assert cache.stats().misses == 1
    assert sched.cancel(survivor) == 0
    assert sched.snapshot()["cancelled"] == 1


def test_quarantine_after_consecutive_launch_failures():
    faults = FaultInjector.from_spec(f"launch:fail:{QUARANTINE_AFTER}")
    sched = Scheduler(ExecutorCache(), workers=1, max_coalesce_members=1,
                      faults=faults)
    try:
        for _ in range(QUARANTINE_AFTER):
            t = sched.submit(_work(SINGLE, runs=1))
            with pytest.raises(InjectedFault):
                t.wait(timeout=300)
        assert sched.snapshot()["quarantined_families"] == 1
        t = sched.submit(_work(SINGLE, runs=1))
        with pytest.raises(FamilyQuarantined):
            t.wait(timeout=300)
        assert sched.snapshot()["total_launches"] == QUARANTINE_AFTER
        assert sched.clear_quarantine() == 1
        t = sched.submit(_work(SINGLE, runs=1, digest=True))
        t.wait(timeout=300)
        assert len(t.results) == 1
    finally:
        sched.stop()
    assert sched.snapshot()["quarantined_families"] == 0


def test_a_raising_launch_fails_its_tickets_with_no_retry(monkeypatch):
    # a launch that raises (a CUDA error on the card) fails its tickets
    # and feeds the quarantine ledger; nothing reruns on a plain version
    calls = []

    def broken(backend, kind, mode):
        def fn(*args):
            calls.append(backend)
            raise RuntimeError("gather_rows_f32: CUDA error 700 at launch")
        return fn

    monkeypatch.setattr(plan, "_bucket_fn", broken)
    sched = Scheduler(ExecutorCache(), workers=1)
    try:
        t = sched.submit(_work(SINGLE, runs=1, backend="hopper"))
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            t.wait(timeout=300)
    finally:
        sched.stop()
    assert calls == ["hopper"]                  # the warm-up, once
    assert sched.snapshot()["failed"] == 1


# ---------------------------------------------------------------------------
# fault injection (tests/test_faults.py)
# ---------------------------------------------------------------------------

def test_spec_parsing():
    inj = FaultInjector.from_spec(
        "compile:fail:1, launch:delay:2:0.05,worker:kill:3")
    snap = inj.snapshot()
    assert [r["site"] for r in snap["rules"]] == ["compile", "launch",
                                                 "worker"]
    assert snap["rules"][1]["arg"] == 0.05 and snap["triggered"] == 0
    for bad in ("compile:fail", "disk:corrupt:0", "nope:fail:1",
                "compile:explode:1", "launch:delay:1:x", "launch:fail:-2"):
        with pytest.raises(ValueError):
            _parse_rule(bad)


def test_from_env_reads_spec_and_seed():
    assert FaultInjector.from_env({}) is None
    inj = FaultInjector.from_env({ENV_SPEC: "launch:fail:2",
                                  ENV_SPEC + "_SEED": "7"})
    assert inj.seed == 7
    assert inj.snapshot()["rules"][0]["times"] == 2


def test_rules_fire_exactly_times_then_exhaust():
    inj = FaultInjector.from_spec("compile:fail:2,worker:kill:1")
    for _ in range(2):
        with pytest.raises(InjectedFault):
            inj.check("compile")
    inj.check("compile")
    with pytest.raises(WorkerKilled):
        inj.check("worker")
    inj.check("worker")
    inj.check("launch")
    snap = inj.snapshot()
    assert snap["triggered"] == 3
    assert snap["consults"] == {"compile": 3, "worker": 2, "launch": 1}


def test_delay_jitter_is_seeded_deterministic(monkeypatch):
    import repro_torch.serve.faults as F
    slept = []
    monkeypatch.setattr(F.time, "sleep", slept.append)
    a = FaultInjector.from_spec("launch:delay:3:0.2", seed=11)
    b = FaultInjector.from_spec("launch:delay:3:0.2", seed=11)
    for _ in range(3):
        a.check("launch")
    first = list(slept)
    slept.clear()
    for _ in range(3):
        b.check("launch")
    assert slept == first
    assert all(0.1 <= s < 0.3 for s in first)


def test_mangle_flips_one_byte_then_exhausts():
    inj = FaultInjector.from_spec("disk:corrupt:1")
    payload = bytes(range(64))
    bad = inj.mangle("disk", payload)
    assert bad != payload and len(bad) == len(payload)
    assert sum(x != y for x, y in zip(bad, payload)) == 1
    assert inj.mangle("disk", payload) == payload


def test_compile_fault_fails_request_then_recovers():
    with _daemon("compile:fail:1") as d:
        c = SpatterClient(d.url)
        with pytest.raises(ServerError) as e:
            c.run_suite(ONE, runs=1)
        assert e.value.status == 500 and "InjectedFault" in str(e.value)
        assert c.health()["ok"]
        r = c.run_suite(ONE, runs=1)
        assert r["ok"] and r["cache"]["misses"] > 0
        s = c.stats()
        assert s["faults"]["triggered"] == 1
        assert r["cache"]["misses"] == s["cache"]["misses"]


def test_compile_fault_on_hopper_fails_without_fallback():
    # the reference degrades a failed pallas build to xla; the port has no
    # fallback: the hopper request fails, nothing is degraded, and the
    # next request builds the hopper bucket itself
    with _daemon("compile:fail:1") as d:
        c = SpatterClient(d.url)
        with pytest.raises(ServerError) as e:
            c.run_suite(ONE, runs=1, backend="hopper")
        assert e.value.status == 500
        r = c.run_suite(ONE, runs=1, backend="hopper")
        assert r["ok"] and r["cache"]["misses"] == 1
        assert r["stats"]["table"][0]["backend"] == "hopper"
        assert r["cache"]["lifetime"]["degraded"] == 0
        assert d.scheduler.snapshot()["failed"] == 1


def test_launch_fault_fails_one_request_only():
    with _daemon("launch:fail:1") as d:
        c = SpatterClient(d.url)
        with pytest.raises(ServerError) as e:
            c.run_suite(SUITE, runs=1)
        assert e.value.status == 500
        r = c.run_suite(SUITE, runs=1)
        assert r["ok"]
        s = c.stats()
        assert s["scheduler"]["failed"] == 1
        assert s["cache"]["misses"] == r["cache"]["misses"]


def test_latency_fault_slows_but_serves():
    with _daemon("launch:delay:1:0.2", seed=3) as d:
        c = SpatterClient(d.url)
        r = c.run_suite(ONE, runs=1)
        assert r["ok"] and r["elapsed_s"] >= 0.1
        assert c.stats()["faults"]["triggered"] == 1


def test_worker_kill_is_survived_and_respawned():
    with _daemon("worker:kill:1") as d:
        c = SpatterClient(d.url)
        _wait(lambda: c.stats()["scheduler"]["dead_workers"] == 1)
        _wait(lambda: c.stats()["scheduler"]["alive_workers"] == WORKERS)
        assert c.stats()["scheduler"]["respawned"] == 1
        r1 = c.run_suite(SUITE, runs=1)
        r2 = c.run_suite(SUITE, runs=1)
        assert r1["ok"] and r2["ok"]
        assert r2["cache"]["misses"] == 0


def test_quarantine_then_operator_reset():
    with _daemon(f"launch:fail:{QUARANTINE_AFTER}") as d:
        c = SpatterClient(d.url)
        for _ in range(QUARANTINE_AFTER):
            with pytest.raises(ServerError):
                c.run_suite(ONE, runs=1)
        assert c.stats()["scheduler"]["quarantined_families"] == 1
        launches = c.stats()["scheduler"]["total_launches"]
        with pytest.raises(ServerError, match="quarantined"):
            c.run_suite(ONE, runs=1)
        assert c.stats()["scheduler"]["total_launches"] == launches
        assert d.scheduler.clear_quarantine() == 1
        assert c.run_suite(ONE, runs=1)["ok"]


def test_load_fault_serves_cold_not_dead(tmp_path):
    with _daemon("load:fail:1", cache_dir=str(tmp_path)) as d:
        c = SpatterClient(d.url)
        _wait(lambda: c.readyz()["ready"])
        r = c.run_suite(ONE, runs=1)
        assert r["ok"] and r["cache"]["misses"] > 0
        assert c.stats()["faults"]["triggered"] == 1


def test_disk_corruption_quarantined_on_restart(tmp_path):
    root = str(tmp_path)
    with _daemon("disk:corrupt:1", cache_dir=root) as d:
        c = SpatterClient(d.url)
        r1 = c.run_suite(SUITE, runs=1, backend="hopper")
        n_buckets = r1["plan"]["n_buckets"]
        assert d.disk.stats()["stores"] == n_buckets
    with _daemon(cache_dir=root) as d:
        c = SpatterClient(d.url)
        r2 = c.run_suite(SUITE, runs=1, backend="hopper")
        assert _digests(r2) == _digests(r1)
        assert r2["cache"]["misses"] == 1
        s = c.stats()
        assert s["disk"]["quarantined"] == 1
        assert s["disk"]["loads"] == n_buckets - 1


def test_deadline_ms_expired_in_queue_is_504_and_launches_nothing():
    with _daemon() as d:
        c = SpatterClient(d.url)
        c.health()
        d.scheduler.pause()
        with pytest.raises(ServerError) as e:
            c.run_suite(ONE, runs=1, deadline_ms=150)
        assert e.value.status == 504 and e.value.doc["deadline_ms"] == 150
        snap = d.scheduler.snapshot()
        assert snap["total_launches"] == 0 and snap["queue_depth"] == 0
        assert d.cache.stats().misses == 0
        d.scheduler.resume()
        assert c.run_suite(ONE, runs=1, deadline_ms=60_000)["ok"]


def test_readyz_splits_from_healthz():
    with _daemon() as d:
        c = SpatterClient(d.url)
        _wait(lambda: c.readyz()["ready"])
        d.scheduler.pause()
        doc = c.readyz()
        assert not doc["ready"] and doc["paused"]
        assert c.health()["ok"]
        d.scheduler.resume()
        assert c.readyz()["ready"]


def test_client_retries_503_with_backoff():
    with _daemon(workers=1, max_queue=1) as d:
        c = SpatterClient(d.url, retries_503=4, backoff_base_s=0.05,
                          backoff_cap_s=0.2, backoff_seed=1)
        d.scheduler.pause()
        filler = threading.Thread(
            target=lambda: SpatterClient(d.url).run_suite(ONE, runs=1))
        filler.start()
        _wait(lambda: d.scheduler.snapshot()["queue_depth"] == 1)
        resumer = threading.Timer(0.3, d.scheduler.resume)
        resumer.start()
        try:
            assert c.run_suite(ONE, runs=1)["ok"]
        finally:
            resumer.cancel()
            d.scheduler.resume()
            filler.join(timeout=300)
    assert SpatterClient("http://x", timeout=1).retries_503 == 0


@pytest.mark.parametrize("spec", [
    "compile:fail:1",
    "launch:fail:1",
    "launch:delay:2:0.05",
    "worker:kill:1",
    "compile:fail:1,launch:fail:1,worker:kill:1",
])
def test_miss_exactness_survives_fault_matrix(spec):
    with _daemon(spec, seed=5) as d:
        c = SpatterClient(d.url)
        ok = []
        for suite in (SUITE, ONE, SUITE, SUITE):
            try:
                ok.append(c.run_suite(suite, runs=1, backend="hopper"))
            except ServerError as e:
                assert e.status == 500
        assert len(ok) >= 1
        assert c.health()["ok"]
        lifetime = c.stats()["cache"]["misses"]
        assert sum(r["cache"]["misses"] for r in ok) == lifetime
        assert c.stats()["faults"]["triggered"] >= 1
