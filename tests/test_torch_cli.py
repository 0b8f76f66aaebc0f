"""The port's CLI serve modes, its quickstart, the add kernel's padding
payloads and ``bandwidth.pipeline_model``.

* ``python -m repro_torch --serve`` runs spatterd, ``--client URL --json``
  posts a suite to it and ``--client URL --stats`` reads its counters; the
  CLI refuses every combination the reference's CLI refuses
  (``examples/spatter_cli.py``), with argparse's exit code 2.
* ``examples/quickstart_torch.py --device cpu`` runs.
* The add kernel skips lanes whose payload is +0.0 or -0.0 (a zeroed dst
  never holds -0.0, so the sum is unchanged); the planner's padding lanes
  and scratch patterns must all carry +0.0 for that skip to take them.
* ``pipeline_model`` returns the reference's keys (``vecs`` for
  ``buffers``) and never makes one load a thread faster than ``kVecs``.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import bandwidth as j_bandwidth
from repro.core import pattern as j_pattern
from repro_torch import appdb, bandwidth, pattern, plan
from repro_torch.__main__ import main as cli

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
DEMO = str(ROOT / "suites" / "demo.json")


def _env():
    return {**os.environ, "PYTHONPATH": SRC, "PYTHONUNBUFFERED": "1"}


# ---------------------------------------------------------------------------
# the add kernel's precondition: padding and scratch payloads are +0.0


@pytest.mark.parametrize("members,batch,lanes", [
    (1, 2, None),          # a scratch pattern (a batch split's pad)
    (3, 4, None),          # pow-2 batch padding
    (2, 2, 64),            # extra lanes (a lane split's shard multiple)
    (1, 8, 128)])
def test_add_padding_lanes_and_scratch_patterns_carry_plus_zero(
        members, batch, lanes):
    pats = [pattern.make_pattern("UNIFORM:8:1", kind="scatter", delta=3,
                                 count=5, name=f"s{i}")
            for i in range(members)]
    spec = plan.BucketSpec.of(pats[0])
    (idx, vals, keep), real = plan._host_members(
        spec, pats, 1, [0] * members, batch=batch, mode="add", lanes=lanes)
    n_pad = spec.idx_len if lanes is None else lanes
    assert idx.shape == (batch, n_pad) and vals.shape == (batch, n_pad, 1)
    pad = np.ones((batch, n_pad), bool)
    for b, n in enumerate(real):
        pad[b, :n] = False
    assert pad.any()
    # every padding lane points at the scratch row with a +0.0 payload
    assert (idx[pad] == spec.footprint).all()
    assert (vals[pad] == 0).all() and not np.signbit(vals[pad]).any()
    assert not keep.any()                 # add mode reads no keep mask


# ---------------------------------------------------------------------------
# refusals: the reference CLI's exclusive combinations, exit code 2

# each option the reference names, as argv
OPT = {"json": ["--json", DEMO], "no_batch": ["--no-batch"],
       "client": ["--client", "http://127.0.0.1:9"],
       "kernel": ["-k", "Gather"], "pattern": ["-p", "UNIFORM:8:1"],
       "delta": ["-d", "8"], "count": ["-l", "16"], "runs": ["-r", "1"],
       "stream_r": ["--stream-r"], "host": ["--host", "127.0.0.1"],
       "port": ["--port", "0"], "stats": ["--stats"],
       "cache_dir": ["--cache-dir", "d"], "cost": ["--cost", DEMO],
       "cost_out": ["--cost-out", "f"], "serve": ["--serve"],
       "mesh": ["--mesh", "2"], "mode": ["--mode", "add"],
       "backend": ["-b", "hopper"], "row_width": ["--row-width", "2"]}
# the reference's lists (examples/spatter_cli.py), mode by mode
LINT_BAD = ("json", "no_batch", "client", "kernel", "pattern", "delta",
            "count", "runs", "stream_r", "host", "port", "stats",
            "cache_dir", "cost", "cost_out", "serve")
COST_BAD = ("json", "no_batch", "client", "kernel", "pattern", "delta",
            "count", "runs", "stream_r", "host", "port", "stats",
            "cache_dir", "serve")
SERVE_BAD = ("json", "no_batch", "mesh", "mode", "backend", "row_width",
             "runs", "kernel", "pattern", "delta", "count", "stream_r",
             "stats", "client")
STATS_BAD = ("json", "no_batch", "mesh", "mode", "backend", "row_width",
             "runs", "kernel", "pattern", "delta", "count", "stream_r",
             "host", "port", "cache_dir")
CLIENT_BAD = ("no_batch", "kernel", "pattern", "delta", "count", "host",
              "port", "cache_dir")
LOCAL_BAD = ("host", "port", "cache_dir", "stats")

REFUSED = (
    [(["--lint", DEMO] + OPT[o], f"lint+{o}") for o in LINT_BAD]
    + [(["--cost", DEMO] + OPT[o], f"cost+{o}") for o in COST_BAD]
    + [(["--serve"] + OPT[o], f"serve+{o}") for o in SERVE_BAD]
    + [(OPT["client"] + ["--stats"] + OPT[o], f"stats+{o}")
       for o in STATS_BAD]
    + [(OPT["client"] + OPT["json"] + OPT[o], f"client+{o}")
       for o in CLIENT_BAD]
    + [(OPT[o], f"local+{o}") for o in LOCAL_BAD]
    + [(OPT["client"], "client without --json"),
       (["--lint-out", "f"], "lint-out without --lint"),
       (["--cost-out", "f"], "cost-out without --cost")])


@pytest.mark.parametrize("argv", [a for a, _ in REFUSED],
                         ids=[i for _, i in REFUSED])
def test_refused_combinations_exit_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli(argv)
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the serve modes on the CPU


def test_serve_client_and_stats_through_the_cli(tmp_path):
    daemon = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "--serve", "--port", "0",
         "--device", "cpu", "--cache-dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())
    try:
        line = daemon.stdout.readline()
        assert "listening on" in line, (line, daemon.stderr.read()[-3000:])
        url = line.split("listening on")[1].split()[0]
        posted = subprocess.run(
            [sys.executable, "-m", "repro_torch", "--client", url, "--json",
             DEMO, "-b", "hopper", "-r", "1"],
            capture_output=True, text=True, timeout=300, env=_env())
        assert posted.returncode == 0, posted.stderr[-3000:]
        assert "suite: min" in posted.stdout
        assert "misses 4 " in posted.stdout          # demo's 4 buckets
        stats = subprocess.run(
            [sys.executable, "-m", "repro_torch", "--client", url,
             "--stats"], capture_output=True, text=True, timeout=120,
            env=_env())
        assert stats.returncode == 0, stats.stderr[-3000:]
        doc = json.loads(stats.stdout)
        assert doc["cache"]["misses"] == 4
        assert doc["disk"]["stores"] == 4
        daemon.send_signal(signal.SIGTERM)
        out, err = daemon.communicate(timeout=120)
    finally:
        daemon.kill()
    assert daemon.returncode == 0, err[-3000:]
    assert "drained cleanly" in out


def test_quickstart_runs_on_the_cpu():
    r = subprocess.run([sys.executable, str(ROOT / "examples" /
                                            "quickstart_torch.py"),
                        "--device", "cpu"],
                       capture_output=True, text=True, timeout=600,
                       env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "modeled(h100)" in r.stdout and "v5e" not in r.stdout
    assert "suite harmonic mean" in r.stdout
    assert "custom scatter" in r.stdout


# ---------------------------------------------------------------------------
# pipeline_model


def _patterns():
    pats = [pattern.make_pattern("UNIFORM:8:1", kind="gather", delta=8,
                                 count=1 << 24)]
    pats += [pattern.make_pattern(f"UNIFORM:8:{s}", delta=8 * s,
                                  count=1 << 14) for s in (1, 2, 4, 8)]
    pats += appdb.scale_counts(appdb.ALL_PATTERNS[:6], 1 / 64)
    return pats


def test_pipeline_model_keys_match_the_reference():
    p = _patterns()[0]
    jp = j_pattern.make_pattern("UNIFORM:8:1", kind="gather", delta=8,
                                count=1 << 10)
    ref = j_bandwidth.pipeline_model(jp, 4)
    got = bandwidth.pipeline_model(p, 4)
    assert set(got) == (set(ref) - {"buffers"}) | {"vecs"}
    assert got["vecs"] == bandwidth.K_VECS
    assert got["modeled_time_s"] == pytest.approx(
        max(got["bw_time_s"], got["latency_time_s"]))


@pytest.mark.parametrize("p", _patterns(), ids=lambda p: p.name)
def test_one_load_a_thread_is_never_faster_in_the_model(p):
    one = bandwidth.pipeline_model(p, 4, vecs=1)
    deep = bandwidth.pipeline_model(p, 4, vecs=bandwidth.K_VECS)
    assert one["modeled_time_s"] >= deep["modeled_time_s"]
    assert one["modeled_gbs"] <= deep["modeled_gbs"]
    assert one["bw_time_s"] == deep["bw_time_s"]
    assert one["latency_time_s"] >= deep["latency_time_s"]
    assert one["modeled_time_s"] == pytest.approx(one["bw_time_s"]
                                                  + one["latency_time_s"])


def test_pipeline_model_refuses_no_loads():
    with pytest.raises(ValueError):
        bandwidth.pipeline_model(_patterns()[0], 4, vecs=0)
