"""repro_torch.analysis.cost (spattercost on the port) and the modeled
H100 column against the JAX package.

The byte model must give every unit of the reference's committed
``COST_baseline.json`` (its keys mapped ``pallas`` -> ``hopper``, ``xla``
-> ``torch``) the reference's bytes, and so must the port's own committed
``COST_baseline_torch.json``, which the matrix runner rewrites the same.
A census of each bucket call moves exactly the bytes the model prices.
The port never calibrates from a record that names no CUDA card.  The
sector model equals a brute-force count, and ``stream_r`` the
reference's ``pearson_r``, on the same inputs.  All comparisons are exact
but Pearson's R, held within 1e-12 (one float64 correlation computed
twice by the same numpy call).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import cost as j_cost
from repro.core import suite as j_suite
from repro_torch import bandwidth as bw
from repro_torch import pattern, suite
from repro_torch.analysis import cost
from repro_torch.analysis.__main__ import main as matrix
from repro_torch.engine import GSEngine
from repro_torch.plan import ExecKey, SuitePlan, enumerate_executables

ROOT = Path(__file__).resolve().parent.parent
TO_PORT = {"pallas": "hopper", "xla": "torch"}
BASELINE_MATRIX = ["--suite", "suites/demo.json", "--suite",
                   "suites/apps.json", "--suite", "suites/widelane.json",
                   "--mesh", "0", "--mesh", "1x1", "--mesh", "8x1",
                   "--mesh", "4x2", "--mesh", "1x8"]


def _ref_units():
    doc = json.loads((ROOT / "COST_baseline.json").read_text())
    return doc["units"]


def _port_key(ref_repr: str) -> ExecKey:
    """A reference ExecKey repr as the port's key."""
    fields = dict(eval(ref_repr.replace("ExecKey(", "dict(", 1)))
    fields["backend"] = TO_PORT[fields["backend"]]
    return ExecKey(**fields)


def test_io_bytes_equal_the_reference_baseline_for_every_key():
    ref = _ref_units()
    mine = cost.load_baseline(str(ROOT / cost.BASELINE_NAME))
    assert len(ref) == 194 and len(mine) == 194
    for ref_repr, want in ref.items():
        key = _port_key(ref_repr)
        got = cost.key_cost(key).io_bytes
        assert got == want, ref_repr
        assert mine[cost.key_id(key)] == want, ref_repr


def test_committed_baseline_is_what_the_runner_writes(tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(ROOT)
    out = tmp_path / "base.json"
    rc = matrix(["--cost", "--device", "cpu", "--devices", "cpu*8",
                 *BASELINE_MATRIX, "--write-baseline", str(out)])
    assert rc == 0
    assert json.loads(out.read_text()) == json.loads(
        (ROOT / cost.BASELINE_NAME).read_text())


def test_unit_cost_schema_is_the_references():
    mine = [f.name for f in dataclasses.fields(cost.UnitCost)]
    ref = [f.name for f in dataclasses.fields(j_cost.UnitCost)]
    assert mine == ref


@pytest.mark.parametrize("mesh", [None, (1, 2), (2, 1)])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("name", ["demo", "apps", "widelane"])
def test_census_bytes_equal_the_model(name, backend, mesh):
    rep = cost.cost_suite_file(str(ROOT / "suites" / f"{name}.json"),
                               mesh=mesh, backends=(backend,),
                               device="cpu", devices=["cpu"] * 2)
    assert rep.ok and rep.n_units > 0
    for u in rep.units:
        assert u.lowered_bytes == u.io_bytes
        copies = 2 if u.kind == "scatter" else 1     # dst in, result out
        assert u.useful_bytes + u.pad_bytes == u.io_bytes - u.index_bytes \
            - copies * u.table_bytes - u.keep_bytes
        assert u.predicted_gbs == -1.0 and u.backend == backend


def test_cost_report_roundtrips_and_parses_in_the_reference():
    rep = cost.cost_suite_file(str(ROOT / "suites" / "demo.json"),
                               device="cpu")
    doc = json.loads(json.dumps(rep.to_json()))
    assert cost.CostReport.from_json(doc).to_json() == doc
    assert j_cost.CostReport.from_json(doc).to_json() == doc
    ref = j_cost.CostReport(
        units=[j_cost.UnitCost(exec_key="k", io_bytes=7)],
        calibration={"source": "uncalibrated"}, rules=("cost-regression",))
    assert cost.CostReport.from_json(ref.to_json()).to_json() == \
        ref.to_json()
    with pytest.raises(ValueError, match="unknown"):
        cost.CostReport.from_json({"units": [], "bogus": 1})


def test_root_bench_record_does_not_calibrate(monkeypatch):
    monkeypatch.delenv(cost.BENCH_ENV, raising=False)
    assert cost.Calibration.from_record().source == "uncalibrated"
    root = str(ROOT / "BENCH_suite.json")
    assert json.loads(Path(root).read_text())["meta"]["device"] == "cpu"
    cal = cost.Calibration.from_record(root)
    assert cal.source == "uncalibrated" and not cal.bw_gbs
    monkeypatch.setenv(cost.BENCH_ENV, root)
    assert cost.Calibration.from_record().source == "uncalibrated"
    # the reference would calibrate from the same file
    assert j_cost.Calibration.from_bench(root).bw_gbs


def test_device_tagged_record_calibrates(tmp_path):
    record = {"meta": {"platform": "cuda",
                       "device": "NVIDIA H100 80GB HBM3",
                       "power_limit": "700.00 W"},
              "backends": {"hopper": {"hmean_measured_gbs": 100.0}}}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(record))
    cal = cost.Calibration.from_record(str(path))
    assert cal.bw_gbs == {"hopper": 100.0}
    assert cal.device == "NVIDIA H100 80GB HBM3, 700.00 W"
    for drop in ("platform", "device", "power_limit"):
        meta = {k: v for k, v in record["meta"].items() if k != drop}
        path.write_text(json.dumps({**record, "meta": meta}))
        assert cost.Calibration.from_record(str(path)).source == \
            "uncalibrated"
    path.write_text(json.dumps(record))
    rep = cost.cost_suite_file(str(ROOT / "suites" / "demo.json"),
                               backends=("hopper",), device="cpu",
                               calibration=cal)
    for u in rep.units:
        assert u.predicted_gbs == pytest.approx(
            100.0 * u.useful_bytes / u.device_bytes, rel=0, abs=0)
    assert rep.calibration["source"] == str(path)


def test_enumeration_costs_match_shape_cost():
    plan = SuitePlan.build(pattern.load_suite(str(ROOT / "suites" /
                                                  "apps.json")))
    for backend in ("torch", "hopper"):
        for shape in ((1, 1), (2, 1), (1, 2)):
            mesh = None if shape == (1, 1) else shape
            units = enumerate_executables(plan, backend=backend,
                                          placement=mesh, device="cpu",
                                          devices=["cpu"] * 2)
            total = sum(cost.key_cost(k).device_bytes for k, _, _ in units)
            assert total == cost.shape_cost(plan, shape,
                                            backend=backend)["device_bytes"]


# ---------------------------------------------------------------------------
# the modeled H100 column
# ---------------------------------------------------------------------------

def _brute_sectors(p, elem_bytes, sector, capacity):
    """Byte by byte, op by op, an LRU kept as a list."""
    lru, touched, fetched = [], 0, 0
    for op in range(p.count):
        secs = sorted({((p.delta * op + j) * elem_bytes + b) // sector
                       for j in p.index for b in range(elem_bytes)})
        touched += len(secs)
        for s in secs:
            if s in lru:
                lru.remove(s)
            else:
                fetched += 1
                if len(lru) == capacity:
                    lru.pop(0)
            lru.append(s)
    return touched, fetched


@pytest.mark.parametrize("capacity", [4, 64, 1 << 20])
@pytest.mark.parametrize("elem_bytes", [4, 12, 32, 68])
@pytest.mark.parametrize("spec,delta,count", [
    ("UNIFORM:8:1", 8, 20), ("UNIFORM:8:4", 8, 20), ("UNIFORM:4:16", 1, 30),
    ("MS1:8:4:32", 3, 25), ("BROADCAST:8:2", 0, 10), ("7,0,3,3,12", 5, 30),
])
def test_sector_model_equals_a_brute_force_count(spec, delta, count,
                                                 elem_bytes, capacity):
    p = pattern.make_pattern(spec, kind="gather", delta=delta, count=count)
    touched, fetched = _brute_sectors(p, elem_bytes, 32, capacity)
    m = bw.h100_sector_model(p, elem_bytes, sim_ops=count,
                             l2_bytes=capacity * 32)
    assert (m.touched_bytes, m.fetched_bytes) == (32 * touched,
                                                  32 * fetched)
    assert m.useful_bytes == p.index_len * count * elem_bytes
    assert m.modeled_time_s == max(m.hbm_time_s, m.l2_time_s)


def test_sector_model_extrapolates_like_the_tile_model():
    p = pattern.make_pattern("UNIFORM:8:1", kind="gather", delta=8,
                             count=1 << 24)
    m = bw.h100_sector_model(p, 4)
    # the CLI pattern: every sector once, at the HBM rate
    assert m.fetched_bytes == m.useful_bytes == 4 * 8 * (1 << 24)
    assert m.modeled_gbs == pytest.approx(bw.HBM_BW / 1e9, rel=1e-12)
    assert m.sector_efficiency == 1.0


def test_engine_and_planner_report_the_modeled_column():
    p = pattern.make_pattern("UNIFORM:8:4", kind="gather", delta=8,
                             count=64)
    r = GSEngine(p, device="cpu").run(runs=1)
    m = bw.h100_sector_model(p, 4)
    assert (r.modeled_gbs, r.sector_efficiency) == (m.modeled_gbs,
                                                    m.sector_efficiency)
    row = r.row()
    assert row["modeled_h100_gbs"] == m.modeled_gbs
    assert row["measured_gbs"] == r.measured_gbs
    st = suite.run_suite([p, dataclasses.replace(p, name="q", count=32)],
                         runs=1, device="cpu", metric="modeled")
    assert st.table("modeled")[0]["gbs"] == m.modeled_gbs
    assert st.to_json("modeled")["metric"] == "modeled_h100_gbs"
    assert st.hmean_gbs == suite.harmonic_mean(
        [x.modeled_gbs for x in st.results])


def test_stream_r_equals_the_reference_pearson_r():
    pats = pattern.load_suite(str(ROOT / "suites" / "demo.json"))
    st = suite.run_suite(pats, runs=1, device="cpu", stream_r=True,
                         stream_n=1 << 10)
    want = j_suite.pearson_r([r.measured_gbs for r in st.results],
                             [r.modeled_gbs for r in st.results])
    assert np.isfinite(st.stream_r)
    assert abs(st.stream_r - want) <= 1e-12
    assert suite.pearson_r([1.0, 2.0], [5.0, 5.0]) != \
        suite.pearson_r([1.0, 2.0], [5.0, 5.0])      # NaN, as the reference
