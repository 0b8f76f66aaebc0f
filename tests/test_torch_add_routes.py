"""The add's two routes (``csrc/scatter_rows.cu``): streaming, and hot rows
summed in float32 shared memory.

The route is ``autotune._search_scatter_add``'s closed-form choice,
carried in ``TileChoice.smem`` through the wire format and the disk tier.
On the CPU the wrapper runs the plain version whatever the route, so the
hot-row route's arithmetic is held here through an emulation of its
two-level sum (float32 sums a block, each rounded once to the dtype and
added into dst in the dtype) against ``ref.hot_row_error_bound`` and
``add_error_bound``; the kernels meet both routes on the card
(``chip_smoke.py``, phase 1).  The 16-bit add on a LULESH-S3-like pattern
(delta 0, every lane onto 16 rows) is held against the reference's
``xla`` add at the same dtype.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as j_plan
from repro_torch import appdb, host, plan
from repro_torch.diskcache import DiskTier
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.scatter_rows import ops as scatter_ops
from repro_torch.kernels.scatter_rows.ref import (UNIT_ROUNDOFF,
                                                  add_error_bound,
                                                  add_rms_error,
                                                  hot_row_error_bound,
                                                  hot_row_rounds,
                                                  scatter_add_rows_ref_)
from repro_torch.pattern import Pattern
from test_torch_diskcache import FakeToolchain
from test_torch_plan import _j

H100 = "cuda:sm90:132sm:2048t"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True)
def _fresh_memo():
    autotune.reset()
    yield
    autotune.reset()


def _key(batch, lanes, rows, width=1, dtype="bfloat16", platform=H100):
    return autotune.TileKey(op="scatter_add", batch=batch, lanes=lanes,
                            rows=rows, width=width, dtype=dtype,
                            platform=platform)


def _lulesh(count):
    return Pattern(name="LULESH-S3", kind="scatter", index=tuple(range(16)),
                   delta=0, count=count, source="LULESH")


# ---------------------------------------------------------------------------
# the route choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("platform", [H100, "cpu"])
@pytest.mark.parametrize("geometry,smem", [
    # LULESH-S3 at scale 1.0: 2^25 lanes onto its 16 rows and the scratch row
    ((1, 1 << 25, 17, 1), 1),
    # the CLI pattern: 2^27 lanes onto 2^27 + 1 rows, one a row
    ((1, 1 << 27, (1 << 27) + 1, 1), 0),
    # V x D float32 accumulators past the budget, however many lanes
    ((1, 1 << 30, 60000, 1), 0),
    ((1, 1 << 30, 256, 228), 0),
    # few lanes a row: 1000 lanes onto 16 rows, and 16 lanes a row of 4096
    ((1, 1000, 16, 1), 0),
    ((3, 1 << 16, 4096, 1), 0),
    # 1024 lanes a row of 4096 rows (16 KB of accumulators), 256 a row of
    # 16384 rows (64 KB)
    ((1, 1 << 22, 4096, 1), 1),
    ((8, 1 << 22, 16384, 1), 1),
], ids=["lulesh_s3", "cli", "rows_past_budget", "width_past_budget",
        "few_lanes", "few_lanes_a_row", "k1024", "k256_64kb"])
def test_route_choice(geometry, smem, platform, dtype):
    key = _key(*geometry, dtype=dtype, platform=platform)
    assert autotune.choose(key) == autotune.TileChoice(smem=smem)
    assert autotune.LEGACY["scatter_add"](key) == autotune.TileChoice()
    with autotune.disabled():
        assert autotune.choose(key) == autotune.TileChoice()


@pytest.mark.parametrize("batch,rows", [(1, 1), (1, 17), (3, 16), (300, 2),
                                        (1, 8192)])
def test_route_switch_at_hot_min_lanes(batch, rows):
    at = autotune.hot_min_lanes(_key(batch, 0, rows))
    assert at == autotune.HOT_MIN_LANES_A_ROW * rows
    hot = autotune.choose(_key(batch, at, rows))
    below = autotune.choose(_key(batch, at - 1, rows))
    assert (hot.smem, below.smem) == (1, 0)
    # past the rule's budget the route is not chosen, however many lanes
    wide = _key(batch, 1 << 30, autotune.HOT_SMEM_BYTES // 4 + 1)
    assert autotune.choose(wide).smem == 0


@pytest.mark.parametrize("batch", [1, 3, 300])
def test_hot_ctas_fill_the_card_within_the_lanes(batch):
    fill = -(-autotune.HOT_CTAS_PER_SM * 132 // batch)
    per = autotune.HOT_LANES_PER_ACC * 17
    assert autotune.hot_ctas(_key(batch, per * fill, 17)) == fill
    assert autotune.hot_ctas(_key(batch, 4 * per * fill, 17)) == fill
    assert autotune.hot_ctas(_key(batch, per * 3, 17)) == min(3, fill)
    assert autotune.hot_ctas(_key(batch, 1, 17)) == 1


def test_rule_budget_is_the_accumulators_bytes():
    most = autotune.HOT_SMEM_BYTES // 4
    lanes = autotune.HOT_MIN_LANES_A_ROW * (most + 1)
    assert autotune.choose(_key(1, lanes, most)).smem == 1
    assert autotune.choose(_key(1, lanes, most + 1)).smem == 0
    assert autotune.choose(_key(1, lanes, most // 8, width=8)).smem == 1
    assert autotune.choose(_key(1, lanes, most // 8 + 1, width=8)).smem == 0
    assert autotune.choose(_key(1, lanes, 0)).smem == 0
    # within a block's 227 KB, where the kernel's own check refuses
    assert autotune.HOT_SMEM_BYTES <= 232448


def test_appdb_add_buckets_route_only_lulesh_s3_hot():
    sp = plan.SuitePlan.build(appdb.scale_counts(appdb.ALL_PATTERNS, 1.0))
    hot = []
    for bucket in sp.buckets:
        if bucket.spec.kind != "scatter":
            continue
        key = plan.ExecKey(backend="hopper", kind="scatter",
                           idx_len=bucket.spec.idx_len,
                           footprint=bucket.spec.footprint, dtype="bfloat16",
                           row_width=1, mode="add",
                           batch=len(bucket.members))
        if plan.bucket_tiles(key, torch.device("cpu")).smem:
            hot += [sp.patterns[m].name for m in bucket.members]
    assert hot == ["LULESH-S3"]


# ---------------------------------------------------------------------------
# the wire format and the disk tier
# ---------------------------------------------------------------------------

def test_choice_round_trips_the_wire():
    key = _key(1, 1 << 25, 17)
    choice = autotune.choose(key)
    assert choice.to_wire() == [1, 0, 0, 0]
    assert autotune.TileChoice.from_wire(choice.to_wire()) == choice
    wire = autotune.to_wire({key: choice})
    assert json.loads(json.dumps(wire)) == wire
    autotune.reset()
    assert autotune.seed_wire(wire) == 1
    assert autotune.lookup(key) == choice
    assert autotune.stats() == {"searched": 0, "hits": 0, "seeded": 1}


def _lulesh_plan(count=8192):
    return plan.SuitePlan.build([_lulesh(count)])


def _add_digests(cache, sp, dtype=torch.bfloat16):
    return [r.out_digest for r in plan.run_plan(
        sp, backend="hopper", runs=1, digest=True, device="cpu",
        mode="add", dtype=dtype, cache=cache)]


def _scatter_add_keys(wire):
    return {k: v for k, v in wire.items() if k.startswith("scatter_add:")}


def test_disk_tier_carries_the_hot_route(tmp_path):
    sp = _lulesh_plan()
    ref = _add_digests(plan.ExecutorCache(disk=DiskTier(str(tmp_path),
                                                       device="cpu")), sp)
    headers = [json.loads(f.read_bytes().split(b"\n")[1])
               for f in tmp_path.glob("*.spx")]
    tiles = _scatter_add_keys({k: v for h in headers
                               for k, v in h["tiles"].items()})
    assert list(tiles.values()) == [[1, 0, 0, 0]]
    key = autotune.key_from_wire(next(iter(tiles)))
    assert (key.lanes, key.rows, key.dtype) == (8192 * 16, 17, "bfloat16")
    autotune.reset()
    warm = plan.ExecutorCache()
    warm.attach_disk(DiskTier(str(tmp_path), device="cpu"), preload=True)
    assert autotune.lookup(key) == autotune.TileChoice(smem=1)
    assert _add_digests(warm, sp) == ref
    assert autotune.stats()["searched"] == 0
    assert warm.stats().disk_hits == sp.n_buckets


def test_exec_entry_of_an_older_add_source_is_stale(tmp_path, monkeypatch):
    # an entry written by a build of another scatter_rows.cu recorded that
    # library's sha256 and the choice then made (the streaming route, the
    # only one there was): against the new source's library it is stale,
    # so it is quarantined and rebuilt, and its choice is not seeded
    fake = FakeToolchain(monkeypatch)
    monkeypatch.setattr(fake, "compile", lambda jobs: _compile_by_source(
        fake, jobs))
    monkeypatch.setattr(_build, "_compile", fake.compile)
    older = tmp_path / "csrc"
    older.mkdir()
    for f in _build.CSRC_DIR.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (older / f.name).write_bytes(f.read_bytes())
    text = (older / "scatter_rows.cu").read_text()
    (older / "scatter_rows.cu").write_text(
        text.replace("scatter_add_rows_hot_kernel", "older_add_kernel"))
    root = tmp_path / "tier"
    sp = _lulesh_plan()
    monkeypatch.setattr(_build, "CSRC_DIR", older)
    ref = _add_digests(plan.ExecutorCache(disk=DiskTier(str(root),
                                                       device="cpu")), sp)
    for f in root.glob("*.spx"):
        raw = f.read_bytes()
        magic, _, rest = raw.partition(b"\n")
        header, _, payload = rest.partition(b"\n")
        doc = json.loads(header)
        if doc["entry"] == "exec":
            doc["tiles"] = {k: [0, 0, 0, 0] for k in doc["tiles"]}
            f.write_bytes(magic + b"\n" + json.dumps(doc).encode() + b"\n"
                          + payload)
    monkeypatch.setattr(_build, "CSRC_DIR", _build.PKG_DIR / "csrc")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_loaded", {})
    autotune.reset()
    warm = plan.ExecutorCache()
    tier = DiskTier(str(root), device="cpu")
    assert warm.attach_disk(tier, preload=True) == 0
    assert tier.stats()["quarantined"] == sp.n_buckets
    assert autotune.stats()["seeded"] == 0
    assert _add_digests(warm, sp) == ref
    assert warm.stats().misses == sp.n_buckets
    assert fake.builds.count("scatter_rows") == 2
    key = autotune.TileKey(op="scatter_add", batch=1, lanes=8192 * 16,
                           rows=17, width=1, dtype="bfloat16",
                           platform="cpu")
    assert autotune.lookup(key) == autotune.TileChoice(smem=1)


def _compile_by_source(fake, jobs):
    """nvcc faked: a library's bytes follow its source (its identity)."""
    for name, out in jobs.items():
        fake.builds.append(name)
        _build.nvcc_runs += 1
        Path(out).write_bytes(f"{name}:{_build.lib_identity(name)}".encode())
    return {name: "" for name in jobs}


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("smem", [None, 0, 1])
def test_cpu_wrapper_runs_the_plain_version_on_either_route(smem, dname):
    tdt = DTYPES[dname][0]
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(-1, 17, (2, 300), dtype=np.int32))
    idx[0, :2] = INT32_MAX
    vals = torch.from_numpy(rng.standard_normal((2, 300, 3))).to(tdt)
    want = scatter_add_rows_ref_(torch.zeros(2, 16, 3, dtype=tdt), idx,
                                 vals)
    got = scatter_ops.scatter_add_rows_(torch.zeros(2, 16, 3, dtype=tdt),
                                        idx, vals, smem=smem)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    # a forced hot-row route past a block's 227 KB is the card's refusal,
    # not the plain version's
    big = torch.zeros(1, 232448 // 4 + 1, 1, dtype=tdt)
    scatter_ops.scatter_add_rows_(big, idx[:1], vals[:1, :, :1].contiguous(),
                                  smem=1)


def test_add_tiles_and_hot_ctas_read_the_cpu_facts():
    cpu = torch.device("cpu")
    assert scatter_ops.add_tiles(1, 1 << 25, 17, 1, cpu, torch.bfloat16) == \
        autotune.TileChoice(smem=1)
    assert scatter_ops.hot_ctas(1, 1 << 25, 17, 1, cpu, torch.bfloat16) == \
        autotune.HOT_CTAS_PER_SM * autotune.CPU_FACTS.sms
    assert scatter_ops.add_tiles(1, 1 << 27, (1 << 27) + 1, 1, cpu,
                                 torch.float32) == autotune.TileChoice()


def test_add_entries_take_the_blocks_a_pattern():
    for t in ("f32", "bf16", "f16"):
        sig = _build._SIGNATURES["scatter_rows"][f"scatter_add_rows_{t}"]
        assert len(sig) == 9                 # dst idx vals B N V D ctas stream


# ---------------------------------------------------------------------------
# the hot-row route's rounding count and its bound
# ---------------------------------------------------------------------------

def test_hot_row_rounds():
    k = torch.tensor([0.0, 1, 2, 3, 100, 1 << 21], dtype=torch.float64)
    assert hot_row_rounds(k, 264, torch.bfloat16).tolist() == \
        [0, 0, 1, 2, 99, 264]
    assert hot_row_rounds(k, 1, torch.float16).tolist() == \
        [0, 0, 1, 1, 1, 1]
    assert hot_row_rounds(k, 264, torch.float32).tolist() == [0] * 6


def _hot_route(idx, vals, v, ctas):
    """The hot-row route's sum on the CPU: block c of a pattern takes the
    lanes of 256-lane groups c, c + ctas, ... (the kernel's stride), sums
    them in float32 (here in lane order), rounds its sum to the dtype once
    and adds it into dst in the dtype, the blocks in turn."""
    bsz, n, d = vals.shape
    block = (torch.arange(n) // 256) % ctas
    out = torch.zeros(bsz, v, d, dtype=vals.dtype)
    for c in range(ctas):
        part = scatter_add_rows_ref_(
            torch.zeros(bsz, v, d), torch.where(block == c, idx, -1),
            vals.float())
        out = (out.float() + part.to(vals.dtype).float()).to(vals.dtype)
    return out


def _exact(idx, vals, v):
    return scatter_add_rows_ref_(torch.zeros(idx.shape[0], v, vals.shape[2],
                                             dtype=torch.float64), idx,
                                 vals.double())


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("bsz,n,v,d,ctas", [
    (1, 4096, 16, 1, 8), (1, 20000, 16, 1, 60), (3, 2000, 17, 3, 4),
    (2, 9000, 1, 2, 30), (1, 3000, 200, 8, 3), (1, 700, 600, 1, 2)])
def test_hot_route_emulation_within_its_bound(bsz, n, v, d, ctas, dname):
    tdt = DTYPES[dname][0]
    rng = np.random.default_rng(n + v)
    idx = torch.from_numpy(rng.integers(0, v, (bsz, n), dtype=np.int32))
    idx[:, ::13] = INT32_MAX
    vals = torch.from_numpy(rng.standard_normal((bsz, n, d))).to(tdt)
    vals.view(-1)[::7] = -0.0
    got = _hot_route(idx, vals, v, ctas)
    assert bool(torch.isfinite(got).all())
    exact = _exact(idx, vals, v)
    own = hot_row_error_bound(idx, vals, v, ctas)
    assert bool(((got.double() - exact).abs() <= own).all())
    assert bool((own < torch.inf).all())
    bound = add_error_bound(idx, vals, v)
    fin = torch.isfinite(bound)
    want = scatter_add_rows_ref_(torch.zeros(bsz, v, d, dtype=tdt), idx,
                                 vals)
    diff = (got.double() - want.double()).abs()
    assert bool((diff[fin] <= bound[fin]).all())
    # where add_error_bound is finite the route's own bound lies inside it
    assert bool((2 * own[fin] <= bound[fin] + 1e-300).all())


def test_hot_route_rounds_fewer_times_than_lanes():
    # 2^14 lanes onto one row in bfloat16: a sum in the dtype stalls once
    # the row's value dwarfs a lane's (K u >= 1/2), the hot route's float32
    # partials do not, and its bound is finite where add_error_bound is not
    rng = np.random.default_rng(5)
    n = 1 << 14
    idx = torch.zeros(1, n, dtype=torch.int32)
    vals = torch.from_numpy(np.abs(rng.standard_normal((1, n, 1)))).to(
        torch.bfloat16)
    exact = _exact(idx, vals, 1)
    got = _hot_route(idx, vals, 1, 4)
    lane_by_lane = torch.zeros((), dtype=torch.bfloat16)
    for x in vals.view(-1):            # each sum rounded, as an atomic's
        lane_by_lane = (lane_by_lane.float() + x.float()).to(torch.bfloat16)
    assert torch.isinf(add_error_bound(idx, vals, 1)).all()
    own = hot_row_error_bound(idx, vals, 1, 4)
    assert bool(((got.double() - exact).abs() <= own).all())
    assert (got.double() - exact).abs().item() < \
        (lane_by_lane.double() - exact).abs().item() / 10
    u = UNIT_ROUNDOFF[torch.bfloat16]
    assert own.item() <= ((1 + u) ** 4 * (1 + 2.0 ** -24) ** (n - 1) - 1) * \
        vals.double().abs().sum().item() * (1 + 1e-12)


# ---------------------------------------------------------------------------
# the rounding model the card's LULESH-S3 adds are held to (chip_smoke.py
# RMS_ERRORS of it): a right sum stays within one of it, none at all is
# many of it away
# ---------------------------------------------------------------------------

def test_add_rms_error_formula():
    idx = torch.tensor([[0, 0, 0, 2, -1]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, -3.0, 5.0, 7.0]]).to(
        torch.bfloat16)[..., None]
    u = UNIT_ROUNDOFF[torch.bfloat16]
    # row 0: K = 3, sum 0, sum of squares 14; row 1 takes nothing; row 2
    # one lane
    stream = add_rms_error(idx, vals, 3)[0, :, 0].tolist()
    assert stream == pytest.approx([u * 3 ** 0.5 * 14 ** 0.5, 0.0,
                                    u * 50 ** 0.5], rel=1e-12)
    # hot rows over 2 blocks: min(2, K - 1) = 2 roundings in bfloat16 and
    # K - 1 in float32 for row 0
    hot = add_rms_error(idx, vals, 3, ctas=2)[0, :, 0].tolist()
    assert hot == pytest.approx([(3 * u * u + 2 * 2.0 ** -48) ** 0.5
                                 * 14 ** 0.5, 0.0, u * 50 ** 0.5],
                                rel=1e-12)
    # float32: the same on either route
    v32 = vals.float()
    assert torch.allclose(add_rms_error(idx, v32, 3),
                          add_rms_error(idx, v32, 3, ctas=2), rtol=1e-12)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("bsz,n,v,d,ctas", [
    (1, 1 << 16, 16, 1, 64), (1, 20000, 16, 1, 60), (3, 2000, 17, 3, 4)])
def test_add_rms_error_holds_the_hot_route(bsz, n, v, d, ctas, dname):
    tdt = DTYPES[dname][0]
    rng = np.random.default_rng(n + ctas)
    idx = torch.from_numpy((np.arange(bsz * n) % v).astype(np.int32)
                           ).view(bsz, n)
    vals = torch.from_numpy(rng.standard_normal((bsz, n, d))).to(tdt)
    exact = _exact(idx, vals, v)
    sigma = add_rms_error(idx, vals, v, ctas)
    got = _hot_route(idx, vals, v, ctas)
    assert bool(((got.double() - exact).abs() <= sigma).all())
    # a kernel that wrote nothing is more than 6 of them off
    assert bool((exact.abs() > 6 * sigma).any())


@pytest.mark.parametrize("dname", list(DTYPES))
def test_add_rms_error_holds_a_lane_by_lane_sum(dname):
    # the streaming route on 16 rows of 1024 lanes: every atomic's sum
    # rounded to the dtype, lane by lane
    tdt = DTYPES[dname][0]
    rng = np.random.default_rng(9)
    k, v = 1024, 16
    idx = torch.arange(k * v, dtype=torch.int32).remainder(v)[None]
    vals = torch.from_numpy(rng.standard_normal((1, k * v, 1))).to(tdt)
    acc = torch.zeros(v, dtype=tdt)
    for lane in vals.view(k, v):
        acc = (acc.float() + lane.float()).to(tdt)
    err = (acc.double() - _exact(idx, vals, v).view(v)).abs()
    assert bool((err <= add_rms_error(idx, vals, v).view(v)).all())


# ---------------------------------------------------------------------------
# the 16-bit add on a LULESH-S3-like pattern, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dname", ["bfloat16", "float16"])
@pytest.mark.parametrize("count", [4, 64, 512])
def test_lulesh_like_add_within_bound_of_reference(count, dname):
    tdt, jdt = DTYPES[dname]
    pats = [_lulesh(count)]
    mine = plan.SuitePlan.build(pats)
    ref = j_plan.SuitePlan.build([_j(p) for p in pats])
    (work,) = plan.make_work(mine, backend="hopper", runs=1, mode="add",
                             digest=True, device="cpu", dtype=tdt)
    (bucket,) = ref.buckets
    res = plan.launch((work,), plan.ExecutorCache())
    want = j_plan.execute_bucket(ref, bucket, backend="xla", mode="add",
                                 dtype=jdt, cache=j_plan.ExecutorCache())
    p = work.patterns[0]
    v = p.footprint()
    got = res.out[0, :v]
    w = torch.from_numpy(np.asarray(want[0]).astype(np.float64))[:v]
    _, idx, vals, _ = host.make_host_buffers(p, 1, seed=0)
    t_idx = torch.from_numpy(idx)[None]
    t_vals = host.as_dtype(vals, tdt)[None]
    bound = add_error_bound(t_idx, t_vals, v)[0]
    fin = torch.isfinite(bound)
    assert bool(torch.isfinite(got).all())
    assert bool(((got.double() - w).abs()[fin] <= bound[fin]).all())
    # the hot-row route the card takes, at a card-filling grid's blocks
    # (here capped by the lanes), within the same bound of the reference
    # and within its own of the float64 sum
    ctas = autotune.hot_ctas(_key(1, p.count * p.index_len, v,
                                  dtype=dname))
    hot = _hot_route(t_idx, t_vals, v, ctas)[0]
    assert bool(((hot.double() - w).abs()[fin] <= bound[fin]).all())
    own = hot_row_error_bound(t_idx, t_vals, v, ctas)[0]
    assert bool(((hot.double() - _exact(t_idx, t_vals, v)[0]).abs()
                 <= own).all())
