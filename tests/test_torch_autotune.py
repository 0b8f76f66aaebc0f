"""repro_torch.kernels.autotune: the closed-form launch-parameter choice.

Mirrors tests/test_autotune.py on the CPU, case for case where a case has
a counterpart:

  * Determinism: a choice is a pure function of its TileKey (the same
    after a memo reset and in a fresh process); choices lie within their
    candidates.
  * Legacy: ``LEGACY`` is the rules the kernels launched by before the
    search (``use_smem``, ``smem_lanes_per_cta``, ``paged_splits`` and the
    C deep test, written out here), and ``disabled()`` serves it without
    touching the memo.
  * Persistence: a ``DiskTier`` entry's header carries the choices its
    bucket callable closed over; a restore seeds them, so a warm restart
    searches nothing and ``disk_hits`` stays exact.

Two more cases hold the port against the JAX package: demo's and appdb's
digests under the search and under ``disabled()`` equal the reference's
``run_plan(digest=True)``, adds within ``add_error_bound``; and the
choices for an H100's facts (132 SMs, 2,048 threads an SM, 120 resident
smem CTAs) are pinned at demo's gather bucket, the CLI's shape and
appdb's largest bucket.  On the CPU the kernels' plain versions run,
which ignore every choice: the kernels are held to every candidate on
the card (chip_smoke.py phase 10).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import pattern as j_pattern
from repro.core import plan as j_plan
from repro_torch import appdb, pattern, plan
from repro_torch.diskcache import DiskTier
from repro_torch.host import make_host_buffers
from repro_torch.kernels import autotune
from repro_torch.kernels.gather_rows import ops as gather_ops
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.kernels.scatter_rows.ref import add_error_bound

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
H100 = "cuda:sm90:132sm:2048t"
H100_SMEM = H100 + ":120cta"


@pytest.fixture(autouse=True)
def _clean_memo():
    autotune.reset()
    yield
    autotune.reset()


def _key(op, batch, lanes, rows, width, platform=H100, dtype="float32"):
    if op in ("gather", "gather_smem") and platform == H100:
        platform = H100_SMEM
    return autotune.TileKey(op=op, batch=batch, lanes=lanes, rows=rows,
                            width=width, dtype=dtype, platform=platform)


def _keys():
    """A grid of geometries, every op and both platforms."""
    out = []
    for op in ("gather", "gather_global", "gather_smem", "scatter_store",
               "scatter_add"):
        for batch, lanes, rows, width in ((1, 64, 33, 1), (4, 1000, 400, 8),
                                          (2, 1 << 20, 9000, 1),
                                          (1, 1 << 27, (1 << 27) + 1, 1)):
            for platform in (H100, "cpu"):
                out.append(_key(op, batch, lanes, rows, width, platform))
    for bh, pps, page, width in ((32, 130, 16, 512), (4, 9, 8, 64),
                                 (512, 64, 16, 128)):
        out.append(_key("paged_decode", bh, pps, page, width,
                        dtype="bfloat16"))
    return out


KEYS = _keys()


# ---------------------------------------------------------------------------
# determinism


@pytest.mark.parametrize("key", KEYS, ids=autotune.key_to_wire)
def test_choice_survives_memo_reset(key):
    first = autotune.choose(key)
    autotune.reset()
    assert autotune.choose(key) == first


def test_memo_hit_does_not_search_again():
    key = KEYS[0]
    autotune.choose(key)
    autotune.choose(key)
    assert autotune.stats() == {"searched": 1, "hits": 1, "seeded": 0}


@pytest.mark.parametrize("key", KEYS, ids=autotune.key_to_wire)
def test_choices_lie_within_their_bracket(key):
    c = autotune.choose(key)
    if key.op in ("gather_global", "scatter_store"):
        assert c == autotune.TileChoice(vecs=c.vecs)
        assert c.vecs in (1, autotune.deep_vecs(key.width))
    elif key.op == "gather_smem":
        assert c.smem == 1 and c.vecs == c.splits == 0
        assert 1 <= c.lanes_per_cta <= -(-key.lanes // gather_ops.SMEM_CLUSTER)
        assert c.lanes_per_cta in autotune.smem_candidates(key)
    elif key.op == "gather":
        assert c == autotune.TileChoice(smem=c.smem)
        assert c.smem in (0, 1)
        assert not c.smem or autotune.smem_feasible(key)
    elif key.op == "paged_decode":
        assert c == autotune.TileChoice(splits=c.splits)
        assert 1 <= c.splits <= min(key.lanes, paged_ops.MAX_SPLITS)
    else:
        assert key.op == "scatter_add"
        assert c == autotune.TileChoice(smem=c.smem)
        assert c.smem in (0, 1)
        assert not c.smem or (key.rows * key.width * 4
                              <= autotune.HOT_SMEM_BYTES)


_CHILD = """
import json, sys
sys.path.insert(0, %(src)r)
from repro_torch.kernels import autotune
keys = [autotune.TileKey(**k) for k in json.loads(sys.argv[1])]
print(json.dumps(autotune.to_wire({k: autotune.choose(k) for k in keys})))
"""


def test_same_choices_in_a_second_process():
    payload = json.dumps([dataclasses.asdict(k) for k in KEYS])
    outs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", _CHILD % {"src": SRC},
                            payload], capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(json.loads(r.stdout))
    assert outs[0] == outs[1]
    assert outs[0] == autotune.to_wire({k: autotune.choose(k) for k in KEYS})


# ---------------------------------------------------------------------------
# legacy


def _c_deep_test(bsz, n, d, threads):
    """csrc/common.cuh deep_for with vecs 0, for operands in phase at a
    16-byte boundary: D = 1 takes vectors of 4 lanes (kVecs = 4 a
    thread), else float4 elements where D % 4 == 0, else floats (kElems
    = 8 a thread); deep once its threads would still fill the card."""
    if d == 1:
        return 4 if (bsz * n) // 4 >= threads * 4 else 1
    elems = bsz * n * (d // 4 if d % 4 == 0 else d)
    return 8 if elems >= threads * 8 else 1


GRID = [(b, n, v, d) for b in (1, 3, 16) for n in (1, 100, 4097, 1 << 18,
                                                   3 << 20)
        for v in (17, 32769, 58112, 1 << 20) for d in (1, 4, 17)]


@pytest.mark.parametrize("platform,sms,threads_per_sm,resident", [
    (H100, 132, 2048, 120), ("cuda:sm90:114sm:2048t", 114, 2048, 112),
    ("cpu", 132, 2048, 120)])
def test_legacy_equals_the_rules_before_the_search(platform, sms,
                                                   threads_per_sm, resident):
    smem_platform = (f"{platform}:{resident}cta" if platform != "cpu"
                     else "cpu")
    for b, n, v, d in GRID:
        k = dict(batch=b, lanes=n, rows=v, width=d, dtype="float32")
        gather = autotune.LEGACY["gather"](autotune.TileKey(
            op="gather", platform=smem_platform, **k))
        assert gather.smem == int(gather_ops.use_smem(v, n, d, 4))
        smem = autotune.LEGACY["gather_smem"](autotune.TileKey(
            op="gather_smem", platform=smem_platform, **k))
        assert smem.lanes_per_cta == gather_ops.smem_lanes_per_cta(
            b, n, v, resident)
        for op in ("gather_global", "scatter_store"):
            got = autotune.LEGACY[op](autotune.TileKey(
                op=op, platform=platform, **k))
            assert got.vecs == _c_deep_test(b, n, d, sms * threads_per_sm)
    for bsz in (1, 2, 4, 16, 64):
        for kvh in (1, 8):
            for pps in (1, 9, 130, 513):
                key = autotune.TileKey(op="paged_decode", batch=bsz * kvh,
                                       lanes=pps, rows=16, width=512,
                                       dtype="bfloat16", platform=platform)
                assert autotune.LEGACY["paged_decode"](key).splits == \
                    paged_ops.paged_splits(bsz, kvh, pps, sms)


def test_legacy_smem_needs_a_cluster_that_fits():
    key = _key("gather", 1, 32768, 32769, 1,
               platform=H100 + ":0cta")
    assert gather_ops.use_smem(32769, 32768, 1, 4)
    assert autotune.LEGACY["gather"](key).smem == 0
    assert autotune.choose(key).smem == 0


def test_disabled_serves_legacy_without_the_memo():
    with autotune.disabled():
        for key in KEYS:
            assert autotune.choose(key) == autotune.LEGACY[key.op](key)
    assert autotune.stats() == {"searched": 0, "hits": 0, "seeded": 0}
    assert all(autotune.lookup(k) is None for k in KEYS)


# ---------------------------------------------------------------------------
# wire format


def test_wire_round_trip_and_seed_priority():
    entries = {k: autotune.choose(k) for k in KEYS}
    wire = autotune.to_wire(entries)
    json.dumps(wire)                       # JSON-clean as it is
    autotune.reset()
    assert autotune.seed_wire(wire) == len(entries)
    for k, v in entries.items():
        assert autotune.lookup(k) == v
    # memo entries win over a later (conflicting) seed
    fake = {ks: [1, 7, 1, 3] for ks in wire}
    assert autotune.seed_wire(fake) == 0
    assert all(autotune.lookup(k) == v for k, v in entries.items())
    assert autotune.stats()["seeded"] == len(entries)


GOOD = "gather_global:1:64:33:1:float32:" + H100


@pytest.mark.parametrize("wire", [
    {"not:a:key": [0, 0, 1, 0]},
    {"gather_global:1:64:33:1:float32": [0, 0, 1, 0]},       # no platform
    {"nope:1:64:33:1:float32:" + H100: [0, 0, 1, 0]},        # unknown op
    {"gather_global:x:64:33:1:float32:" + H100: [0, 0, 1, 0]},
    {"gather_global:1:64:33:1:float32:tpu": [0, 0, 1, 0]},   # platform
    {GOOD: ["x", 0, 1, 0]},
    {GOOD: [0, 0, 1]},                                       # 3 fields
    {GOOD: None},
    {GOOD: 5},
], ids=lambda w: repr(w)[:48])
def test_seed_wire_skips_malformed_entries(wire):
    assert autotune.seed_wire(wire) == 0
    assert autotune.seed_wire({**wire, GOOD: [0, 0, 1, 0]}) == 1
    assert autotune.lookup(autotune.key_from_wire(GOOD)) == \
        autotune.TileChoice(vecs=1)


def test_seed_wire_takes_nothing_from_nothing():
    assert autotune.seed_wire(None) == 0
    assert autotune.seed_wire({}) == 0
    assert autotune.seed_wire(["not", "a", "dict"]) == 0


# ---------------------------------------------------------------------------
# persistence through DiskTier (CPU)


PLAN = plan.SuitePlan.build([
    pattern.make_pattern("UNIFORM:8:1", kind="gather", delta=8, count=16),
    pattern.make_pattern("UNIFORM:8:2", kind="scatter", delta=2, count=16),
])


def _digests(cache, p=PLAN, **kw):
    return [r.out_digest for r in plan.run_plan(
        p, backend="hopper", runs=1, cache=cache, digest=True, device="cpu",
        **kw)]


def test_disk_restore_skips_search_and_disk_hits_exact(tmp_path):
    cold = plan.ExecutorCache(disk=DiskTier(str(tmp_path), device="cpu"))
    ref = _digests(cold)
    assert cold.disk.stats()["stores"] == PLAN.n_buckets
    assert autotune.stats()["searched"] > 0          # the cold run searched
    autotune.reset()                                 # a restart: no memo
    warm = plan.ExecutorCache()
    assert warm.attach_disk(DiskTier(str(tmp_path), device="cpu"),
                            preload=True) == PLAN.n_buckets
    assert autotune.stats()["seeded"] > 0            # headers seeded it
    assert _digests(warm) == ref
    assert autotune.stats()["searched"] == 0         # nothing searched
    assert warm.stats().misses == 0
    assert warm.stats().disk_hits == PLAN.n_buckets


def test_disk_header_carries_the_tiles(tmp_path):
    with autotune.recording() as rec:
        cache = plan.ExecutorCache(disk=DiskTier(str(tmp_path),
                                                 device="cpu"))
        _digests(cache)
    # one gather bucket (its regime key and its kernel's), one store
    assert sorted(k.op for k in rec) == ["gather", "gather_global",
                                         "scatter_store"]
    wire = autotune.to_wire(rec)
    headers = {}
    for f in tmp_path.glob("*.spx"):
        header = json.loads(f.read_bytes().split(b"\n")[1])
        headers[header["key"]["kind"]] = header["tiles"]
    assert {**headers["gather"], **headers["scatter"]} == wire
    autotune.reset()
    warm = plan.ExecutorCache()
    warm.attach_disk(DiskTier(str(tmp_path), device="cpu"), preload=True)
    for ks, v in wire.items():
        assert autotune.lookup(autotune.key_from_wire(ks)) == \
            autotune.TileChoice.from_wire(v)


def test_build_records_each_shards_geometry(tmp_path):
    # a placed key chooses for one shard's local geometry: a (2, 2) grid
    # of a batch of 4 and 64 lanes is 2 patterns of 32 lanes a shard
    key = plan.ExecKey(backend="hopper", kind="scatter", idx_len=64,
                       footprint=128, dtype="float32", row_width=1,
                       mode="store", batch=4,
                       placement="data=2xlane=2/4dev")
    with autotune.recording() as rec:
        plan.build_bucket(key, torch.device("cpu"))
    assert list(rec) == [autotune.TileKey(
        op="scatter_store", batch=2, lanes=32, rows=129, width=1,
        dtype="float32", platform="cpu")]
    assert plan.bucket_tiles(dataclasses.replace(key, backend="torch"),
                             torch.device("cpu")) is None


def test_batch_hit_serves_the_served_keys_choices():
    # a bucket that shrank to 1 member reuses the warm batch-2 entry: its
    # launch sees the served key's geometry, whose choice is a memo hit
    pats = [pattern.make_pattern("UNIFORM:8:1", kind="gather", delta=8,
                                 count=16, name=f"g{i}") for i in range(2)]
    cache = plan.ExecutorCache()
    plan.run_plan(plan.SuitePlan.build(pats), backend="hopper", runs=1,
                  cache=cache, device="cpu")
    searched = autotune.stats()["searched"]
    with autotune.recording() as rec:
        plan.run_plan(plan.SuitePlan.build(pats[:1]), backend="hopper",
                      runs=1, cache=cache, device="cpu")
    assert cache.stats().batch_hits == 1
    assert autotune.stats()["searched"] == searched and not rec


# ---------------------------------------------------------------------------
# against the JAX package


def _capped(pats, max_lanes=256, max_footprint=1 << 12):
    """Counts cut so every pattern stays small; shapes are untouched."""
    out = []
    for p in pats:
        count = max(1, min(p.count, max_lanes // p.index_len))
        if p.delta > 0:
            count = max(1, min(count, (max_footprint - p.span) // p.delta))
        out.append(dataclasses.replace(p, count=count))
    return out


def _suite(name):
    if name == "appdb":
        return _capped(appdb.ALL_PATTERNS)
    return pattern.load_suite(str(ROOT / "suites" / "demo.json"))


def _j(p):
    return j_pattern.Pattern(name=p.name, kind=p.kind, index=p.index,
                             delta=p.delta, count=p.count, source=p.source)


@pytest.mark.parametrize("leg", ["search", "disabled"])
@pytest.mark.parametrize("name", ["demo", "appdb"])
def test_digests_equal_the_reference_under_both_legs(name, leg):
    pats = _suite(name)
    ref = j_plan.run_plan(j_plan.SuitePlan.build([_j(p) for p in pats]),
                          backend="xla", runs=1, digest=True,
                          cache=j_plan.ExecutorCache())
    sp = plan.SuitePlan.build(pats)
    with (autotune.disabled() if leg == "disabled" else _nothing()):
        got = _digests(plan.ExecutorCache(), sp)
        # adds: every scatter bucket within add_error_bound of a numpy sum
        works = plan.make_work(sp, backend="hopper", runs=1, mode="add",
                               digest=True, device="cpu")
        for work in works:
            if work.spec.kind != "scatter":
                continue
            res = plan.launch((work,), plan.ExecutorCache())
            for i, p in enumerate(work.patterns):
                _, idx, vals, _ = make_host_buffers(p, 1, seed=0)
                want = np.zeros((p.footprint(), 1))
                np.add.at(want, idx, vals.astype(np.float64))
                bound = add_error_bound(torch.from_numpy(idx)[None],
                                        torch.from_numpy(vals)[None],
                                        p.footprint())[0].numpy()
                out = res.out[i, :p.footprint()].numpy().astype(np.float64)
                assert np.all(np.abs(out - want) <= bound + 2 ** -24
                              * np.abs(want))
    assert got == [r.out_digest for r in ref]
    assert autotune.stats()["searched"] == (0 if leg == "disabled"
                                            else len(set(_searched(sp))))


def _nothing():
    import contextlib
    return contextlib.nullcontext()


def _searched(sp):
    """The TileKeys a run of ``sp`` on hopper (store, then add) chooses."""
    keys = []
    for mode in ("store", "add"):
        for key, builder, _ in plan.enumerate_executables(
                sp, backend="hopper", mode=mode, device="cpu"):
            if mode == "add" and key.kind == "gather":
                continue
            with autotune.recording() as rec:
                plan.bucket_tiles(key, torch.device("cpu"))
            keys += list(rec)
    return keys


# the H100's facts: demo's UNIFORM:8:1 bucket (32,768 lanes of a 128 KiB
# table) leaves the smem kernel (4.1 us against the global kernel's 1.4 on
# the card, PERF.md); the CLI pattern's 2^27 lanes and appdb's largest
# bucket (2^25 lanes) take one vector a thread where the legacy rule took
# the deep instance (the sweep: 518.2 against 523.6 us at the CLI shape)
PINNED = [
    (_key("gather", 1, 32768, 32769, 1), autotune.TileChoice(smem=0),
     autotune.TileChoice(smem=1)),
    (_key("gather_global", 1, 32768, 32769, 1), autotune.TileChoice(vecs=1),
     autotune.TileChoice(vecs=1)),
    (_key("gather_smem", 1, 32768, 32769, 1),
     autotune.TileChoice(smem=1, lanes_per_cta=512),
     autotune.TileChoice(smem=1, lanes_per_cta=4096)),
    (_key("gather_global", 1, 1 << 27, (1 << 27) + 1, 1),
     autotune.TileChoice(vecs=1), autotune.TileChoice(vecs=4)),
    (_key("scatter_store", 1, 1 << 27, (1 << 27) + 1, 1),
     autotune.TileChoice(vecs=1), autotune.TileChoice(vecs=4)),
    (_key("scatter_add", 1, 1 << 27, (1 << 27) + 1, 1),
     autotune.TileChoice(), autotune.TileChoice()),
    (_key("gather_global", 1, 1 << 25, 1 << 25, 1),
     autotune.TileChoice(vecs=1), autotune.TileChoice(vecs=4)),
    (_key("scatter_store", 1, 1 << 25, 1 << 25, 1),
     autotune.TileChoice(vecs=1), autotune.TileChoice(vecs=4)),
    (_key("paged_decode", 32, 130, 16, 512, dtype="bfloat16"),
     autotune.TileChoice(splits=12), autotune.TileChoice(splits=12)),
]


@pytest.mark.parametrize("key,want,legacy", PINNED,
                         ids=[autotune.key_to_wire(k) for k, _, _ in PINNED])
def test_pinned_choices_on_an_h100(key, want, legacy):
    assert autotune.choose(key) == want
    assert autotune.LEGACY[key.op](key) == legacy


def test_appdb_largest_bucket_is_two_to_the_25_lanes():
    sp = plan.SuitePlan.build(appdb.scale_counts(appdb.ALL_PATTERNS, 1.0))
    assert max(b.spec.idx_len for b in sp.buckets) == 1 << 25


def test_cuda_platform_names_the_card(monkeypatch):
    class Props:
        major, minor, multi_processor_count = 9, 0, 132
        max_threads_per_multi_processor = 2048
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: Props)
    monkeypatch.setattr(autotune, "_CARDS", {})
    assert autotune.cuda_platform(0) == H100
    assert autotune.cuda_platform(0, 120) == H100_SMEM
    assert autotune.facts(H100_SMEM) == autotune.CardFacts(132, 2048, 120)
    with pytest.raises(ValueError):
        autotune.facts("tpu:v5e")


def test_choose_rejects_an_unknown_op():
    with pytest.raises(ValueError, match="unknown autotune op"):
        autotune.choose(_key("gather_dma", 1, 64, 33, 1))


def test_imports_nothing_of_jax_or_repro():
    code = ("import sys; sys.path.insert(0, %r); "
            "import repro_torch.kernels.autotune, repro_torch.diskcache; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); assert not bad" % SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stdout + r.stderr
