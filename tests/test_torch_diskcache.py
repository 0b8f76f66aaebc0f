"""The port's disk tier (repro_torch/diskcache) and its nvcc-built libraries.

Mirrors tests/test_diskcache.py on the CPU: a fresh ExecutorCache on a
populated directory serves the plan with ``misses == 0`` and equal
digests; corrupt or stale entries are quarantined and rebuilt, never
loaded, never fatal; a failed build is not persisted.  The library half
of the tier (``_build.library(name, tier=...)``) runs here with nvcc and
``ctypes`` replaced by fakes that write and read bytes, so its load /
build / store / quarantine paths and the exec entries' library hashes
are exercised without a card.  The launch census is checked under
threads.
"""
import glob
import hashlib
import json
import os
import sys
import threading
from pathlib import Path

import pytest

from repro_torch import plan
from repro_torch.diskcache import (QUAR_SUFFIX, SUFFIX, DiskTier,
                                   exec_key_str)
from repro_torch.kernels import _build
from repro_torch.pattern import make_pattern
from repro_torch.plan import ExecutorCache, SuitePlan, run_plan

PLAN = SuitePlan.build([
    make_pattern("UNIFORM:8:1", kind="gather", delta=8, count=16),
    make_pattern("UNIFORM:8:2", kind="scatter", delta=2, count=16),
])
N_BUCKETS = PLAN.n_buckets


def _digests(cache, backend="hopper"):
    return [r.out_digest
            for r in run_plan(PLAN, backend=backend, runs=1, cache=cache,
                              digest=True, device="cpu")]


def _tier(root, **kw):
    return DiskTier(str(root), device="cpu", **kw)


def _entries(root):
    return sorted(glob.glob(os.path.join(root, "*" + SUFFIX)))


def _quarantined(root):
    return sorted(glob.glob(os.path.join(root, "*" + QUAR_SUFFIX)))


def _rewrite_header(path, edit):
    raw = Path(path).read_bytes()
    magic, _, rest = raw.partition(b"\n")
    header, _, payload = rest.partition(b"\n")
    doc = edit(json.loads(header))
    Path(path).write_bytes(magic + b"\n" + json.dumps(doc).encode() + b"\n"
                           + payload)


def test_round_trip_zero_builds_bit_identical(tmp_path):
    root = str(tmp_path)
    cold = ExecutorCache(disk=_tier(root))
    ref = _digests(cold)
    assert cold.stats().misses == N_BUCKETS
    assert cold.disk.stats()["stores"] == N_BUCKETS
    assert len(_entries(root)) == N_BUCKETS
    warm = ExecutorCache()
    assert warm.attach_disk(_tier(root), preload=True) == N_BUCKETS
    assert _digests(warm) == ref
    s = warm.stats()
    assert s.misses == 0 and s.disk_hits == N_BUCKETS


def test_lazy_restore_without_preload(tmp_path):
    root = str(tmp_path)
    ref = _digests(ExecutorCache(disk=_tier(root)))
    warm = ExecutorCache()
    assert warm.attach_disk(_tier(root), preload=False) == 0
    assert len(warm) == 0
    assert _digests(warm) == ref
    assert warm.stats().misses == 0
    assert warm.stats().disk_hits == N_BUCKETS
    assert warm.disk.stats()["loads"] == N_BUCKETS


def test_corrupt_entry_quarantined_and_rebuilt(tmp_path):
    root = str(tmp_path)
    ref = _digests(ExecutorCache(disk=_tier(root)))
    victim = _entries(root)[0]
    raw = bytearray(Path(victim).read_bytes())
    raw[-10] ^= 0xFF                                 # bit rot in the payload
    Path(victim).write_bytes(raw)
    warm = ExecutorCache()
    tier = _tier(root)
    assert warm.attach_disk(tier, preload=True) == N_BUCKETS - 1
    assert tier.stats()["quarantined"] == 1
    assert len(_quarantined(root)) == 1              # set aside, not deleted
    assert _digests(warm) == ref
    assert warm.stats().misses == 1                  # only the quarantined
    assert len(_entries(root)) == N_BUCKETS          # stored again
    warm2 = ExecutorCache()
    assert warm2.attach_disk(_tier(root), preload=True) == N_BUCKETS
    assert _digests(warm2) == ref
    assert warm2.stats().misses == 0


@pytest.mark.parametrize("field,stale", [
    ("torch", "0.0.0-stale"), ("cuda", "0.0"), ("platform", "cuda"),
    ("nvcc", "release 0.0"), ("capability", "8.0"),
])
def test_stale_toolchain_entry_quarantined(tmp_path, field, stale):
    root = str(tmp_path)
    _digests(ExecutorCache(disk=_tier(root)))

    def edit(header):
        header["toolchain"][field] = stale
        return header

    _rewrite_header(_entries(root)[0], edit)
    tier = _tier(root)
    assert ExecutorCache().attach_disk(tier, preload=True) == N_BUCKETS - 1
    assert tier.stats()["quarantined"] == 1


def test_entry_of_another_key_is_quarantined(tmp_path):
    # a file whose header names another key is stale, never loaded
    root = str(tmp_path)
    ref = _digests(ExecutorCache(disk=_tier(root)))
    first, second = _entries(root)
    other = json.loads(Path(second).read_bytes().split(b"\n")[1])
    _rewrite_header(first, lambda h: {**h, "key_str": other["key_str"],
                                      "key": other["key"]})
    tier = _tier(root)
    warm = ExecutorCache()
    warm.attach_disk(tier, preload=False)
    assert _digests(warm) == ref
    assert tier.stats()["quarantined"] == 1
    assert warm.stats().misses == 1 and warm.stats().disk_hits == 1


def test_byte_budget_evicts_oldest(tmp_path):
    tier = _tier(tmp_path, budget_bytes=1)
    _digests(ExecutorCache(disk=tier))
    assert tier.stats()["stores"] == N_BUCKETS
    assert tier.stats()["evicted"] == N_BUCKETS
    assert _entries(str(tmp_path)) == []


def test_failed_build_is_not_persisted_and_nothing_degrades(tmp_path):
    # the reference persists only non-degraded builds; the port has no
    # fallback at all: a failed build raises, stores nothing, counts no
    # miss, and the next call builds the key itself
    tier = _tier(tmp_path)
    cache = ExecutorCache(disk=tier)
    key = plan.bucket_key("hopper", PLAN.buckets[0].spec, "float32", 1,
                          "", 1)

    def bad_builder():
        raise RuntimeError("injected: nvcc refused the source")

    with pytest.raises(RuntimeError, match="nvcc refused"):
        cache.serve_poly_info(key, bad_builder)
    s = cache.stats()
    assert s.misses == 0 and s.size == 0
    assert s.to_json()["degraded"] == 0
    assert tier.stats()["stores"] == 0 and _entries(str(tmp_path)) == []
    fn, served, built = cache.serve_poly_info(
        key, lambda: plan._bucket_fn("hopper", "gather", ""))
    assert built and served == key and cache.stats().misses == 1
    assert tier.stats()["stores"] == 1


def test_restored_entries_are_marked_and_not_stored_again(tmp_path):
    root = str(tmp_path)
    _digests(ExecutorCache(disk=_tier(root)))
    warm = ExecutorCache()
    warm.attach_disk(_tier(root), preload=True)
    entries = list(warm._entries.items())
    assert len(entries) == N_BUCKETS
    for _, fn in entries:
        assert getattr(fn, "restored", False)
    key, fn = entries[0]
    assert warm.disk.store(key, fn) is False
    assert warm.disk.stats()["store_failures"] == 0  # refusal, not failure


def test_key_str_covers_every_field():
    key = plan.bucket_key("hopper", PLAN.buckets[1].spec, "float32", 1,
                          "store", 1)
    s = exec_key_str(key)
    for field in ("backend", "kind", "idx_len", "footprint", "dtype",
                  "row_width", "mode", "batch"):
        assert f"{field}=" in s


def test_concurrent_builders_of_one_key_build_once(tmp_path):
    # racing threads on one key: one builds (a miss), the rest wait on its
    # future (hits), and exactly one entry is stored
    tier = _tier(tmp_path)
    cache = ExecutorCache(disk=tier)
    key = plan.bucket_key("torch", PLAN.buckets[0].spec, "float32", 1, "", 1)
    gate = threading.Event()
    built = []

    def builder():
        gate.wait(5)
        return plan._bucket_fn("torch", "gather", "")

    def fetch():
        built.append(cache.serve_poly_info(key, builder)[2])

    threads = [threading.Thread(target=fetch) for _ in range(8)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(built) == [False] * 7 + [True]
    s = cache.stats()
    assert (s.misses, s.hits) == (1, 7)
    assert tier.stats()["stores"] == 1


# ---------------------------------------------------------------------------
# the library half of the tier, with nvcc and ctypes replaced by fakes
# ---------------------------------------------------------------------------

class FakeToolchain:
    """nvcc writes ``<name>#<build number>`` (nvcc's own output differs
    from build to build too); loading records the bytes it read."""

    def __init__(self, monkeypatch):
        self.builds = []
        self.loaded = {}
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "_loaded", {})
        monkeypatch.setattr(_build, "_fns", {})
        monkeypatch.setattr(_build, "_toolchain",
                            {"nvcc": "Build cuda_12.8.r12.8", "capability": "9.0"})
        monkeypatch.setattr(_build, "nvcc_runs", 0)
        monkeypatch.setattr(_build, "_compile", self.compile)
        monkeypatch.setattr(_build.ctypes, "CDLL", self.cdll)
        monkeypatch.setattr(_build, "_SIGNATURES",
                            {n: {} for n in _build.SOURCES})
        # the hopper backend's libraries, as on a card
        monkeypatch.setattr(
            plan, "bucket_libraries",
            lambda backend, kind, platform: (
                ("gather_rows",) if kind == "gather" else ("scatter_rows",))
            if backend == "hopper" else ())
        import repro_torch.diskcache as dc
        monkeypatch.setattr(dc, "bucket_libraries", plan.bucket_libraries)

    def compile(self, jobs):
        for name, out in jobs.items():
            self.builds.append(name)
            _build.nvcc_runs += 1
            Path(out).write_bytes(f"{name}#{len(self.builds)}".encode())
        return {name: "" for name in jobs}

    def cdll(self, path):
        self.loaded[Path(path).name] = Path(path).read_bytes()
        return object()


def _lib_entries(root):
    out = []
    for path in _entries(root):
        header = json.loads(Path(path).read_bytes().split(b"\n")[1])
        if header["entry"] == "library":
            out.append((header["name"], path))
    return sorted(out)


def test_library_built_once_then_loaded_from_the_tier(tmp_path, monkeypatch):
    fake = FakeToolchain(monkeypatch)
    tier = _tier(tmp_path)
    _build.library("gather_rows", tier=tier)
    assert fake.builds == ["gather_rows"] and _build.nvcc_runs == 1
    sha = hashlib.sha256(b"gather_rows#1").hexdigest()
    assert _build.library_sha256("gather_rows") == sha
    assert tier.stats()["library_stores"] == 1
    # a new process: nothing loaded, the tier has the library
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_loaded", {})
    tier2 = _tier(tmp_path)
    _build.library("gather_rows", tier=tier2)
    assert fake.builds == ["gather_rows"]             # no nvcc run
    assert _build.library_sha256("gather_rows") == sha
    assert tier2.stats()["library_loads"] == 1
    assert list(fake.loaded.values())[-1] == b"gather_rows#1"


def test_corrupt_library_entry_quarantined_and_rebuilt(tmp_path,
                                                       monkeypatch):
    fake = FakeToolchain(monkeypatch)
    _build.library("scatter_rows", tier=_tier(tmp_path))
    (name, path), = _lib_entries(str(tmp_path))
    raw = bytearray(Path(path).read_bytes())
    raw[-3] ^= 0xFF
    Path(path).write_bytes(raw)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_loaded", {})
    tier = _tier(tmp_path)
    _build.library("scatter_rows", tier=tier)        # never fatal
    assert fake.builds == ["scatter_rows", "scatter_rows"]
    s = tier.stats()
    assert s["quarantined"] == s["library_quarantined"] == 1
    assert s["library_stores"] == 1
    assert list(fake.loaded.values())[-1] == b"scatter_rows#2"
    assert len(_quarantined(str(tmp_path))) == 1


def test_library_identity_covers_nvcc_and_capability(monkeypatch):
    FakeToolchain(monkeypatch)
    base = _build.lib_identity("gather_rows")
    monkeypatch.setitem(_build._toolchain, "nvcc", "Build cuda_12.9")
    other_nvcc = _build.lib_identity("gather_rows")
    monkeypatch.setitem(_build._toolchain, "capability", "10.0")
    other_cc = _build.lib_identity("gather_rows")
    assert len({base, other_nvcc, other_cc}) == 3
    assert _build._lib_path("gather_rows").name == \
        f"gather_rows-{other_cc[:16]}.so"


def test_library_loaded_without_the_tier_is_stored_into_it(tmp_path,
                                                           monkeypatch):
    fake = FakeToolchain(monkeypatch)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.library("gather_rows")                    # builds all of _build/
    n_builds = len(fake.builds)
    tier = _tier(tmp_path / "tier")
    _build.library("gather_rows", tier=tier)
    assert tier.stats()["library_stores"] == 1
    assert len(fake.builds) == n_builds              # stored, not rebuilt


def test_restart_restores_buckets_and_libraries_with_no_nvcc_run(
        tmp_path, monkeypatch):
    fake = FakeToolchain(monkeypatch)
    root = str(tmp_path)
    cold = ExecutorCache(disk=_tier(root))
    ref = _digests(cold)
    assert cold.stats().misses == N_BUCKETS
    assert sorted(fake.builds) == ["gather_rows", "scatter_rows"]
    assert len(_entries(root)) == N_BUCKETS + 2
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_loaded", {})
    warm = ExecutorCache()
    tier = _tier(root)
    assert warm.attach_disk(tier, preload=True) == N_BUCKETS
    assert _digests(warm) == ref
    assert warm.stats().misses == 0 and warm.stats().disk_hits == N_BUCKETS
    assert len(fake.builds) == 2                     # no nvcc run
    assert tier.stats()["library_loads"] == 2


def test_exec_entry_of_a_rebuilt_library_is_stale(tmp_path, monkeypatch):
    # the exec entries record their library's sha256: after a corrupt
    # library is rebuilt with other bytes, those entries are quarantined
    # and rebuilt (misses), while the other kind's entries restore
    fake = FakeToolchain(monkeypatch)
    root = str(tmp_path)
    ref = _digests(ExecutorCache(disk=_tier(root)))
    libs = dict(_lib_entries(root))
    raw = bytearray(Path(libs["gather_rows"]).read_bytes())
    raw[-1] ^= 0xFF
    Path(libs["gather_rows"]).write_bytes(raw)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_loaded", {})
    warm = ExecutorCache()
    tier = _tier(root)
    assert warm.attach_disk(tier, preload=True) == N_BUCKETS - 1
    assert _digests(warm) == ref
    s = tier.stats()
    assert s["library_quarantined"] == 1
    assert s["quarantined"] == 2                     # the library + 1 exec
    assert warm.stats().misses == 1
    assert fake.builds.count("gather_rows") == 2


# ---------------------------------------------------------------------------
# the launch census under threads
# ---------------------------------------------------------------------------

def test_launch_census_is_exact_under_threads(monkeypatch):
    import torch
    monkeypatch.setattr(_build, "c_function", lambda lib, fn: lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "current_stream", lambda index: 0)
    monkeypatch.setitem(_build.launches, "gather_rows", 0)
    dev = torch.device("cuda", 0)
    n_threads, per_thread = 16, 2000

    def hammer():
        for _ in range(per_thread):
            _build.launch("gather_rows", dev, "gather_rows",
                          "gather_rows_f32")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _build.launches["gather_rows"] == n_threads * per_thread
