"""repro_torch kernels: the plain versions (what the wrappers run on CPU
tensors) against the JAX package's Pallas kernels in interpret mode.

Gathers and stores must be bit-equal.  Adds must agree within
``add_error_bound``: a row that receives K float32 values sums them with
error at most gamma_K * sum|v| in any order (gamma_K = K u / (1 - K u),
u = 2^-24), so two summation orders differ by at most twice that.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_rows import ops as j_gather
from repro.kernels.scatter_rows import ops as j_scatter
from repro_torch.kernels import _build, launches
from repro_torch.kernels.gather_rows import ops as gather_ops
from repro_torch.kernels.gather_rows.ref import gather_rows_ref
from repro_torch.kernels.scatter_rows import ops as scatter_ops
from repro_torch.kernels.scatter_rows import ref as scatter_ref
from repro_torch.kernels.scatter_rows.ref import (add_error_bound, in_range,
                                                  scatter_add_rows_ref_,
                                                  scatter_store_rows_ref_)

INT32_MAX = np.iinfo(np.int32).max
ROOT = Path(__file__).resolve().parent.parent
# (B, V, D, N): ragged D, N smaller than any block, N not a block multiple
SHAPES = [(1, 40, 1, 5), (3, 40, 3, 100), (2, 300, 17, 130), (3, 64, 8, 513)]


def _inputs(b, v, d, n, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((b, v, d), dtype=np.float32)
    idx = rng.integers(0, v, (b, n), dtype=np.int32)
    vals = rng.standard_normal((b, n, d), dtype=np.float32)
    return table, idx, vals


@pytest.mark.parametrize("b,v,d,n", SHAPES)
@pytest.mark.parametrize("mode", ["vmem", "dma"])
def test_gather_plain_equals_pallas(b, v, d, n, mode):
    table, idx, _ = _inputs(b, v, d, n)
    want = np.asarray(j_gather.gather_rows_batched(
        jnp.asarray(table), jnp.asarray(idx), mode=mode, interpret=True))
    t_table, t_idx = torch.from_numpy(table), torch.from_numpy(idx)
    got = gather_rows_ref(t_table, t_idx).numpy()
    assert got.tobytes() == want.tobytes()
    for wrapper in (gather_ops.gather_rows, gather_ops.gather_rows_global,
                    gather_ops.gather_rows_smem):
        assert wrapper(t_table, t_idx).numpy().tobytes() == want.tobytes()


def test_gather_out_of_range_lanes_read_zero():
    table, idx, _ = _inputs(2, 10, 3, 20)
    idx[0, :3] = [-1, 10, INT32_MAX]
    out = gather_rows_ref(torch.from_numpy(table), torch.from_numpy(idx))
    assert torch.equal(out[0, :3], torch.zeros(3, 3))
    assert torch.equal(out[0, 3:], torch.from_numpy(table[0, idx[0, 3:]]))


def _store_case(b, v, d, n, seed=0):
    """Store inputs with duplicates, a keep mask per pattern, and padding
    lanes routed to the last row as the planner does (only the last
    padding lane keeps), plus the reference's INT32_MAX drop encoding."""
    from repro_torch.host import keep_last_mask
    table, idx, vals = _inputs(b, v, d, n, seed)
    idx[:, n - n // 4:] = v - 1                   # padding -> scratch row
    keep = np.stack([keep_last_mask(row) for row in idx])
    return table, idx, vals, keep


@pytest.mark.parametrize("b,v,d,n", SHAPES)
def test_store_plain_equals_pallas(b, v, d, n):
    dst, idx, vals, keep = _store_case(b, v, d, n)
    safe = np.where(keep, idx, INT32_MAX).astype(np.int32)
    want = np.asarray(j_scatter.scatter_store_rows_batched(
        jnp.asarray(dst), jnp.asarray(safe), jnp.asarray(vals),
        interpret=True))
    for fn in (scatter_store_rows_ref_, scatter_ops.scatter_store_rows_):
        got = fn(torch.from_numpy(dst.copy()), torch.from_numpy(idx),
                 torch.from_numpy(keep), torch.from_numpy(vals))
        assert got.numpy().tobytes() == want.tobytes()
    # the reference's drop encoding, fed as is, drops the same lanes
    got = scatter_store_rows_ref_(
        torch.from_numpy(dst.copy()), torch.from_numpy(safe),
        torch.ones(safe.shape, dtype=torch.bool), torch.from_numpy(vals))
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("b,v,d,n", SHAPES + [(2, 16, 1, 700)])
def test_add_plain_within_bound_of_pallas(b, v, d, n):
    _, idx, vals = _inputs(b, v, d, n)
    idx[0, :2] = INT32_MAX                        # dropped lanes
    want = np.asarray(j_scatter.scatter_add_rows_batched(
        jnp.asarray(idx), jnp.asarray(vals), v, interpret=True))
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    bound = add_error_bound(t_idx, t_vals, v).numpy()
    assert bound.max() > 0
    for fn in (scatter_add_rows_ref_, scatter_ops.scatter_add_rows_):
        got = fn(torch.zeros(b, v, d), t_idx, t_vals).numpy()
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


def test_add_error_bound_covers_reordering():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 4, (1, 4096), dtype=np.int32)
    vals = rng.standard_normal((1, 4096, 2), dtype=np.float32) * 1e3
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    fwd = scatter_add_rows_ref_(torch.zeros(1, 4, 2), t_idx, t_vals)
    rev = scatter_add_rows_ref_(torch.zeros(1, 4, 2), t_idx.flip(1),
                                t_vals.flip(1))
    diff = (fwd - rev).abs().double()
    assert diff.max() > 0                          # the orders do differ
    assert bool((diff <= add_error_bound(t_idx, t_vals, 4)).all())


def test_wrappers_check_their_operands():
    table, idx, vals = (torch.from_numpy(a) for a in _inputs(2, 8, 4, 6))
    keep = torch.ones(idx.shape, dtype=torch.bool)
    with pytest.raises(TypeError, match="float32"):
        gather_ops.gather_rows(table.double(), idx)
    with pytest.raises(TypeError, match="int32"):
        gather_ops.gather_rows(table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather_ops.gather_rows(table.transpose(1, 2), idx)
    with pytest.raises(ValueError, match="batch"):
        gather_ops.gather_rows(table[:1], idx)
    with pytest.raises(ValueError, match="devices|device"):
        gather_ops.gather_rows(table, idx.to("meta"))
    with pytest.raises(ValueError, match="shapes"):
        scatter_ops.scatter_store_rows_(table, idx, keep,
                                        vals[:, :3].contiguous())
    with pytest.raises(TypeError, match="bool"):
        scatter_ops.scatter_store_rows_(table, idx, keep.int(), vals)
    with pytest.raises(ValueError, match="exceeds"):
        gather_ops.gather_rows_smem(
            torch.zeros(1, gather_ops.SMEM_TABLE_BYTES // 4 + 1, 1), idx[:1])


def test_cpu_tensors_launch_nothing():
    before = dict(launches)
    table, idx, vals = (torch.from_numpy(a) for a in _inputs(2, 8, 4, 6))
    gather_ops.gather_rows(table, idx)
    scatter_ops.scatter_add_rows_(table.clone(), idx, vals)
    assert launches == before
    assert not _build._libs


def test_smem_switch_point():
    limit = gather_ops.SMEM_TABLE_BYTES
    assert limit == 227 * 1024
    # demo.json's UNIFORM:8:1 gather bucket: 32,769 rows of 4 bytes
    assert gather_ops.use_smem(32769, 32768, 1, 4)
    assert not gather_ops.use_smem(65537, 32768, 1, 4)       # 256 KiB
    assert not gather_ops.use_smem(limit // 4, 100, 1, 4)   # too few lanes
    assert gather_ops.use_smem(limit // 68, limit // 68, 17, 4)
    assert not gather_ops.use_smem(limit // 68 + 1, 10 ** 6, 17, 4)
    # runs: the batch over the resident CTAs (120 on an H100 SXM), at least
    # V / 8 (and 256) lanes, at most N / 8; demo's bucket takes one cluster
    # of 4,096 lanes
    assert gather_ops.smem_lanes_per_cta(1, 32768, 32769, 120) == 4096
    assert gather_ops.smem_lanes_per_cta(1, 1 << 24, 32769, 120) == 139811
    assert gather_ops.smem_lanes_per_cta(64, 1 << 20, 5000, 120) == 131072
    assert gather_ops.smem_lanes_per_cta(4, 1 << 16, 32769, 120) == 4097
    assert gather_ops.smem_lanes_per_cta(1, 1000, 37, 120) == 125
    assert gather_ops.smem_lanes_per_cta(1, 1, 1, 120) == 1


@pytest.mark.parametrize("bsz,n,v,resident,ctas", [
    (1, 32768, 32769, 120, 8),          # demo: one cluster
    (1, 1 << 24, 32769, 120, 120),      # 15 clusters: one wave
    (1, 1 << 24, 32769, 112, 112),      # a card that holds 14 clusters
    (1, 1 << 24, 32769, 240, 240),      # ... or 30 (a smaller table)
    (40, 8192, 5000, 120, 320),         # a cluster per pattern, 40 > 15
    (3, 1, 1, 120, 24),                 # one lane: a cluster of 7 idle CTAs
    (2, 1000, 37, 120, 16),
])
def test_smem_grid_is_whole_clusters(bsz, n, v, resident, ctas):
    grid = gather_ops.smem_grid(bsz, n, v, resident)
    lanes = gather_ops.smem_lanes_per_cta(bsz, n, v, resident)
    assert grid == ctas
    assert grid % (bsz * gather_ops.SMEM_CLUSTER) == 0
    per_pattern = grid // bsz
    # every lane has a CTA, and no whole cluster is idle
    assert per_pattern * lanes >= n
    assert (per_pattern - gather_ops.SMEM_CLUSTER) * lanes < n
    assert gather_ops.SMEM_CLUSTER == 8


@pytest.mark.parametrize("clusters,err,raises", [
    (15, 0, None), (1, 0, None),
    # no cluster fits: the answer is 0 (gather_rows then routes the bucket
    # to the global kernel), kept like any other
    pytest.param(0, 0, None, id="0-0-no cluster"),
    (15, 2, "CUDA error 2")])
def test_smem_resident_ctas_asks_once_per_card_and_shape(
        monkeypatch, clusters, err, raises):
    import contextlib
    import ctypes
    calls = []

    def query(v, d, elem_bytes, where):
        calls.append((v, d, elem_bytes, torch_device[-1]))
        ctypes.c_int.from_address(where).value = clusters
        return err

    @contextlib.contextmanager
    def device(index):
        torch_device.append(index)
        yield
        torch_device.pop()
    torch_device = [None]
    monkeypatch.setattr(_build, "c_function", lambda lib, fn: query)
    monkeypatch.setattr(torch.cuda, "device", device)
    gather_ops.smem_resident_ctas.cache_clear()
    before = dict(launches)
    try:
        for _ in range(2):
            for index in (0, 1):
                if raises:
                    with pytest.raises(RuntimeError, match=raises):
                        gather_ops.smem_resident_ctas(32769, 1, index, 4)
                else:
                    assert gather_ops.smem_resident_ctas(32769, 1, index, 4) \
                        == clusters * gather_ops.SMEM_CLUSTER
        # each card is asked with itself current; a failed query is asked
        # again, an answer is kept
        want = [(32769, 1, 4, 0), (32769, 1, 4, 1)]
        assert calls == (want * 2 if raises else want)
    finally:
        gather_ops.smem_resident_ctas.cache_clear()
    assert launches == before            # a query, not a launch


def test_plain_gather_past_int32_rows():
    # a table of 2^31 + 16 rows, all 7.0 (a stride-0 view: no memory):
    # every int32 index >= 0 is a row; V must not wrap to a negative int32
    v = 2 ** 31 + 16
    table = torch.full((1, 1, 1), 7.0).expand(1, v, 1)
    idx = torch.tensor([[INT32_MAX, 0, -1, INT32_MAX - 1]], dtype=torch.int32)
    got = gather_rows_ref(table, idx)
    assert got.flatten().tolist() == [7.0, 7.0, 0.0, 7.0]


def test_plain_store_past_int32_rows():
    # dst of 2^31 + 16 rows, all one float (a stride-0 view: no memory);
    # index_put_ takes it (with a warning), so the one kept in-range lane at
    # INT32_MAX lands there: it must not be dropped by a range test that
    # compares int32 indices with a V no int32 holds
    v = 2 ** 31 + 16
    base = torch.zeros(1)
    dst = base.view(1, 1, 1).expand(1, v, 1)
    idx = torch.tensor([[INT32_MAX, 0, -1, INT32_MAX - 1]], dtype=torch.int32)
    keep = torch.tensor([[True, False, True, False]])
    vals = torch.tensor([[[5.0], [9.0], [7.0], [8.0]]])
    with pytest.warns(UserWarning):
        scatter_store_rows_ref_(dst, idx, keep, vals)
    assert base.item() == 5.0


@pytest.mark.parametrize("v,want", [
    (2 ** 31 + 16, [True, True, False, True, True]),
    (2 ** 31 - 1, [False, True, False, True, True]),
    (7, [False, True, False, False, True])])
def test_in_range_past_int32_rows(v, want):
    idx = torch.tensor([INT32_MAX, 0, -1, INT32_MAX - 1, 6],
                       dtype=torch.int32)
    assert in_range(idx, v).tolist() == want


def test_scatters_and_add_bound_select_lanes_by_in_range(monkeypatch):
    # index_add_ refuses a stride-0 dst, and add_error_bound's (B * V, D)
    # float64 sums past 2^31 rows would take 16 GB: the add and its bound
    # are held to the shared range test instead
    seen = []

    def spy(idx, v):
        seen.append(v)
        return in_range(idx, v)
    monkeypatch.setattr(scatter_ref, "in_range", spy)
    _, idx, vals = _inputs(2, 40, 3, 50)
    idx[0, :3] = [INT32_MAX, -1, 40]
    dst, idx, vals = (torch.zeros(2, 40, 3), torch.from_numpy(idx),
                      torch.from_numpy(vals))
    keep = torch.ones(2, 50, dtype=torch.bool)
    scatter_store_rows_ref_(dst.clone(), idx, keep, vals)
    scatter_add_rows_ref_(dst.clone(), idx, vals)
    add_error_bound(idx, vals, 40)
    assert seen == [40, 40, 40]


def test_gather_rows_routes_to_global_where_no_cluster_fits(monkeypatch):
    # a card that fits no cluster of 8: gather_rows sends a smem-regime
    # bucket to gather_rows_global (counted as a gather_rows launch) and
    # never to the plain version; gather_rows_smem itself still raises
    calls = []
    monkeypatch.setattr(gather_ops, "_checked",
                        lambda table, idx: torch.device("cuda", 0))
    monkeypatch.setattr(gather_ops, "smem_resident_ctas",
                        lambda v, d, index, eb: calls.append(
                            (v, d, index, eb)) or 0)
    monkeypatch.setattr(gather_ops, "gather_rows_ref", None)
    table = torch.zeros(1, 300, 1)
    idx = torch.zeros(1, 1000, dtype=torch.int32)
    assert gather_ops.use_smem(300, 1000, 1, 4)
    routed = []
    monkeypatch.setattr(gather_ops, "gather_rows_global",
                        lambda t, i: routed.append("global") or "out")
    assert gather_ops.gather_rows(table, idx) == "out"
    assert routed == ["global"] and calls == [(300, 1, 0, 4)]
    before = dict(launches)
    with pytest.raises(RuntimeError, match="no cluster"):
        gather_ops.gather_rows_smem(table, idx)
    assert launches == before


class _FakeLib:
    """A loaded library whose functions count their lookups and calls."""

    def __init__(self):
        self.lookups, self.calls = 0, []

    def __getattr__(self, name):
        self.lookups += 1

        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


def test_launch_looks_up_once_and_counts(monkeypatch):
    import contextlib
    lib = _FakeLib()
    entered = []
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "current_stream", lambda index: 1000 + index)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield
    monkeypatch.setattr(torch.cuda, "device", device)
    before = dict(launches)
    for dev in ("cuda", "cuda:0", "cuda:0", "cuda:1"):
        _build.launch("gather_rows", torch.device(dev), "gather_rows",
                      "gather_rows_f32", 1, 2, 3)
    _build.launch("gather_rows_smem", torch.device("cuda"), "gather_rows",
                  "gather_rows_smem_f32", 4)
    assert lib.lookups == 2                  # once per (library, function)
    # the device is entered only for a card other than the current one,
    # and each call gets its card's stream after its own arguments
    assert entered == [torch.device("cuda:1")]
    assert [c[1] for c in lib.calls] == [(1, 2, 3, 1000)] * 3 + [
        (1, 2, 3, 1001), (4, 1000)]
    assert launches["gather_rows"] == before["gather_rows"] + 4
    assert launches["gather_rows_smem"] == before["gather_rows_smem"] + 1
    assert all(launches[k] == before[k] for k in launches
               if k not in ("gather_rows", "gather_rows_smem"))
    assert not _build._libs


def test_launch_raises_on_a_cuda_error(monkeypatch):
    class Failing:
        def __getattr__(self, name):
            return lambda *args: 98         # cudaErrorInvalidDeviceFunction
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "library", lambda name: Failing())
    monkeypatch.setattr(_build, "current_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    before = dict(launches)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        _build.launch("gather_rows", torch.device("cuda"), "gather_rows",
                      "gather_rows_f32")
    assert launches == before


def test_cuda_sources_export_what_the_loader_binds():
    for lib, fns in _build._SIGNATURES.items():
        text = (ROOT / "src" / "repro_torch" / "csrc" / f"{lib}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn
            assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_library_path_is_keyed_by_source(monkeypatch):
    # the identity also holds nvcc's version and the card's compute
    # capability, which a CPU-only test run cannot ask for: give both
    monkeypatch.setattr(_build, "_toolchain",
                        {"nvcc": "Build cuda_12.8", "capability": "9.0"})
    p = _build._lib_path("gather_rows")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p != _build._lib_path("scatter_rows")
    assert p == _build._lib_path("gather_rows")
    monkeypatch.setitem(_build._toolchain, "nvcc", "Build cuda_12.9")
    assert p != _build._lib_path("gather_rows")
