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
from repro_torch.kernels.scatter_rows.ref import (add_error_bound,
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
    assert gather_ops.use_smem(32769, 32768, 1)
    assert not gather_ops.use_smem(65537, 32768, 1)       # 256 KiB
    assert not gather_ops.use_smem(limit // 4, 100, 1)   # too few lanes
    assert gather_ops.use_smem(limit // 68, limit // 68, 17)
    assert not gather_ops.use_smem(limit // 68 + 1, 10 ** 6, 17)
    # runs: >= V lanes per CTA unless that leaves SMs idle, never < 256
    assert gather_ops.smem_lanes_per_cta(1, 32768, 32769) == 256
    assert gather_ops.smem_lanes_per_cta(64, 1 << 20, 5000) == 5000
    assert gather_ops.smem_lanes_per_cta(64, 1 << 20, 100) == 1024


def test_cuda_sources_export_what_the_loader_binds():
    for lib, fns in _build._SIGNATURES.items():
        text = (ROOT / "src" / "repro_torch" / "csrc" / f"{lib}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn
            assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_library_path_is_keyed_by_source():
    p = _build._lib_path("gather_rows")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p != _build._lib_path("scatter_rows")
    assert p == _build._lib_path("gather_rows")
