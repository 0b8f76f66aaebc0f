"""repro_torch.tracing (the port of ``repro/core/tracing.py``'s
``trace_gs``) against the JAX package's, on the CPU.

The two traces see different programs of the same model: a jaxpr, whose
scanned layers weight their accesses by the trip count, and an unrolled
PyTorch forward, one access a layer.  So they are compared by aggregate:
grouped by (kind, row_elems), the rows and ``moved_bytes`` of each group
equal.  The JAX trace reads float32 smoke configs
(``examples/trace_model_patterns.py``); so does this one.  The rows of
row width d_model (the embedding and the MoE dispatch) must agree
everywhere; a group that differs is named below with its reason.
"""
import collections
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import trace_gs as j_trace_gs
from repro.models import transformer as j_tf
from repro.models.zoo import Model as JModel
from repro_torch import backends, run_suite
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer
from repro_torch.models.zoo import Model
from repro_torch.tracing import TracedAccess, TraceReport, trace_gs

ROOT = Path(__file__).resolve().parent.parent
TOKENS = (2, 64)              # the JAX example's traced batch
D_MODEL = 64                  # both smoke configs'


def _jax_report(arch):
    cfg = dataclasses.replace(j_get_smoke_config(arch), dtype="float32")
    params = JModel(cfg).abstract_params(jnp.float32)
    return j_trace_gs(lambda p, t: j_tf.forward(cfg, p, t)[0], params,
                      jax.ShapeDtypeStruct(TOKENS, jnp.int32))


def _port_report(arch, gs_backend="torch"):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lm = Model(cfg).init(device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, TOKENS))
    return trace_gs(lambda t: transformer.forward(cfg, lm, t,
                                                  gs_backend=gs_backend),
                    toks)


def _groups(report):
    """(kind, row_elems) -> [rows, moved_bytes, accesses]."""
    out = collections.defaultdict(lambda: [0, 0, 0])
    for a in report.accesses:
        g = out[(a.kind, a.slice_elems)]
        g[0] += a.n_lookups
        g[1] += a.moved_bytes
        g[2] += 1
    return dict(out)


def test_gemma2_trace_equals_jax():
    # exactly one access on both sides: the embedding's gather of 128
    # token rows of 64
    want, got = _jax_report("gemma2-27b"), _port_report("gemma2-27b")
    assert len(want.accesses) == len(got.accesses) == 1
    (w,), (g,) = want.accesses, got.accesses
    assert (g.kind, g.n_lookups, g.slice_elems, g.moved_bytes) == (
        w.kind, w.n_lookups, w.slice_elems, w.moved_bytes) == (
        "gather", 128, D_MODEL, 128 * D_MODEL * 4)
    assert g.operand_shape == w.operand_shape == (512, D_MODEL)
    assert _groups(got) == _groups(want)


def test_deepseek_trace_equals_jax_by_group():
    want, got = _groups(_jax_report("deepseek-v2-236b")), _groups(
        _port_report("deepseek-v2-236b"))
    assert set(got) == set(want)
    # rows of d_model: the embedding (128 rows), the dispatch's gather of
    # token rows and gather back (256 each), its fill and combine (256
    # each): equal, rows and bytes
    for key in (("gather", D_MODEL), ("scatter", D_MODEL)):
        assert got[key][:2] == want[key][:2], key
    assert got[("gather", D_MODEL)][0] == 128 + 2 * 256
    assert got[("scatter", D_MODEL)][0] == 2 * 256
    # the router's load count (index_add_ / .at[].add of 256 scalars)
    assert got[("scatter", 1)][:2] == want[("scatter", 1)][:2] == [256, 1024]
    # ("gather", 1) differs, for two reasons.  (a) JAX's searchsorted is a
    # loop of 9 gathers of 8 rows (72 rows, 288 bytes), torch.searchsorted
    # one op that is no indexed access.  (b) The dispatch sorts int64
    # indices in torch (argsort, arange) and int32 in JAX: its three index
    # gathers of 256 rows (the sorted experts, tokens and run starts)
    # move 8 bytes a row here, 4 there; the weights' gather moves 4 on
    # both sides.
    rows, moved, n = got[("gather", 1)]
    w_rows, w_moved, w_n = want[("gather", 1)]
    assert (n, rows, moved) == (4, 4 * 256, 3 * 256 * 8 + 256 * 4)
    assert (w_n, w_rows, w_moved) == (5, 4 * 256 + 72, 4 * 256 * 4 + 72 * 4)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "gemma2-27b"])
def test_trace_on_hopper_equals_torch(arch):
    # on CPU tensors the hopper backend runs the plain versions; either way
    # a backend call is one access, whatever it runs inside
    a, b = _port_report(arch, "torch"), _port_report(arch, "hopper")
    assert a.total_bytes == b.total_bytes
    assert len(a.accesses) == len(b.accesses)
    for x, y in zip(a.accesses, b.accesses):
        assert (dataclasses.replace(x, eqn_str="")
                == dataclasses.replace(y, eqn_str=""))
        assert ("backend='hopper'" in y.eqn_str) == x.eqn_str.startswith(
            "backends.")


def test_report_summary_and_patterns():
    report = _port_report("deepseek-v2-236b")
    assert 0 < report.gs_bytes < report.total_bytes
    assert report.gs_fraction == report.gs_bytes / report.total_bytes
    assert len(report.gathers()) + len(report.scatters()) == len(
        report.accesses)
    text = report.summary()
    assert text.startswith(f"traced {len(report.accesses)} G/S accesses")
    assert "[paper Table 1 analogue]" in text
    pats = report.to_patterns()
    assert len(pats) == len(report.accesses)
    for p, a in zip(pats, report.accesses):
        assert (p.kind, p.index, p.delta, p.count) == (
            a.kind, tuple(range(a.slice_elems)), a.slice_elems, a.n_lookups)
        # float32 rows, int64 indices
        assert a.moved_bytes in (4 * p.useful_elements(),
                                 8 * p.useful_elements())
    assert TracedAccess("x", "gather", (1,), (0,), (0,), 0, 1,
                        0).to_pattern() is None
    assert TraceReport([], 0).gs_fraction == 0.0


def test_aten_indexed_ops_are_recorded():
    t = torch.arange(60, dtype=torch.float32).reshape(5, 12)
    i = torch.tensor([4, 0, 4])

    def fn():
        torch.nn.functional.embedding(i, t)             # 3 rows of 12
        t.index_select(1, i)                            # 3 columns of 5
        t.gather(1, i.repeat(5, 1))                     # 15 elements
        t[i]                                            # 3 rows of 12
        t[t[:, 0] > 20]                                 # mask: 3 rows
        t[:, i]                                         # 3 columns of 5
        z = torch.zeros_like(t)
        z.index_put_((i,), torch.ones(12))              # 3 rows, broadcast
        z.index_add_(0, i, t[:3])                       # 3 rows of 12
        z.scatter_(1, i[None], t[:1, :3])               # 3 elements
        z.scatter_add(0, i[None].repeat(2, 1), t[:2, :3])   # 6 elements
        z.scatter_reduce(1, i[None], t[:1, :3], "amax")     # 3 elements
        t.sum()                                          # not indexed
    report = trace_gs(fn)
    got = [(a.primitive, a.kind, a.n_lookups, a.slice_elems, a.moved_bytes)
           for a in report.accesses]
    assert got == [
        ("embedding", "gather", 3, 12, 144),
        ("index_select", "gather", 3, 5, 60),
        ("gather", "gather", 15, 1, 60),
        ("index", "gather", 3, 12, 144),
        ("index", "gather", 3, 12, 144),
        ("index", "gather", 3, 5, 60),
        ("index_put", "scatter", 3, 12, 144),
        ("index_add", "scatter", 3, 12, 144),
        ("scatter", "scatter", 3, 1, 12),
        ("scatter_add", "scatter", 6, 1, 24),
        ("scatter_reduce", "scatter", 3, 1, 12),
    ]
    assert report.total_bytes > report.gs_bytes


def test_backend_calls_are_one_access_and_restored():
    src = torch.randn(10, 4)
    idx = torch.tensor([1, 9, 1], dtype=torch.int32)

    def fn():
        out = backends.gather(src, idx, backend="torch")
        dst = torch.zeros(10, 4)
        backends.scatter(dst, idx, out, mode="add", backend="scalar")
        backends.gather_batched(src[None].repeat(2, 1, 1), idx[None].repeat(
            2, 1), backend="onehot")
        raise KeyError("stop")
    with pytest.raises(KeyError):
        trace_gs(fn)
    assert backends.OBSERVER.get() is None      # the observer is reset
    report = trace_gs(lambda: [backends.gather(src, idx, backend="torch"),
                               backends.gather_batched(
                                   src[None].repeat(2, 1, 1),
                                   idx[None].repeat(2, 1),
                                   backend="onehot")])
    got = [(a.primitive, a.n_lookups, a.slice_elems, a.moved_bytes,
            a.operand_shape) for a in report.accesses]
    # onehot's matrix product and torch's index_select inside the calls are
    # not recorded again
    assert got == [("gather_rows", 3, 4, 48, (10, 4)),
                   ("gather_rows", 6, 4, 96, (2, 10, 4))]
    # the total is the two results (3 x 4 and 2 x 3 x 4 floats) and the
    # ops outside the calls: the views src[None] and idx[None] (which count
    # their bytes, as a jaxpr's reshape does) and their repeats
    assert report.total_bytes == (48 + 96 + 10 * 4 * 4 + 2 * 10 * 4 * 4
                                  + 3 * 4 + 2 * 3 * 4)


def test_scatter_mode_and_other_threads_and_nesting():
    """An add is replayed as an add, a store as a store; another thread's
    backend calls during a trace are not recorded; a trace inside a
    trace records its own calls, and the outer one records the inner's
    as its own."""
    import threading
    src = torch.randn(10, 4)
    idx = torch.tensor([1, 9, 1], dtype=torch.int32)

    def other():
        backends.gather(src, idx, backend="torch")

    def fn():
        backends.scatter(torch.zeros(10, 4), idx, src[:3], mode="add")
        backends.scatter(torch.zeros(10, 4), idx, src[:3],
                         keep=torch.tensor([False, True, True]))
        t = threading.Thread(target=other)
        t.start()
        t.join()
        inner.append(trace_gs(lambda: backends.gather(src, idx)))
    inner = []
    report = trace_gs(fn)
    assert [(a.primitive, a.mode) for a in report.accesses] == [
        ("scatter_add_rows", "add"), ("scatter_store_rows", "store"),
        ("gather_rows", "store")]
    assert [a.primitive for a in inner[0].accesses] == ["gather_rows"]
    aten = trace_gs(lambda: torch.zeros(10, 4).index_add_(0, idx.long(),
                                                          src[:3]))
    assert [a.mode for a in aten.accesses] == ["add"]


def test_distilled_patterns_replay_equal_on_hopper_and_torch():
    report = _port_report("deepseek-v2-236b")
    modes = collections.Counter(a.mode for a in report.accesses
                                if a.kind == "scatter")
    assert modes["add"] > 0              # the MoE dispatch's fill, combine
    for mode in ("store", "add"):
        pats = [a.to_pattern() for a in report.accesses if a.mode == mode]
        digests = {b: [r.out_digest for r in run_suite(
            pats, backend=b, runs=1, mode=mode, digest=True,
            device="cpu").results] for b in ("hopper", "torch")}
        assert digests["hopper"] == digests["torch"]
        assert len(digests["torch"]) == len(pats) and all(digests["torch"])


def test_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "trace_model_patterns_torch.py"), "gemma2-27b",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr
    assert "traced 1 G/S accesses (1 gathers / 0 scatters)" in out.stdout
    assert "replaying them through the engine" in out.stdout
    assert "traced-gather_rows" in out.stdout
