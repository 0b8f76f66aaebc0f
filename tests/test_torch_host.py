"""repro_torch: pattern language, appdb, host buffers and package hygiene,
held against the JAX package (repro.core) on the CPU."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import appdb as j_appdb
from repro.core import backends as j_backends
from repro.core import bandwidth as j_bw
from repro.core import engine as j_engine
from repro.core import pattern as j_pattern
from repro_torch import appdb, bandwidth, host, pattern

ROOT = Path(__file__).resolve().parent.parent
SUITES = ("demo", "apps", "widelane")


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
        return appdb.ALL_PATTERNS
    return pattern.load_suite(str(ROOT / "suites" / f"{name}.json"))


def _j(p):
    return j_pattern.Pattern(name=p.name, kind=p.kind, index=p.index,
                             delta=p.delta, count=p.count, source=p.source)


@pytest.mark.parametrize("spec", [
    "UNIFORM:8:1", "UNIFORM:16:3", "MS1:8:4:20", "MS1:8:2,5:3,7",
    "LAPLACIAN:2:2:100", "LAPLACIAN:3:1:10", "BROADCAST:8:4", "STREAM:5",
    "CUSTOM:0,4,8,12", "3,1,4,1,5"])
def test_generate_index_matches_reference(spec):
    assert pattern.generate_index(spec) == j_pattern.generate_index(spec)
    p, q = pattern.make_pattern(spec, delta=3, count=7), \
        j_pattern.make_pattern(spec, delta=3, count=7)
    assert (p.footprint(), p.classify(), p.reuse_factor()) == \
        (q.footprint(), q.classify(), q.reuse_factor())
    np.testing.assert_array_equal(p.absolute_indices(), q.absolute_indices())


@pytest.mark.parametrize("name", SUITES)
def test_load_suite_matches_reference(name):
    path = str(ROOT / "suites" / f"{name}.json")
    assert [_j(p) for p in pattern.load_suite(path)] == \
        j_pattern.load_suite(path)
    text = pattern.dump_suite(pattern.load_suite(path))
    assert pattern.load_suite(text) == pattern.load_suite(path)


def test_appdb_matches_reference():
    assert [_j(p) for p in appdb.ALL_PATTERNS] == j_appdb.ALL_PATTERNS
    for scale in (1.0, 1e-3):
        assert [_j(p) for p in appdb.scale_counts(appdb.ALL_PATTERNS, scale)] \
            == j_appdb.scale_counts(j_appdb.ALL_PATTERNS, scale)
    assert sorted(appdb.BY_APP) == sorted(j_appdb.BY_APP)
    assert _j(appdb.get("LULESH-S3")) == j_appdb.get("LULESH-S3")


def test_bandwidth_matches_reference():
    p = pattern.make_pattern("UNIFORM:8:4", delta=8, count=1000)
    assert bandwidth.useful_bytes(p, 12) == j_bw.useful_bytes(_j(p), 12)
    assert bandwidth.paper_bandwidth(p, 1e-3, 4) == \
        j_bw.paper_bandwidth(_j(p), 1e-3, 4)


@pytest.mark.parametrize("name", SUITES + ("appdb",))
@pytest.mark.parametrize("row_width", [1, 3])
def test_host_buffers_bit_equal(name, row_width):
    for seed, p in enumerate(_capped(_suite(name))):
        mine = host.make_host_buffers(p, row_width, seed=seed)
        ref = j_engine.make_host_buffers(_j(p), row_width, seed=seed)
        for a, b in zip(mine, ref):
            if b is None:
                assert a is None
                continue
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), p.name


def test_keep_last_mask_matches_reference():
    rng = np.random.default_rng(0)
    for n, hi in ((0, 1), (1, 1), (257, 16), (1000, 5000), (64, 1)):
        idx = rng.integers(0, hi, n, dtype=np.int32)
        np.testing.assert_array_equal(host.keep_last_mask(idx),
                                      j_backends.keep_last_mask(idx))


def test_import_loads_no_jax_repro_or_triton():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.models, repro_torch.launch\n"
        "lazy = sorted(m for m in sys.modules if m.startswith(("
        "'repro_torch.models.', 'repro_torch.launch.')))\n"
        "assert not lazy, lazy\n"
        "import repro_torch.__main__\n"
        "from repro_torch import appdb, backends, engine, host, plan, suite\n"
        "from repro_torch.kernels import _build\n"
        "from repro_torch.kernels.gather_rows import ops, ref\n"
        "from repro_torch.kernels.scatter_rows import ops, ref\n"
        "from repro_torch.kernels.selective_scan import ops, ref\n"
        "from repro_torch.kernels.flash_attention import ops, ref\n"
        "from repro_torch.kernels.paged_decode import ops, ref\n"
        "from repro_torch import configs\n"
        "from repro_torch.configs import base, falcon_mamba_7b, llama3_8b\n"
        "from repro_torch.models import attention, common, convert, ssm, "
        "transformer, zoo\n"
        "from repro_torch.launch import serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "assert not _build._libs, 'importing built a kernel'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_source_scan_no_forbidden_imports():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    forbidden = re.compile(
        r"^\s*(import|from)\s+(repro|jax|jaxlib|triton)(\.|\s|$)", re.M)
    assert len(files) > 10
    for f in files:
        hits = forbidden.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


def test_entry_points_without_device_raise_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None runs on the card")
    from repro_torch import GSEngine, SuitePlan, run_plan, run_suite
    from repro_torch.__main__ import main
    from repro_torch.plan import make_work
    pats = _capped(_suite("demo"))
    with pytest.raises(RuntimeError, match="CUDA"):
        GSEngine(pats[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_suite(pats)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_plan(SuitePlan.build(pats))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_work(SuitePlan.build(pats))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-l", "64"])


def test_float32_only():
    from repro_torch import GSEngine, SuitePlan, run_plan
    p = _capped(_suite("demo"))[0]
    for dtype in (torch.float64, torch.bfloat16, torch.float16):
        with pytest.raises(TypeError, match="float32"):
            GSEngine(p, dtype=dtype, device="cpu")
        with pytest.raises(TypeError, match="float32"):
            run_plan(SuitePlan.build([p]), dtype=dtype, device="cpu")
