#!/usr/bin/env python3
"""Drive the port's Spatter main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of the repository

Imports ``repro_torch`` (from ``src/``), ``torch``, numpy and the stdlib
only.  Phases:

  0. print the card (``nvidia-smi``), the torch and CUDA versions, and
     build the four CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
  1. hold each kernel against its plain PyTorch version on the card over
     B in {1, 3}, R in {1, 3, 8, 17}, ragged N, out-of-range and INT32_MAX
     lanes, duplicate indices, and tables on both sides of the
     shared-memory switch: gathers and stores must be ``torch.equal``, adds
     within ``add_error_bound``;
  2. the paper's CLI invocation ``-k Gather -p UNIFORM:8:1 -d 8 -l 2^24``
     through the port's CLI, as a gather, a store and an add scatter, on
     ``-b hopper`` and then on ``-b torch`` (the library yardstick);
  3. the planner: ``run_suite(..., digest=True)`` on ``suites/demo.json``
     and on the appdb Table 5 suite at scale 1.0, on hopper and torch: the
     digests must agree, and each kernel's launch count must rise by a
     warm-up plus ``runs`` per bucket;
  4. time each kernel, its plain version and one PyTorch library call at
     the shapes the main path gave it, and the add kernel once more on
     appdb's LULESH-S3 (2^25 lanes onto 16 rows).

The launch counts are set to 0 just before phase 2 and read just after
phase 3.  Any failed check raises, so the script exits nonzero.  Before
the last line it prints one ``{"kernels": [...]}`` JSON line; the last
line is ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
INT32_MAX = 2 ** 31 - 1
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
CLI_ARGS = ["-k", "Gather", "-p", "UNIFORM:8:1", "-d", "8", "-l", "16777216"]
RUNS = 10                        # min-of-K runs of the CLI and the suites
KERNEL_INFO = {                  # name -> (source, TPU kernel it replaces)
    "gather_rows": ("src/repro_torch/csrc/gather_rows.cu",
                    "src/repro/kernels/gather_rows/kernel.py:102"),
    "gather_rows_smem": ("src/repro_torch/csrc/gather_rows.cu",
                         "src/repro/kernels/gather_rows/kernel.py:44"),
    "scatter_store_rows": ("src/repro_torch/csrc/scatter_rows.cu",
                           "src/repro/kernels/scatter_rows/kernel.py:157"),
    "scatter_add_rows": ("src/repro_torch/csrc/scatter_rows.cu",
                         "src/repro/kernels/scatter_rows/kernel.py:83"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def setup():
    """Import the port and torch; fail without them or without a card."""
    src = ROOT / "src"
    check((src / "repro_torch" / "__init__.py").is_file(),
          f"repro_torch not found under {src}: run from the repository")
    sys.path.insert(0, str(src))
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    for k in _build.SOURCES:
        _build.library(k)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'cached'})", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas[{name}]: {line.strip()}")


# -- phase 1: kernels against their plain versions ----------------------------

def kernel_cases(torch):
    """Each kernel's wrapper vs its plain version; returns max |err| per
    kernel."""
    from repro_torch.host import keep_last_mask
    from repro_torch.kernels.gather_rows import ops as g
    from repro_torch.kernels.gather_rows.ref import gather_rows_ref
    from repro_torch.kernels.scatter_rows import ops as s
    from repro_torch.kernels.scatter_rows.ref import (add_error_bound,
                                                      scatter_add_rows_ref_,
                                                      scatter_store_rows_ref_)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    err = {k: 0.0 for k in KERNEL_INFO}
    n_cases = 0

    def rand_idx(bsz, n, v):
        idx = torch.randint(0, v, (bsz, n), generator=gen, dtype=torch.int32)
        flat = idx.view(-1)
        k = max(1, n // 17)                   # out-of-range lanes
        flat[:k] = INT32_MAX
        flat[k:2 * k] = -1
        flat[2 * k:3 * k] = v
        return idx[:, torch.randperm(n, generator=gen)].contiguous()

    for bsz in (1, 3):
        for r in (1, 3, 8, 17):
            limit_v = g.SMEM_TABLE_BYTES // (4 * r)
            for n in (1000, 4099):
                # gathers: smem at and below the limit, global above it
                for v, wrapper, name in (
                        (37, g.gather_rows_smem, "gather_rows_smem"),
                        (limit_v, g.gather_rows_smem, "gather_rows_smem"),
                        (limit_v + 1, g.gather_rows_global, "gather_rows"),
                        (1 << 16, g.gather_rows_global, "gather_rows")):
                    table = torch.randn(bsz, v, r, generator=gen).to(dev)
                    idx = rand_idx(bsz, n, v).to(dev)
                    got = wrapper(table, idx)
                    want = gather_rows_ref(table, idx)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"{name} B={bsz} R={r} N={n} V={v}: not equal")
                    err[name] = max(err[name],
                                    (got - want).abs().max().item())
                    n_cases += 1
                # auto picks the regime use_smem names
                for v in (limit_v, limit_v + 1):
                    table = torch.randn(bsz, v, r, generator=gen).to(dev)
                    idx = rand_idx(bsz, n, v).to(dev)
                    want_k = ("gather_rows_smem" if g.use_smem(v, n, r)
                              else "gather_rows")
                    before = dict(_launches())
                    got = g.gather_rows(table, idx)
                    torch.cuda.synchronize()
                    check(_launches()[want_k] == before[want_k] + 1,
                          f"gather_rows(V={v}) did not launch {want_k}")
                    check(torch.equal(got, gather_rows_ref(table, idx)),
                          f"gather_rows auto V={v}: not equal")
                # store: nonzero dst (untouched rows must stay), keep mask
                for v in (16, 5000):
                    idx = rand_idx(bsz, n, v)
                    # at most one kept in-range lane per row, per pattern;
                    # kept INT32_MAX lanes must be dropped by the range test
                    keep = torch.stack([torch.from_numpy(
                        keep_last_mask(idx[b].numpy())) for b in range(bsz)])
                    keep[idx == INT32_MAX] = True
                    dst = torch.randn(bsz, v, r, generator=gen).to(dev)
                    vals = torch.randn(bsz, n, r, generator=gen).to(dev)
                    idx, keep = idx.to(dev), keep.to(dev)
                    got = s.scatter_store_rows_(dst.clone(), idx, keep, vals)
                    want = scatter_store_rows_ref_(dst.clone(), idx, keep,
                                                   vals)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"scatter_store_rows B={bsz} R={r} N={n} V={v}")
                    n_cases += 1
                # add: heavy duplication (16 rows) and a wide table
                for v in (16, 5000):
                    idx = rand_idx(bsz, n, v).to(dev)
                    vals = torch.randn(bsz, n, r, generator=gen).to(dev)
                    zeros = torch.zeros(bsz, v, r, device=dev)
                    got = s.scatter_add_rows_(zeros.clone(), idx, vals)
                    want = scatter_add_rows_ref_(zeros.clone(), idx, vals)
                    torch.cuda.synchronize()
                    diff = (got - want).abs().double()
                    bound = add_error_bound(idx, vals, v)
                    check(bool((diff <= bound).all()),
                          f"scatter_add_rows B={bsz} R={r} N={n} V={v}: "
                          f"max err {diff.max().item()} over bound")
                    err["scatter_add_rows"] = max(err["scatter_add_rows"],
                                                  diff.max().item())
                    n_cases += 1
    print(f"phase 1: {n_cases} kernel cases equal their plain versions "
          f"(add within add_error_bound); max |err| {err}", flush=True)
    return err


def _launches():
    from repro_torch.kernels import launches
    return dict(launches)


# -- phases 2 and 3: the main path ---------------------------------------------

def main_path(torch):
    """The CLI and the planner on hopper and torch; returns the CLI
    results by (backend, kind, mode) and the per-bucket launch check."""
    from repro_torch import appdb, load_suite, run_suite
    from repro_torch.__main__ import main as cli
    from repro_torch.kernels.gather_rows.ops import use_smem

    cli_results = {}
    for backend in ("hopper", "torch"):
        for kernel, mode in (("Gather", "store"), ("Scatter", "store"),
                             ("Scatter", "add")):
            argv = (["-b", backend] + CLI_ARGS + ["-r", str(RUNS)]
                    + ["--mode", mode])
            argv[argv.index("Gather")] = kernel
            print(f"\n$ python -m repro_torch {' '.join(argv)}", flush=True)
            t0 = time.perf_counter()
            r = cli(argv)
            check(r.time_s > 0 and r.measured_gbs > 0, f"CLI {argv}: no time")
            print(f"  (CLI wall {time.perf_counter() - t0:.1f} s, host "
                  f"buffers {r.host_s:.1f} s)", flush=True)
            cli_results[(backend, kernel.lower(), mode)] = r
            torch.cuda.empty_cache()

    suites = {
        "demo": load_suite(str(ROOT / "suites" / "demo.json")),
        "appdb": appdb.scale_counts(appdb.ALL_PATTERNS, 1.0),
    }
    suite_stats = {}
    for name, pats in suites.items():
        digests, gbs = {}, {}
        for backend in ("hopper", "torch"):
            before = _launches()
            t0 = time.perf_counter()
            st = run_suite(pats, backend=backend, runs=RUNS, digest=True)
            wall = time.perf_counter() - t0
            after = _launches()
            digests[backend] = [r.out_digest for r in st.results]
            gbs[backend] = [r.measured_gbs for r in st.results]
            check(all(d for d in digests[backend]), f"{name}: missing digest")
            print(f"\nsuite {name} [{backend}]: {len(pats)} patterns -> "
                  f"{st.plan.n_buckets} buckets; min {st.min_gbs:.2f} max "
                  f"{st.max_gbs:.2f} harmonic-mean {st.hmean_gbs:.2f} GB/s "
                  f"on {st.results[0].device}; host assembly "
                  f"{st.host_s:.1f} s; wall {wall:.1f} s", flush=True)
            if backend == "hopper":
                want = {k: 0 for k in before}
                for b in st.plan.buckets:
                    spec = b.spec
                    if spec.kind == "gather":
                        k = ("gather_rows_smem"
                             if use_smem(spec.footprint + 1, spec.idx_len, 1)
                             else "gather_rows")
                    else:
                        k = "scatter_store_rows"
                    want[k] += 1 + RUNS          # warm-up + timed runs
                got = {k: after[k] - before[k] for k in before}
                check(got == want, f"{name}: launches {got} != {want}")
                print(f"  launches per kernel {got} "
                      f"(= buckets x (1 + {RUNS}))", flush=True)
                suite_stats[name] = st
            torch.cuda.empty_cache()
        check(digests["hopper"] == digests["torch"],
              f"{name}: hopper and torch digests differ at "
              f"{[p.name for p, a, b in zip(pats, *digests.values()) if a != b]}")
        print(f"  {name}: hopper digests == torch digests for all "
              f"{len(pats)} patterns", flush=True)
        print(f"  {'pattern':14s} {'kind':7s} {'lanes':>9s} "
              f"{'hopper GB/s':>11s} {'torch GB/s':>10s}")
        for p, h, t in zip(pats, gbs["hopper"], gbs["torch"]):
            print(f"  {p.name:14s} {p.kind:7s} {p.count * p.index_len:9d} "
                  f"{h:11.2f} {t:10.2f}")
    check(suite_stats["demo"].plan.n_buckets == 4, "demo: not 4 buckets")
    return cli_results, suite_stats


# -- phase 4: per-kernel times at the main path's shapes -----------------------

def _time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _keep_last_dev(torch, idx):
    """Device twin of host.keep_last_mask for one pattern's (N,) indices."""
    s, order = torch.sort(idx, stable=True)
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    keep = torch.zeros_like(last)
    keep[order[last]] = True
    return keep


def kernel_times(torch, err):
    """ms, plain_ms, library_ms, bound_ms and max |err| per kernel."""
    from repro_torch import SuitePlan, appdb, load_suite, make_pattern
    from repro_torch.kernels.gather_rows import ops as g
    from repro_torch.kernels.gather_rows.ref import gather_rows_ref
    from repro_torch.kernels.scatter_rows import ops as s
    from repro_torch.kernels.scatter_rows.ref import (add_error_bound,
                                                      scatter_add_rows_ref_,
                                                      scatter_store_rows_ref_)
    from repro_torch.plan import _assemble_members
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    def record(name, ms, plain_ms, library_ms, nbytes, shape, e):
        err[name] = max(err[name], e)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound(nbytes), bytes=nbytes, shape=shape)
        print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library {library_ms:.4f} ms, bound {bound(nbytes):.4f} "
              f"ms ({nbytes} bytes), max |err| {e}", flush=True)

    # the CLI's pattern, built on the device: UNIFORM:8:1, delta 8, 2^24
    p = make_pattern("UNIFORM:8:1", delta=8, count=2 ** 24)
    base = torch.arange(p.count, device=dev, dtype=torch.int64) * p.delta
    idx1 = (base[:, None] + torch.tensor(p.index, device=dev)[None, :]
            ).reshape(1, -1).to(torch.int32)
    n = idx1.shape[1]
    v = p.footprint()
    uniq = torch.unique(idx1).numel()
    print("\nphase 4: kernel times (CUDA events, mean of repeated launches)")

    # gather_rows (global): the CLI gather, table (1, 2^27, 1)
    table = torch.randn(1, v, 1, generator=gen, device=dev)
    got = g.gather_rows_global(table, idx1)
    want = gather_rows_ref(table, idx1)
    check(torch.equal(got, want), "gather_rows at CLI shape: not equal")
    record("gather_rows",
           _time_ms(torch, lambda: g.gather_rows_global(table, idx1), 20),
           _time_ms(torch, lambda: gather_rows_ref(table, idx1), 5),
           _time_ms(torch, lambda: torch.index_select(table[0], 0, idx1[0]),
                    20),
           n * 4 + uniq * 4 + n * 4, [1, v, 1],
           (got - want).abs().max().item())
    del table, got, want

    # gather_rows_smem: demo.json's UNIFORM:8:1 gather bucket
    demo = SuitePlan.build(load_suite(str(ROOT / "suites" / "demo.json")))
    bucket = next(b for b in demo.buckets if b.spec.kind == "gather"
                  and g.use_smem(b.spec.footprint + 1, b.spec.idx_len, 1))
    members = [demo.patterns[i] for i in bucket.members]
    (tb, ib), _ = _assemble_members(bucket.spec, members, 1,
                                    [0] * len(members), dev)
    got = g.gather_rows_smem(tb, ib)
    want = gather_rows_ref(tb, ib)
    check(torch.equal(got, want), "gather_rows_smem at demo shape")
    flat = (ib.to(torch.int64) + torch.arange(
        ib.shape[0], device=dev)[:, None] * tb.shape[1]).reshape(-1)
    record("gather_rows_smem",
           _time_ms(torch, lambda: g.gather_rows_smem(tb, ib), 200),
           _time_ms(torch, lambda: gather_rows_ref(tb, ib), 50),
           _time_ms(torch, lambda: torch.index_select(
               tb.reshape(-1, 1), 0, flat), 200),
           ib.numel() * 4 + torch.unique(flat).numel() * 4 + ib.numel() * 4,
           list(tb.shape), (got - want).abs().max().item())
    del tb, ib, got, want, flat

    # scatter_store_rows: the CLI store scatter, dst (1, 2^27, 1)
    vals = torch.randn(1, n, 1, generator=gen, device=dev)
    keep = _keep_last_dev(torch, idx1[0])[None]
    dst = torch.zeros(1, v, 1, device=dev)
    got = s.scatter_store_rows_(dst.clone(), idx1, keep, vals)
    want = scatter_store_rows_ref_(dst.clone(), idx1, keep, vals)
    check(torch.equal(got, want), "scatter_store_rows at CLI shape")
    del got, want
    rows_k = idx1[0][keep[0]].to(torch.int64)
    vals_k = vals[0][keep[0]]
    kept = rows_k.numel()
    record("scatter_store_rows",
           _time_ms(torch, lambda: s.scatter_store_rows_(dst, idx1, keep,
                                                         vals), 20),
           _time_ms(torch, lambda: scatter_store_rows_ref_(dst, idx1, keep,
                                                           vals), 5),
           _time_ms(torch, lambda: dst.view(-1, 1).index_put_((rows_k,),
                                                              vals_k), 20),
           n * 4 + n * 1 + kept * 4 + kept * 4, [1, v, 1], 0.0)
    del rows_k, vals_k, keep

    # scatter_add_rows: the CLI add scatter into zeros
    dst.zero_()
    got = s.scatter_add_rows_(dst.clone(), idx1, vals)
    want = scatter_add_rows_ref_(dst.clone(), idx1, vals)
    diff = (got - want).abs().double()
    check(bool((diff <= add_error_bound(idx1, vals, v)).all()),
          "scatter_add_rows at CLI shape: over add_error_bound")
    del got, want
    record("scatter_add_rows",
           _time_ms(torch, lambda: s.scatter_add_rows_(dst, idx1, vals), 20),
           _time_ms(torch, lambda: scatter_add_rows_ref_(dst, idx1, vals), 5),
           _time_ms(torch, lambda: dst.view(-1, 1).index_add_(
               0, idx1[0], vals[0]), 20),
           n * 4 + n * 4 + 2 * uniq * 4, [1, v, 1], diff.max().item())
    del dst, vals, idx1, diff

    # scatter_add_rows on appdb's LULESH-S3 (delta 0): all 2^25 lanes land
    # on 16 rows, so the atomics serialise there; timed, not redesigned
    p3 = appdb.scale_counts([appdb.get("LULESH-S3")], 1.0)[0]
    idx3 = torch.tensor(p3.index, device=dev, dtype=torch.int32).repeat(
        p3.count)[None]
    n3, v3 = idx3.shape[1], p3.footprint()
    vals3 = torch.randn(1, n3, 1, generator=gen, device=dev)
    dst3 = torch.zeros(1, v3, 1, device=dev)
    got = s.scatter_add_rows_(dst3.clone(), idx3, vals3)
    want = scatter_add_rows_ref_(dst3.clone(), idx3, vals3)
    diff = (got - want).abs().double()
    check(bool((diff <= add_error_bound(idx3, vals3, v3)).all()),
          "scatter_add_rows on LULESH-S3: over add_error_bound")
    s3 = dict(lanes=n3, rows=v3, max_abs_err=diff.max().item(),
              ms=_time_ms(torch, lambda: s.scatter_add_rows_(dst3, idx3,
                                                             vals3), 5),
              library_ms=_time_ms(torch, lambda: dst3.view(-1, 1).index_add_(
                  0, idx3[0], vals3[0]), 5),
              bound_ms=bound(n3 * 4 * 2 + 2 * v3 * 4))
    print(f"  scatter_add_rows on LULESH-S3 ({n3} lanes -> {v3} rows): "
          f"kernel {s3['ms']:.4f} ms, library {s3['library_ms']:.4f} ms, "
          f"bytes bound {s3['bound_ms']:.4f} ms, max |err| "
          f"{s3['max_abs_err']}", flush=True)
    out["lulesh_s3_add"] = s3
    del got, want, diff, idx3, vals3, dst3
    torch.cuda.empty_cache()
    return out


def main():
    torch = setup()
    build()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    err = kernel_cases(torch)
    print(f"phase 1 wall {time.perf_counter() - t0:.1f} s", flush=True)

    from repro_torch.kernels import reset_launches
    reset_launches()
    t0 = time.perf_counter()
    cli_results, suite_stats = main_path(torch)
    main_launches = _launches()
    print(f"\nmain path launches {main_launches}; phases 2-3 wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(all(main_launches[k] > 0 for k in KERNEL_INFO),
          f"a kernel of the main path never launched: {main_launches}")

    times = kernel_times(torch, err)
    lulesh_s3_add = times.pop("lulesh_s3_add")
    rows = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = times[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=main_launches[name],
                         max_abs_err=err[name], ms=t["ms"], time_ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by="bytes", library_ms=t["library_ms"],
                         shape=t["shape"]))
    cli = {f"{b}/{k}/{m}": dict(time_ms=r.time_s * 1e3, gbs=r.measured_gbs,
                                host_s=r.host_s)
           for (b, k, m), r in cli_results.items()}
    suites = {name: dict(min_gbs=st.min_gbs, max_gbs=st.max_gbs,
                         hmean_gbs=st.hmean_gbs, n_buckets=st.plan.n_buckets,
                         host_s=st.host_s)
              for name, st in suite_stats.items()}
    print(f"\nmax_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    print(json.dumps({"cli": cli, "suites_hopper": suites,
                      "lulesh_s3_add": lulesh_s3_add}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
