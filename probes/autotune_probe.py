#!/usr/bin/env python3
"""The sweep behind ``kernels/autotune.py``'s cost constants, on the card.

Device time a launch (torch.profiler) of:

  regime  the smem gather (at the legacy lanes a CTA and at the search's
          candidates) against the global gather (both instances), for
          tables of V * 4 bytes from 4 KiB to 227 KB, N / V from 1/2 to
          64, contiguous (``arange(N) % V``, the UNIFORM:8:1 layout) and
          random lanes, B = 1;
  vecs    the global gather and the store, shallow (1) against deep
          (4 for D = 1, 8 for D = 8), from 2^12 to 2^26 lanes, and the
          gather at the CLI's shape (2^27 contiguous lanes);
  add     the add at the CLI's shape with the pattern's payloads and with
          a scratch pattern's (every lane +0.0 onto one row), and the CLI
          add through the planner unplaced and at (2, 1) on one card.

    python3 probes/autotune_probe.py [--out FILE] [--parts regime,vecs,add]

Prints one line a measurement and writes them all as JSON to ``--out``
(default ``_chip/autotune_probe.json``, git-ignored).  Builds the two
Spatter libraries into ``src/repro_torch/_build/`` (listed in .gitignore).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TABLE_BYTES = (4096, 16384, 65536, 131072, 232448)
RATIOS = (0.5, 2, 8, 64)


def device_us(torch, fn, iters, tries=4):
    """torch.profiler's device time of the kernels ``iters`` calls launch,
    over ``iters`` (a trace whose kernel count is not a multiple of
    ``iters`` is taken again: the profiler now and then loses records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA"]
        count = sum(e.count for e in evts)
        if count and count % iters == 0:
            break
    return sum(e.self_device_time_total for e in evts) / iters


def regime(torch, g, out):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for nbytes in TABLE_BYTES:
        v = nbytes // 4
        table = torch.randn(1, v, 1, device=dev, generator=gen)
        resident = g.smem_resident_ctas(v, 1, 0, 4)
        for ratio in RATIOS:
            n = int(v * ratio)
            for pattern in ("contiguous", "random"):
                idx = (torch.arange(n, device=dev, dtype=torch.int32) % v
                       if pattern == "contiguous" else
                       torch.randint(0, v, (n,), device=dev, generator=gen,
                                     dtype=torch.int32))[None]
                iters = 50 if n <= 1 << 20 else 10
                legacy = g.smem_lanes_per_cta(1, n, v, resident)
                whole = -(-n // g.SMEM_CLUSTER)
                lanes = sorted({legacy, whole} | {x for x in (256, 1024, 4096)
                                                  if x < whole})
                row = dict(sweep="regime", bytes=nbytes, v=v, n=n, b=1, d=1,
                           pattern=pattern, resident=resident)
                if g.use_smem(v, n, 1, 4):
                    for lp in lanes:
                        us = device_us(torch, lambda: g.gather_rows_smem(
                            table, idx, lanes_per_cta=lp), iters)
                        out.append(dict(row, kernel="smem", lanes_per_cta=lp,
                                        legacy=lp == legacy, us=us))
                        print(json.dumps(out[-1]), flush=True)
                for vecs in (1, 4):
                    us = device_us(torch, lambda: g.gather_rows_global(
                        table, idx, vecs=vecs), iters)
                    out.append(dict(row, kernel="global", vecs=vecs, us=us))
                    print(json.dumps(out[-1]), flush=True)


def vecs_sweep(torch, g, s, out):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for d, deep, logs in ((1, 4, range(12, 27, 2)), (8, 8, range(10, 23, 2))):
        for log_n in logs:
            n = 1 << log_n
            iters = 50 if n * d <= 1 << 20 else 10
            v = n
            table = torch.randn(1, v, d, device=dev, generator=gen)
            for pattern in ("contiguous", "random"):
                idx = (torch.arange(n, device=dev, dtype=torch.int32)
                       if pattern == "contiguous" else
                       torch.randperm(n, device=dev, generator=gen)
                       .to(torch.int32))[None]
                keep = torch.ones(1, n, dtype=torch.bool, device=dev)
                vals = torch.randn(1, n, d, device=dev, generator=gen)
                dst = torch.zeros(1, v, d, device=dev)
                for vecs in (1, deep):
                    for op, fn in (
                            ("gather_global", lambda: g.gather_rows_global(
                                table, idx, vecs=vecs)),
                            ("scatter_store", lambda: s.scatter_store_rows_(
                                dst, idx, keep, vals, vecs=vecs))):
                        us = device_us(torch, fn, iters)
                        out.append(dict(sweep="vecs", op=op, n=n, v=v, d=d,
                                        b=1, pattern=pattern, vecs=vecs,
                                        us=us))
                        print(json.dumps(out[-1]), flush=True)
            del table, idx, keep, vals, dst
    n = 1 << 27                      # the CLI gather's shape
    table = torch.randn(1, n + 1, 1, device=dev, generator=gen)
    idx = torch.arange(n, device=dev, dtype=torch.int32)[None]
    for vecs in (1, 4):
        us = device_us(torch, lambda: g.gather_rows_global(table, idx,
                                                           vecs=vecs), 10)
        out.append(dict(sweep="vecs", op="gather_global", n=n, v=n + 1, d=1,
                        b=1, pattern="cli", vecs=vecs, us=us))
        print(json.dumps(out[-1]), flush=True)


def add_part(torch, s, out):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from repro_torch.pattern import Pattern
    from repro_torch.plan import ExecutorCache, Placement
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    n = 1 << 27
    dst = torch.zeros(1, n + 1, 1, device=dev)
    idx = torch.arange(n, device=dev, dtype=torch.int32)[None]
    vals = torch.randn(1, n, 1, device=dev, generator=gen)
    scratch = torch.full((1, n), n, device=dev, dtype=torch.int32)
    zeros = torch.zeros(1, n, 1, device=dev)
    for name, i, x in (("pattern", idx, vals), ("scratch", scratch, zeros)):
        us = device_us(torch, lambda: s.scatter_add_rows_(dst, i, x), 10)
        out.append(dict(sweep="add", case=name, n=n, us=us))
        print(json.dumps(out[-1]), flush=True)
    a, b = torch.zeros(1, n + 1, 1, device=dev), torch.zeros(1, n + 1, 1,
                                                              device=dev)
    us = device_us(torch, lambda: torch.cat([a, b]), 10)
    out.append(dict(sweep="add", case="cat of two (1, 2^27 + 1, 1)", us=us))
    print(json.dumps(out[-1]), flush=True)
    del dst, idx, vals, scratch, zeros, a, b
    torch.cuda.empty_cache()
    pats = [Pattern.from_json(c._cli_doc("Scatter"))]
    cache = ExecutorCache()
    meshes = {"unplaced": None,
              "2x1": Placement.create((2, 1), devices=[dev] * 2)}
    with c._host_buffers_once():
        for label, mesh in meshes.items():
            r = c._placed_suite(torch, pats, "add", mesh, cache)
            out.append(dict(sweep="add", case=f"CLI add {label}",
                            ms=r["ms"]))
            print(json.dumps(out[-1]), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "_chip" /
                                         "autotune_probe.json"))
    ap.add_argument("--parts", default="regime,vecs,add")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("autotune_probe: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_rows import ops as g
    from repro_torch.kernels.scatter_rows import ops as s
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    props = torch.cuda.get_device_properties(0)
    print(card, f"{props.multi_processor_count} SMs",
          f"{props.max_threads_per_multi_processor} threads an SM",
          flush=True)
    t0 = time.perf_counter()
    for name in ("gather_rows", "scatter_rows"):
        _build.library(name)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    out = []
    parts = args.parts.split(",")
    if "regime" in parts:
        regime(torch, g, out)
    if "vecs" in parts:
        vecs_sweep(torch, g, s, out)
    if "add" in parts:
        add_part(torch, s, out)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=card, rows=out), indent=1))
    print(f"wrote {len(out)} rows to {args.out} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
