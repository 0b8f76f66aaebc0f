#!/usr/bin/env python3
"""The add kernel on hot rows, by element type and route.

Two parts, each one JSON line on stdout (and, with ``--out FILE``, all of
them in FILE):

* ``lulesh``: appdb's LULESH-S3 pattern (delta 0, every lane onto its 16
  rows) at 2^12 .. 2^25 lanes (2^25 is appdb's scale 1.0),
  ``scatter_add_rows_`` in float32, bfloat16 and float16 on the route its
  launch-parameter choice names, beside ``index_add_`` on the same
  inputs, each with its error against a float64 sum;
* ``fit``: the sweep the hot-row switch (``kernels/autotune.py``) was
  fitted to: D = 1 tables of V in {1, 16, 256, 4096, 16384} rows taking
  K in {4, 64, 256, 1024, 16384} lanes a row (at most 2^25 lanes), each row's
  lanes spread over the pattern in random order, B = 1 and 8, in
  float32 and bfloat16, both routes forced (``smem`` 0 and 1) beside the
  route the choice names.

ms a call by CUDA events (the lowest of 3 after a warm-up); a line whose
call takes more than 2 s ends its sweep (the lanes of a type, or a
route).  ``--tree`` times another checkout's ``repro_torch``, one whose
wrapper takes ``smem`` (an older one: time it with its own probe).

    python3 probes/hot_row_add_probe.py [--tree SRC] [--parts lulesh,fit]
                                        [--out FILE]

Needs the card and nvcc (the kernels build into the tree's
``repro_torch/_build/``).  The card's name and power limit
(``nvidia-smi``) lead the output and ride in every JSON line.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
LULESH_LANES = tuple(1 << k for k in (12, 14, 16, 18, 20, 22, 24, 25))
FIT_ROWS = (1, 16, 256, 4096, 16384)
FIT_PER_ROW = (4, 64, 256, 1024, 16384)
FIT_MAX_LANES = 1 << 25
STOP_MS = 2000.0


def ms_per_call(fn, calls=3):
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        t = start.elapsed_time(end)
        best = t if best is None else min(best, t)
    return best


def route(smem):
    return "smem" if smem else "streaming"


def ctas(dst, idx, smem):
    """Blocks a pattern on the hot-row route (0: streaming)."""
    from repro_torch.kernels.scatter_rows.ops import hot_ctas
    bsz, v, d = dst.shape
    return hot_ctas(bsz, idx.shape[1], v, d, dst.device, dst.dtype) if smem \
        else 0


def exact_err(got, idx, vals, v):
    """max |got - exact| over the rows, the exact sum in float64."""
    from repro_torch.kernels.scatter_rows.ref import scatter_add_rows_ref_
    want = scatter_add_rows_ref_(
        torch.zeros(idx.shape[0], v, vals.shape[2], dtype=torch.float64,
                    device=vals.device), idx, vals.double())
    return (got.reshape(want.shape).double() - want).abs().max().item()


def lulesh(card, dev):
    from repro_torch import appdb
    from repro_torch.kernels.scatter_rows import ops
    p = appdb.get("LULESH-S3")
    rows, v = len(set(p.index)), max(p.index) + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for lanes in LULESH_LANES:
            idx = torch.tensor(p.index, device=dev, dtype=torch.int32).repeat(
                lanes // len(p.index))[None]
            vals = torch.randn(1, idx.shape[1], 1, generator=gen,
                               device=dev).to(dtype)
            dst = torch.zeros(1, v, 1, device=dev, dtype=dtype)
            smem = ops.add_tiles(1, idx.shape[1], v, 1, dev, dtype).smem
            kernel = ms_per_call(lambda: ops.scatter_add_rows_(dst, idx, vals))
            dst.zero_()
            got = ops.scatter_add_rows_(dst, idx, vals)
            err = exact_err(got, idx, vals, v)
            dst.zero_()
            library = ms_per_call(lambda: dst.view(-1, 1).index_add_(
                0, idx[0], vals[0]))
            dst.zero_()
            lib = dst.view(-1, 1).index_add_(0, idx[0], vals[0])
            row = dict(dtype=str(dtype).removeprefix("torch."),
                       lanes=idx.shape[1], rows=rows,
                       route=route(smem), ctas=ctas(dst, idx, smem),
                       kernel_ms=kernel, library_ms=library,
                       finite=bool(torch.isfinite(got).all()),
                       ns_per_lane=kernel * 1e6 / idx.shape[1],
                       err=err, library_err=exact_err(lib.view(dst.shape),
                                                      idx, vals, v))
            out.append(row)
            print(f"  {row['dtype']:8s} {row['lanes']:8d} lanes on {rows} "
                  f"rows [{row['route']}, {row['ctas']} CTAs]: kernel "
                  f"{kernel:.4f} ms ({row['ns_per_lane']:.3f} ns a lane, "
                  f"err {err:.4g}), index_add_ {library:.4f} ms (err "
                  f"{row['library_err']:.4g}), finite {row['finite']}",
                  flush=True)
            del idx, vals, dst, got, lib
            if kernel > STOP_MS:
                break
    return {"card": card, "hot_row_add": out}


def fit(card, dev):
    from repro_torch.kernels.scatter_rows import ops
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for bsz in (1, 8):
            slow = set()
            for v in FIT_ROWS:
                for k in FIT_PER_ROW:
                    n = v * k
                    if bsz * n > FIT_MAX_LANES:
                        continue
                    idx = torch.stack([
                        torch.randperm(n, generator=gen, device=dev) % v
                        for _ in range(bsz)]).to(torch.int32)
                    vals = torch.randn(bsz, n, 1, generator=gen,
                                       device=dev).to(dtype)
                    dst = torch.zeros(bsz, v, 1, device=dev, dtype=dtype)
                    row = dict(dtype=str(dtype).removeprefix("torch."),
                               batch=bsz, rows=v, lanes=n, per_row=k,
                               chosen=ops.add_tiles(bsz, n, v, 1, dev,
                                                    dtype).smem,
                               bytes=bsz * n * (4 + dst.element_size()))
                    for smem in (0, 1):
                        name = route(smem)
                        if name in slow:
                            continue
                        ms = ms_per_call(lambda: ops.scatter_add_rows_(
                            dst, idx, vals, smem=smem))
                        row[f"{name}_ms"] = ms
                        row[f"{name}_ctas"] = ctas(dst, idx, smem)
                        if ms > STOP_MS:
                            slow.add(name)
                    out.append(row)
                    print(f"  {row['dtype']:8s} B={bsz} V={v:6d} K={k:6d}: "
                          + ", ".join(f"{r} {row[r + '_ms']:.4f} ms"
                                      for r in ("streaming", "smem")
                                      if r + "_ms" in row)
                          + f" (chosen {row['chosen']})", flush=True)
                    del idx, vals, dst
    return {"card": card, "hot_row_fit": out,
            "ns_per_byte_bound": 1e9 / 3.35e12}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--parts", default="lulesh,fit")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    lines = []
    for part in args.parts.split(","):
        print(f"{part} ({args.tree}):", flush=True)
        lines.append(json.dumps({"lulesh": lulesh, "fit": fit}[part](
            card, dev)))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
