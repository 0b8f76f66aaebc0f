#!/usr/bin/env python3
"""The add kernel on a few hot rows, by element type: appdb's LULESH-S3
pattern (delta 0, every lane onto its 16 rows) cut to 2^12 .. 2^20 lanes,
``scatter_add_rows_`` in float32, bfloat16 and float16 beside
``index_add_`` on the same inputs.  ms a call by CUDA events (the lowest
of 3 after a warm-up); a type's sweep stops after a call of more than 2 s.
One JSON line on stdout (and in ``--out FILE``).

    python3 probes/hot_row_add_probe.py [--out chiprun_out/hot_rows.json]

Needs the card and nvcc (the kernels build into ``src/repro_torch/_build/``).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
LANES = (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import appdb
    from repro_torch.kernels.scatter_rows import ops as s
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    p = appdb.get("LULESH-S3")
    rows = len(set(p.index))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for lanes in LANES:
            idx = torch.tensor(p.index, device=dev, dtype=torch.int32).repeat(
                lanes // len(p.index))[None]
            vals = torch.randn(1, idx.shape[1], 1, generator=gen,
                               device=dev).to(dtype)
            v = max(p.index) + 1
            dst = torch.zeros(1, v, 1, device=dev, dtype=dtype)
            kernel = ms_per_call(lambda: s.scatter_add_rows_(dst, idx, vals))
            dst.zero_()
            got = s.scatter_add_rows_(dst, idx, vals)
            library = ms_per_call(lambda: dst.view(-1, 1).index_add_(
                0, idx[0], vals[0]))
            row = dict(dtype=str(dtype).removeprefix("torch."),
                       lanes=idx.shape[1], rows=rows, kernel_ms=kernel,
                       library_ms=library,
                       finite=bool(torch.isfinite(got).all()),
                       ns_per_lane=kernel * 1e6 / idx.shape[1])
            out.append(row)
            print(f"  {row['dtype']:8s} {row['lanes']:8d} lanes on {rows} "
                  f"rows: kernel {kernel:.4f} ms ({row['ns_per_lane']:.2f} "
                  f"ns a lane), index_add_ {library:.4f} ms, finite "
                  f"{row['finite']}", flush=True)
            del idx, vals, dst, got
            if kernel > STOP_MS:
                break
    line = json.dumps({"card": card, "hot_row_add": out})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
