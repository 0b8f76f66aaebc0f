#!/usr/bin/env python3
"""Paged decode's time against G, the query heads per KV head, and the
split count, at the decode shapes of chatglm3-6b (B 4, KVH 2, 514 pages a
row, length 8208) and starcoder2-15b (B 4, KVH 4, 258 pages, length
4112): dh 128, page 16, bfloat16, a permuted pool, every row at the timed
length.  Every G that the kernel holds at dh 128 reads the same K and V
bytes at one shape, so a time that grows with G is the kernel's work a
position, not its bytes; the split counts show whether more or fewer CTAs
a row would help.  Each cell: ms a call by CUDA events over back-to-back
calls of the wrapper (``splits`` passed explicitly; "auto" is
``kernels.autotune``'s choice), and its share of the byte bound.

    python3 probes/paged_group_probe.py [--out FILE]   # on the card

Prints one JSON line; ``--out`` also writes it to FILE.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
SHAPES = {"chatglm3-6b": (4, 2, 514, 8208),      # B, KVH, pps, length
          "starcoder2-15b": (4, 4, 258, 4112)}
GROUPS = (1, 2, 4, 8, 12, 16)
SPLITS = (None, 8, 16, 32, 64, 128)
DH, PAGE, ITERS = 128, 16, 50


def time_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import autotune
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.kernels.paged_decode.ref import (
        paged_decode_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "cells": []}
    for arch, (bsz, kvh, pps, length) in SHAPES.items():
        pool = bsz * pps

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        kp, vp = rnd(kvh, pool, PAGE, DH), rnd(kvh, pool, PAGE, DH)
        table = torch.randperm(pool, generator=gen, device="cuda").to(
            torch.int32).reshape(bsz, pps)
        lengths = torch.full((bsz,), length, dtype=torch.int32,
                             device="cuda")
        nbytes = 2 * bsz * kvh * length * DH * 2
        for g in GROUPS:
            q = rnd(bsz, kvh, g, DH)
            want = paged_decode_attention_ref(q.float(), kp.float(),
                                              vp.float(), table, lengths,
                                              scale=DH ** -0.5)
            auto = autotune.choose(ops.tile_key(
                bsz, kvh, g, DH, PAGE, pps, torch.bfloat16,
                autotune.cuda_platform(0))).splits
            for splits in SPLITS:
                s = auto if splits is None else splits
                got = ops.paged_decode_attention(q, kp, vp, table, lengths,
                                                 splits=s)
                err = (got.float() - want).abs().max().item()
                if err > 0.05:
                    raise SystemExit(f"{arch} G {g} splits {s}: max |err| "
                                     f"{err}")
                ms = time_ms(lambda: ops.paged_decode_attention(
                    q, kp, vp, table, lengths, splits=s))
                cell = dict(arch=arch, g=g, splits=s,
                            chosen=splits is None, ms=ms,
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                            max_abs_err=err)
                cell["bound_share"] = cell["bound_ms"] / ms
                out["cells"].append(cell)
                print(f"{arch} G {g:2d} splits {s:3d}"
                      f"{' (auto)' if splits is None else '       '} "
                      f"{ms:.4f} ms ({100 * cell['bound_share']:.1f}% of "
                      f"the bound)", flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
