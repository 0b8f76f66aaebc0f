#!/usr/bin/env python3
"""Where the paged-decode wrapper's host time goes, a call, on the card:
each step of ``kernels/paged_decode/ops.paged_decode_attention``'s CUDA
path timed alone on the host clock (the checks, the output's allocation,
the split rule and workspace lookup, the C call that launches the
kernel), then the whole wrapper, at llama3-8b's decode shape (B 4, KVH
8, G 4, dh 128, page 16, 130 pages a row, bfloat16).  Calls are queued
without a synchronisation (200 a round, fewer than the launch queue
holds), so the times are the host's alone; the best of ten rounds.

    python3 probes/host_path_probe.py      # on a machine with the card and nvcc
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def host_us(fn, n=200, rounds=10):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def main():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels.paged_decode import ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    bsz, kvh, g, dh, page, pps = 4, 8, 4, 128, 16, 130
    dev = torch.device("cuda", 0)
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn(bsz, kvh, g, dh, **bf)
    kp = torch.randn(kvh, bsz * pps, page, dh, **bf)
    vp = torch.randn(kvh, bsz * pps, page, dh, **bf)
    table = torch.randperm(bsz * pps, device=dev).to(torch.int32).reshape(
        bsz, pps)
    lengths = torch.full((bsz,), pps * page, dtype=torch.int32, device=dev)
    ins = (q, kp, vp, table, lengths)
    ops.paged_decode_attention(*ins)            # builds and loads the kernel
    key = ops.tile_key(bsz, kvh, g, dh, page, pps, q.dtype,
                       autotune.cuda_platform(0))
    splits = autotune.choose(key).splits
    ws, cnt = ops._workspace(0, bsz * kvh * splits * g * (dh + 2), bsz * kvh)
    out = torch.empty_like(q)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), ws, cnt, bsz, kvh, g,
            bsz * pps, page, pps, dh, splits, dh ** -0.5, 0.0, 0)

    def checks():
        _build.check_operand("q", q, q.dtype, 4)
        _build.check_operand("k_pages", kp, q.dtype, 4)
        _build.check_operand("v_pages", vp, q.dtype, 4)
        _build.check_operand("page_table", table, torch.int32, 2)
        _build.check_operand("lengths", lengths, torch.int32, 1)
        _build.common_device(q=q, k_pages=kp, v_pages=vp, page_table=table,
                             lengths=lengths)
    c_fn = _build.c_function("paged_decode", "paged_decode_bf16")
    steps = {
        "five check_operand + common_device": checks,
        "torch.empty_like(q)": lambda: torch.empty_like(q),
        "tile_key + autotune.choose + _workspace": lambda: (
            autotune.choose(ops.tile_key(bsz, kvh, g, dh, page, pps, q.dtype,
                                         autotune.cuda_platform(0))),
            ops._workspace(0, 1, 1)),
        "six data_ptr()": lambda: (q.data_ptr(), kp.data_ptr(),
                                   vp.data_ptr(), table.data_ptr(),
                                   lengths.data_ptr(), out.data_ptr()),
        "C call alone (ctypes, launch)": lambda: c_fn(
            *args, _build.current_stream(0)),
        "_build.launch (device, stream, C call, count)": lambda: (
            _build.launch("paged_decode", dev, "paged_decode",
                          "paged_decode_bf16", *args)),
        "the whole wrapper": lambda: ops.paged_decode_attention(*ins),
    }
    for name, fn in steps.items():
        print(f"{name:48s} {host_us(fn):7.2f} us a call", flush=True)


if __name__ == "__main__":
    main()
