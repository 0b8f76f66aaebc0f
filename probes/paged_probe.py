#!/usr/bin/env python3
"""Variants of the paged-decode kernel (``csrc/paged_decode.cu``) timed at
llama3-8b's decode shape (B 4, KVH 8, G 4, dh 128, page 16, 130 pages a
row, length 2080, bfloat16) for several split counts: each variant is the
kernel's source with a few constants or lines replaced (``VARIANTS``),
built with the port's nvcc flags and called through its C entry, so the
split count is the probe's choice and not ``paged_splits``'s.  Inputs: a
permutation of the pool (34.1 MB of K and V a call, as the serve path);
the same with 256 MB read before each call (L2 full of other, clean
lines, as a serve step finds it); a table naming 64 pages a head (4 MB: every read an L2 hit,
spread over its slices); and rows of length 1 (the launch, the empty
splits and the merge).  Device time a launch of the kernel from
torch.profiler, max |err| against the plain version, and a check that
the merge counters are zero after the calls.

    python3 probes/paged_probe.py [variant ...]   # on a machine with the card and nvcc

Builds into ``src/repro_torch/_build/`` (listed in .gitignore).
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SHAPE = (4, 8, 4, 128, 16, 130, 2080)    # B, KVH, G, dh, page, pps, length
SPLITS = (8, 12)
# name -> [(text in csrc/paged_decode.cu, replacement)]
VARIANTS = {
    "kept": [],
    "stages4": [("kStages = 3;", "kStages = 4;")],
    "l2_256b": [("cp.async.cg.shared.global [%0]",
                 "cp.async.cg.shared.global.L2::256B [%0]")],
    "no_merge": [("if (!s_last) return;", "return;")],   # timing only
}


def device_us(fn, iters=100):
    """Device time a call of the paged-decode kernel (other kernels that
    ``fn`` launches, such as an L2 flush, are left out)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and "paged_decode" in e.key]
    return sum(e.self_device_time_total for e in evts) / iters


def build(names):
    """One nvcc per variant, all at once; returns name -> C entry."""
    from repro_torch.kernels import _build
    src = (_build.CSRC_DIR / "paged_decode.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"paged_probe_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    argtypes = _build._SIGNATURES["paged_decode"]["paged_decode_bf16"]
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed, left out:\n{log[-2000:]}")
            continue
        # ptxas on the instance this probe calls (bf16, G 4, dh 128)
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and "bfloat16Li4ELi128E" in ln:
                print(f"{name}: "
                      f"{' | '.join(x.strip() for x in lines[i + 1:i + 3])}")
        fn = getattr(ctypes.CDLL(str(so)), "paged_decode_bf16")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.paged_decode.ref import (
        paged_decode_attention_ref)
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    fns = build(names)
    bsz, kvh, g, dh, page, pps, length = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_pages = bsz * pps

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q, kp, vp = (rnd(bsz, kvh, g, dh), rnd(kvh, n_pages, page, dh),
                 rnd(kvh, n_pages, page, dh))
    full = torch.full((bsz,), length, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages, generator=gen, device="cuda").to(
        torch.int32).reshape(bsz, pps)
    tables = {
        "permuted": (perm, full),
        # 64 pages a head, 4 MB in all: L2 hits spread over its slices
        "64 pages": (torch.randint(0, 64, (bsz, pps), generator=gen,
                                   device="cuda", dtype=torch.int32), full),
        # one position a row: the launch, the empty splits and the merge
        "length 1": (perm, torch.ones_like(full)),
        # as "permuted", with L2 overwritten before each call (as a serve
        # step finds it: the other layers' pages have passed through)
        "cold L2": (perm, full)}
    flush = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    ws = torch.empty(bsz * kvh * max(SPLITS) * g * (dh + 2),
                     dtype=torch.float32, device="cuda")
    cnt = torch.zeros(bsz * kvh, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    scale = dh ** -0.5
    rows = []
    for tname, (table, lengths) in tables.items():
        plain = paged_decode_attention_ref(q.float(), kp.float(), vp.float(),
                                           table, lengths, scale=scale)
        for name, fn in fns.items():
            for s in SPLITS:
                def call():
                    if tname == "cold L2":
                        flush.sum()           # clean lines: reads only
                    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                             table.data_ptr(), lengths.data_ptr(),
                             out.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
                             bsz, kvh, g, n_pages, page, pps, dh, s, scale,
                             0.0, 0, stream)
                    assert err == 0, f"{name}: CUDA error {err}"
                out.zero_()
                cnt.zero_()                # no_merge leaves them counting
                call()
                torch.cuda.synchronize()
                err = (out.float() - plain).abs().max().item()
                us = device_us(call)
                zero = int(cnt.abs().sum().item())
                print(f"{tname:9s} {name:15s} splits {s:2d} ({s * bsz * kvh}"
                      f" CTAs): {us:7.2f} us  max|err| {err:.5f}  counters "
                      f"{'zero' if zero == 0 else 'NOT ZERO'}", flush=True)
                rows.append(dict(table=tname, variant=name, splits=s, us=us,
                                 max_abs_err=err, counters_zero=zero == 0))
    print(json.dumps({"device": smi.stdout.strip(), "rows": rows}))


if __name__ == "__main__":
    main()
