#!/usr/bin/env python3
"""Variants of the selective scan's backward (``csrc/selective_scan.cu``,
``selective_scan_bwd_kernel``) timed at falcon-mamba-7b's training shape
(``chip_smoke.FM_SCAN_BWD_SHAPE``: B 4, L 4,096, D 8,192, N 16,
bfloat16).  Each variant is the source with a few lines replaced
(``VARIANTS``), built with the port's nvcc flags and called through its C
entries (the variant's own checkpointing forward, then its backward).
Prints, a variant: ptxas's registers and spills of the walk, counts in
its SASS (MUFU.EX2, SHFL, LDS, STS, BAR, local accesses), its resources
by the occupancy calculator (``selective_scan_bwd_attrs``), the device
time of the walk and of the sum over CTAs (torch.profiler, best of
rounds), and max |err| of each gradient against the unchanged source's
(variants marked timing-only skip work and are not held to it).

    python3 probes/scan_bwd_probe.py [variant ...] [--compile-only]
        [--out FILE] [--sass-dir DIR]

Builds into ``src/repro_torch/_build/`` (listed in .gitignore); needs the
card and nvcc.
"""
import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (4, 4096, 8192, 16)             # B, L, D, N
# name -> ([(text in csrc/selective_scan.cu, replacement)], timing only)
VARIANTS = {
    "kept": ([], False),
    # dA of every step taken twice, none kept
    "keep0": ([("constexpr int kKeepSteps = 4;",
                "constexpr int kKeepSteps = 0;")], False),
    # dA of every step kept (each exponential taken once)
    "keep8": ([("constexpr int kKeepSteps = 4;",
                "constexpr int kKeepSteps = 8;")], False),
    # the inputs by loads into registers, in flight across the pass only
    # (the instance unaligned operands take)
    "sync": ([("    const bool async = D % (16 / sizeof(T)) == 0 &&",
               "    const bool async = false && D % (16 / sizeof(T)) == 0 &&")],
             False),
    # one CTA an SM asked of ptxas: up to 255 registers
    "one_cta": ([("__launch_bounds__(BwdLayout<T, N, kAsync>::kThreads, 2)",
                  "__launch_bounds__(BwdLayout<T, N, kAsync>::kThreads, 1)")],
                False),
    # the pass without dB, dC (their partials not summed)
    "no_dbc": ([("      if (s < steps) {\n        part_bc[",
                 "      if (false) {\n        part_bc[")], True),
    # the pass without du, ddt
    "no_duddt": ([("        if (s < steps && 2 * pr < live) {",
                   "        if (false) {")], True),
    # the copies of the inputs read nothing (zeros): what the reads cost
    "no_gload": ([('"r"(on ? 16 : 0));', '"r"(0));')], True),
}
KERNELS = ("selective_scan_bwd_kernel", "selective_scan_bwd_sum")


def build(names, sass_dir=None):
    """One nvcc per variant, all at once; returns name -> library."""
    from repro_torch.kernels import _build
    src = (_build.CSRC_DIR / "selective_scan.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"scan_bwd_probe_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed, left out:\n{log[-3000:]}")
            continue
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if ("Compiling entry" in ln and "selective_scan_bwd_kernel" in ln
                    and "Li16E" in ln):
                kind = "bf16" if "bfloat16" in ln else "f32"
                kind += " async" if "Li16ELb1E" in ln else " sync"
                print(f"{name} {kind} N 16: "
                      f"{' | '.join(x.strip() for x in lines[i + 1:i + 3])}")
        lib = ctypes.CDLL(str(so))
        sigs = _build._SIGNATURES["selective_scan"]
        for fn in ("selective_scan_ckpt_bf16", "selective_scan_bwd_bf16",
                   "selective_scan_bwd_attrs"):
            getattr(lib, fn).argtypes = list(sigs[fn])
            getattr(lib, fn).restype = ctypes.c_int
        print(f"{name}: SASS {json.dumps(sass_stats(so, sass_dir, name))}",
              flush=True)
        libs[name] = (lib, so)
    return libs


def walk_sass(so):
    """The SASS of the bf16 N-16 walk (the async instance) in library
    ``so``."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    dump = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    return "".join("Function : " + x for x in dump.split("Function : ")[1:]
                   if "selective_scan_bwd_kernel" in x.split("\n")[0]
                   and "Li16ELb1E" in x.split("\n")[0]
                   and "bfloat16" in x.split("\n")[0])


def sass_stats(so, sass_dir=None, name=""):
    """Instruction counts of the bf16 N-16 walk's SASS, by class (written
    whole into ``sass_dir``, where given)."""
    sass = walk_sass(so)
    if sass_dir:
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        (Path(sass_dir) / f"scan_bwd_{name}.sass").write_text(sass)
    parts = [sass]
    c = collections.Counter()
    for part in parts:
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Za-z0-9_.]*)", part):
            op = m.group(1)
            c[op if op.startswith("MUFU") else op.split(".")[0]] += 1
    keys = ("MUFU.EX2", "FFMA", "FMUL", "FADD", "SHFL", "LDS", "STS", "LDG",
            "STG", "BAR", "LDL", "STL")
    return dict({k: c.get(k, 0) for k in keys}, total=sum(c.values()))


def device_ms(fn, iters=3, rounds=3):
    """{kernel: best-of-rounds device ms a call}."""
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for k in KERNELS:
            t = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA" and k in e.key)
            best[k] = min(best.get(k, float("inf")), t / iters / 1e3)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--compile-only", action="store_true")
    ap.add_argument("--out", help="write the JSON here as well")
    ap.add_argument("--sass-dir", help="write each variant's SASS there")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    names = args.variants or list(VARIANTS)
    if "kept" not in names:
        names = ["kept"] + names
    libs = build(names, args.sass_dir)
    if args.compile_only:
        return
    bsz, l, d, n = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(72)
    ins = c._scan_inputs(torch, gen, bsz, l, d, n, torch.bfloat16,
                         "softplus")
    dy = torch.randn(bsz, l, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    u, dt, b, cc, a, d_skip = ins
    f32 = torch.float32
    chunk = 8
    stream = torch.cuda.current_stream().cuda_stream
    out, want = {}, None
    for name in names:
        if name not in libs:
            continue
        lib = libs[name][0]
        attrs = (ctypes.c_int * 7)()
        assert lib.selective_scan_bwd_attrs(n, 1, ctypes.addressof(attrs)) \
            == 0
        attrs = dict(zip(("registers", "local_bytes", "threads",
                          "smem_bytes", "ctas_per_sm", "channels_per_cta",
                          "async"), attrs))
        y = torch.empty_like(u)
        h_final = torch.empty((bsz, n, d), dtype=f32, device="cuda")
        ckpt = torch.empty((bsz, -(-l // chunk), n, d), dtype=f32,
                           device="cuda")
        assert lib.selective_scan_ckpt_bf16(
            *(x.data_ptr() for x in (u, dt, b, cc, a, d_skip, y, h_final,
                                     ckpt)), bsz, l, d, n, stream) == 0
        grads = [torch.empty_like(x) for x in (u, dt, b, cc)]
        da = torch.empty((n, d), dtype=f32, device="cuda")
        dd = torch.empty((1, d), dtype=f32, device="cuda")
        part_bc = torch.empty((bsz, l, -(-d // attrs["channels_per_cta"]),
                               2 * n), dtype=f32, device="cuda")
        part_a = torch.empty((bsz, n, d), dtype=f32, device="cuda")
        part_d = torch.empty((bsz, d), dtype=f32, device="cuda")

        def call():
            err = lib.selective_scan_bwd_bf16(
                *(x.data_ptr() for x in (u, dt, b, cc, a, d_skip, dy)), None,
                ckpt.data_ptr(), *(g.data_ptr() for g in grads),
                da.data_ptr(), dd.data_ptr(), part_bc.data_ptr(),
                part_a.data_ptr(), part_d.data_ptr(), bsz, l, d, n, stream)
            assert err == 0, (name, err)
        call()
        torch.cuda.synchronize()
        got = [x.float() for x in (*grads, da, dd)]
        if name == "kept":
            want = got
        errs = (None if VARIANTS[name][1] or want is None else
                [(x - w).abs().max().item() for x, w in zip(got, want)])
        t = device_ms(call)
        ctas = bsz * -(-d // attrs["channels_per_cta"])
        out[name] = dict(device_ms=t, total_ms=sum(t.values()),
                         attrs=attrs, waves=ctas / max(
                             1, attrs["ctas_per_sm"] * c.N_SMS),
                         max_abs_err_vs_kept=errs,
                         timing_only=VARIANTS[name][1])
        print(f"{name}: {json.dumps(out[name])}", flush=True)
        del grads, ckpt, part_bc
        torch.cuda.empty_cache()
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line)
    print(line)


if __name__ == "__main__":
    main()
