#!/usr/bin/env python3
"""Variants of flash attention's bf16 backward (``csrc/flash_attention.cu``,
``flash_attention_bwd_wgmma``) timed at the llama3-8b training shape
(``chip_smoke.TRAIN_FLASH_SHAPE``: B 4, KVH 8, G 4, S = T = 4096, dh 128,
bfloat16, causal).  Each variant is the source with a few lines replaced
(``VARIANTS``), built with the port's nvcc flags and called through its C
entry.  Prints, a variant: ptxas's registers and spills of the pass,
counts in its SASS (``sass_stats``), the device time of each of its
three kernels (torch.profiler, best of rounds), and max |err| of dq, dk,
dv against the unchanged source's (variants marked timing-only skip
parts of the work and are not held to it).  ``--compile-only`` stops
after the builds; ``--src FILE`` varies another copy of the source (an
older tree's, to compare in one call); ``--sass FILE`` writes the
unchanged pass's SASS (cuobjdump) there.

    python3 probes/flash_bwd_probe.py [variant ...] [--sass FILE]
        [--compile-only] [--src FILE]

Builds into ``src/repro_torch/_build/`` (listed in .gitignore); needs the
card and nvcc.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (4, 8, 4, 4096, 128)             # B, KVH, G, S = T, dh
# name -> ([(text in csrc/flash_attention.cu, replacement)], timing only)
VARIANTS = {
    "kept": ([], False),
    "stages3": ([("kBwdStages = 2;", "kBwdStages = 3;")], False),
    # the CTAs key tile first (longest first with causal), not (batch row,
    # KV head) first
    "order_kt": ([("  const int bh = blockIdx.x / n_kt;\n"
                   "  const int k0 = blockIdx.x % n_kt * kBwdKeysTc;",
                   "  const int bh = blockIdx.x % (gridDim.x / n_kt);\n"
                   "  const int k0 = blockIdx.x / (gridDim.x / n_kt) * "
                   "kBwdKeysTc;")], False),
    "no_reduce": ([("tma_reduce_add_3d(&tm_dq,",
                    "if (0) tma_reduce_add_3d(&tm_dq,")], True),
    "no_dq": ([("tma_reduce_add_3d(&tm_dq,",
                "if (0) tma_reduce_add_3d(&tm_dq,"),
               ("      wgmma_ss_mn(dq,", "      if (0) wgmma_ss_mn(dq,")],
              True),
    "no_mask": ([("const bool need_mask = edge ||",
                  "const bool need_mask = false &&")], True),
    # S^T, dP^T, P^T, dS^T and the stores only: no dV, dK or dQ product
    "only_sdp": ([("      wgmma_ss_mn(dq,", "      if (0) wgmma_ss_mn(dq,"),
                  ("      wgmma_rs(acc_dv,", "      if (0) wgmma_rs(acc_dv,"),
                  ("      wgmma_ss_bt(acc_dk,",
                   "      if (0) wgmma_ss_bt(acc_dk,")],
                 True),
}
KERNELS = ("flash_attention_bwd_delta", "flash_attention_bwd_wgmma",
           "flash_attention_bwd_dq_round")


def build(names, source=None):
    """One nvcc per variant of ``source`` (default the checkout's
    ``csrc/flash_attention.cu``), all at once; returns name -> C entry."""
    from repro_torch.kernels import _build
    src = Path(source or _build.CSRC_DIR / "flash_attention.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"flash_bwd_probe_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns, libs = {}, {}
    argtypes = _build._SIGNATURES["flash_attention"]["flash_attention_bwd_bf16"]
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed, left out:\n{log[-3000:]}")
            continue
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and "flash_attention_bwd_wgmma" in ln:
                print(f"{name}: "
                      f"{' | '.join(x.strip() for x in lines[i + 1:i + 3])}")
            if "C7515" in ln or ("warning" in ln and "wgmma" in ln):
                print(f"{name}: {ln.strip()}")
        print(f"{name}: SASS {json.dumps(sass_stats(so))}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "flash_attention_bwd_bf16")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name], libs[name] = fn, so
    return fns, libs


def pass_sass(so):
    """The SASS of ``flash_attention_bwd_wgmma`` in library ``so``."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    dump = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    parts = dump.split("Function : ")
    return "".join("Function : " + x for x in parts[1:]
                   if "flash_attention_bwd_wgmma" in x.split("\n")[0])


def sass_stats(so):
    """Counts in the pass's SASS: wgmma (HGMMA), waits on them (a wait
    after every HGMMA means ptxas serialised them), spills, the highest
    register."""
    sass = pass_sass(so)
    regs = [int(r) for r in re.findall(r"\bR(\d+)\b", sass)]
    return dict(hgmma=sass.count("HGMMA"),
                depbar=sass.count("WARPGROUP.DEPBAR"),
                stl=len(re.findall(r"\bSTL", sass)),
                ldl=len(re.findall(r"\bLDL", sass)),
                max_reg=max(regs) if regs else None)


def device_ms(fn, iters=5, rounds=3):
    """{kernel: best-of-rounds device ms a call} of the three kernels."""
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
    ap.add_argument("--sass")
    ap.add_argument("--compile-only", action="store_true")
    ap.add_argument("--src", help="another flash_attention.cu to vary")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention.ops import flash_attention_lse
    names = args.variants or list(VARIANTS)
    if "kept" not in names:
        names = ["kept"] + names
    fns, libs = build(names, args.src)
    if args.sass and "kept" in libs:
        sass = pass_sass(libs["kept"])
        Path(args.sass).write_text(sass)
        print(f"SASS of the pass: {len(sass.splitlines())} lines in "
              f"{args.sass}")
    if args.compile_only:
        return
    bsz, kvh, g, s, dh = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(51)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q, k, v, do = rnd(bsz, kvh, g, s, dh), rnd(bsz, kvh, s, dh), \
        rnd(bsz, kvh, s, dh), rnd(bsz, kvh, g, s, dh)
    o, lse = flash_attention_lse(q, k, v)
    scale = dh ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    want = None
    for name in names:
        if name not in fns:
            continue
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty(lse.shape, dtype=torch.float32, device="cuda")
        acc = torch.empty(q.shape, dtype=torch.float32, device="cuda")

        def call():
            err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            delta.data_ptr(), acc.data_ptr(), bsz, kvh, g, s,
                            s, dh, scale, 1, stream)
            assert err == 0, (name, err)
        call()
        torch.cuda.synchronize()
        got = [x.float() for x in (dq, dk, dv)]
        if name == "kept":
            want = got
        errs = (None if VARIANTS[name][1] or want is None else
                [(a - w).abs().max().item() for a, w in zip(got, want)])
        t = device_ms(call)
        out[name] = dict(device_ms=t, total_ms=sum(t.values()),
                         max_abs_err_vs_kept=errs,
                         timing_only=VARIANTS[name][1])
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
