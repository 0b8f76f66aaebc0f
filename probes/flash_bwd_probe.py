#!/usr/bin/env python3
"""Variants of flash attention's bf16 backward (``csrc/flash_attention.cu``)
timed at a training shape: ``--shape llama`` (the default) times
``flash_attention_bwd_wgmma`` at the llama3-8b shape
(``chip_smoke.TRAIN_FLASH_SHAPE``: B 4, KVH 8, G 4, S = T = 4096, dh 128,
bfloat16, causal); ``--shape rg`` times ``flash_attention_bwd_dh256`` at
recurrentgemma-9b's (``chip_smoke.RG_TRAIN_BWD``: B 2, KVH 1, G 16, S = T
= 8192, dh 256, window 2,048, causal).  Each variant is the source with a
few lines replaced, or the DH-256 section by another layout's file
(``VARIANTS[shape]``), built with the port's nvcc flags and called
through its C entry.  Prints, a variant: ptxas's
registers and spills of the pass, counts in its SASS (``sass_stats``),
the device time of each kernel the call launches (torch.profiler, the best
of three rounds that take the variants in turn), and max |err| of dq, dk,
dv against the unchanged source's
(variants marked timing-only skip parts of the work and are not held to
it).  ``--compile-only`` stops after the builds; ``--src FILE`` adds
variant ``src``, another copy of the source as it is (an older tree's),
built and timed in the same rounds; ``--sass FILE`` writes the unchanged
pass's SASS (cuobjdump) there; ``--out FILE`` the results (JSON).

    python3 probes/flash_bwd_probe.py [variant ...] [--shape llama|rg]
        [--sass FILE] [--compile-only] [--src FILE] [--out FILE]

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
# shape -> (B, KVH, G, S = T, dh), window, the pass's kernel
SHAPES = {"llama": ((4, 8, 4, 4096, 128), 0, "flash_attention_bwd_wgmma"),
          "rg": ((2, 1, 16, 8192, 256), 2048, "flash_attention_bwd_dh256")}
_DQ128_ADDS = ("tma_reduce_add_3d(&tm_dq, dq_s + b * L::kRowBox,\n"
               "                          dq_col0")
# name -> ([(text in csrc/flash_attention.cu, replacement)], timing only)
LLAMA_VARIANTS = {
    "kept": ([], False),
    "stages3": ([("kBwdStages = 2;", "kBwdStages = 3;")], False),
    # the CTAs key tile first (longest first with causal), not (batch row,
    # KV head) first
    "order_kt": ([("  const int bh = blockIdx.x / n_kt;\n"
                   "  const int k0 = blockIdx.x % n_kt * kBwdKeysTc;",
                   "  const int bh = blockIdx.x % (gridDim.x / n_kt);\n"
                   "  const int k0 = blockIdx.x / (gridDim.x / n_kt) * "
                   "kBwdKeysTc;")], False),
    "no_reduce": ([(_DQ128_ADDS, "if (0) " + _DQ128_ADDS)], True),
    "no_dq": ([(_DQ128_ADDS, "if (0) " + _DQ128_ADDS),
               ("      wgmma_ss_mn(dq,", "      if (0) wgmma_ss_mn(dq,")],
              True),
    "no_mask": ([("const bool need_mask =\n        edge || (causal && k0 + 64",
                  "const bool need_mask = false &&\n        "
                  "(causal && k0 + 64")], True),
    # S^T, dP^T, P^T, dS^T and the stores only: no dV, dK or dQ product
    "only_sdp": ([("      wgmma_ss_mn(dq,", "      if (0) wgmma_ss_mn(dq,"),
                  ("      wgmma_rs(acc_dv,", "      if (0) wgmma_rs(acc_dv,"),
                  ("      wgmma_ss_bt(acc_dk,",
                   "      if (0) wgmma_ss_bt(acc_dk,")],
                 True),
}
_DQ_ADDS = ("        tma_reduce_add_3d(&tm_dq, dq_s + b * L::kRowBox,\n"
            "                          128 * wg + 32 * b,")
_DQ_MMA = "        wgmma_ss_mn(dq256[c],"
# the DH-256 section of the source, from its header to the launch that it
# shares with the DH-128 pass: a variant's "text" that stands for it
_SECTION = ("// -- backward, bfloat16 at DH 256:",
            "template <int DH, bool kCap, bool kWin>\nint launch_bwd_bf16(")
# the m64n32 products of 32-row steps, put before the section's constants
_M64N32 = r"""#define ACC16(d) ACC8(d, 0), ACC8(d, 8)
#define REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16(d) : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
      ", %16, %17, p, 1, 1, 1, 1;\n}\n"
      : ACC16(d) : "l"(a), "l"(b), "r"(accumulate));
}
constexpr int kB256Keys = 64;"""


def _rows32(stages):
    """32-row steps (m64n32 products) with ``stages`` (Q, dO) stages."""
    return [("constexpr int kB256Keys = 64;", _M64N32),
            ("kB256Rows = 64;", "kB256Rows = 32;"),
            ("kB256Stages = 1;", f"kB256Stages = {stages};")]


RG_VARIANTS = {
    "kept": ([], False),
    # R 32: two stages, three
    "r32": (_rows32(2), False),
    "r32_s3": (_rows32(3), False),
    # Q and dO in slots of their own (Q two, dO one), dQ unswapped and
    # added a warp at a time (probes/flash_bwd_dh256_split.cu)
    "split": ([(_SECTION, (ROOT / "probes" / "flash_bwd_dh256_split.cu")
                .read_text()),
               ("B * KVH * G, kRows)) {",
                "B * KVH * G, kWide ? kB256DqRows : kRows)) {")], False),
    # the query rows outer (from the last down), the heads inner, as the
    # DH-128 pass walks
    "rows_outer": ([("kB256HeadsOuter = true;",
                     "kB256HeadsOuter = false;")], False),
    # the CTAs (batch row, KV head) first, key tile fastest
    "order_bh": ([("  const int bh = blockIdx.x % n_bh;\n"
                   "  const int k0 = blockIdx.x / n_bh * kB256Keys;",
                   "  const int bh = blockIdx.x / (gridDim.x / n_bh);\n"
                   "  const int k0 = blockIdx.x % (gridDim.x / n_bh) * "
                   "kB256Keys;")], False),
    # the refills from the warp whose lane 0 adds the warpgroup's dQ
    "loader0": ([("const bool loader = warp == 3;",
                  "const bool loader = warp == 0;")], False),
    "no_reduce": ([(_DQ_ADDS, "if (0)" + _DQ_ADDS[6:])], True),
    # dQ neither staged nor added
    "no_dq_store": ([(_DQ_ADDS, "if (0)" + _DQ_ADDS[6:]),
                     ("            sts_f1(box + r * kSwizzleRow +",
                      "            if (0) sts_f1(box + r * kSwizzleRow +")],
                    True),
    "no_dq": ([(_DQ_ADDS, "if (0)" + _DQ_ADDS[6:]),
               (_DQ_MMA, "if (0)" + _DQ_MMA[6:])], True),
    # S^T, dP^T, P^T, dS^T and the stores only: no dV, dK or dQ product
    "only_sdp": ([(_DQ_ADDS, "if (0)" + _DQ_ADDS[6:]),
                  (_DQ_MMA, "if (0)" + _DQ_MMA[6:]),
                  ("      wgmma_rs(acc, pk + 4 * kb,",
                   "      if (0) wgmma_rs(acc, pk + 4 * kb,")], True),
}
VARIANTS = {"llama": LLAMA_VARIANTS, "rg": RG_VARIANTS}


def build(names, shape, other=None):
    """One nvcc per variant of the checkout's ``csrc/flash_attention.cu``
    (and, as ``src``, of the file ``other`` as it is), all at once;
    returns name -> C entry."""
    from repro_torch.kernels import _build
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names + (["src"] if other else []):
        text = src
        if name == "src":
            text = Path(other).read_text()
        else:
            for old, new in VARIANTS[shape][name][0]:
                if old is _SECTION:
                    a, b = text.index(old[0]), text.index(old[1])
                    text = text[:a] + new + "\n" + text[b:]
                    continue
                assert old in text, (name, old)
                text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"flash_bwd_probe_{shape}_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns, libs = {}, {}
    argtypes = _build._SIGNATURES["flash_attention"]["flash_attention_bwd_bf16"]
    kernel = SHAPES[shape][2]
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed, left out:\n{log[-3000:]}")
            continue
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and kernel in ln:
                print(f"{name}: {kernel}{ln.split(kernel)[1][:12]}: "
                      f"{' | '.join(x.strip() for x in lines[i + 1:i + 3])}")
            if "C7515" in ln or ("warning" in ln and "wgmma" in ln):
                print(f"{name}: {ln.strip()}")
        print(f"{name}: SASS {json.dumps(sass_stats(so, kernel))}",
              flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "flash_attention_bwd_bf16")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name], libs[name] = fn, so
    return fns, libs


def pass_sass(so, kernel):
    """The SASS of the functions named ``kernel`` in library ``so``."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    dump = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    parts = dump.split("Function : ")
    return "".join("Function : " + x for x in parts[1:]
                   if kernel in x.split("\n")[0])


def sass_stats(so, kernel):
    """Counts in the pass's SASS: wgmma (HGMMA), waits on them (a wait
    after every HGMMA means ptxas serialised them), spills, the highest
    register."""
    sass = pass_sass(so, kernel)
    regs = [int(r) for r in re.findall(r"\bR(\d+)\b", sass)]
    return dict(hgmma=sass.count("HGMMA"),
                depbar=sass.count("WARPGROUP.DEPBAR"),
                stl=len(re.findall(r"\bSTL", sass)),
                ldl=len(re.findall(r"\bLDL", sass)),
                max_reg=max(regs) if regs else None)


def device_ms(fn, best, iters=5):
    """Lower ``best`` ({kernel: device ms a call}) to one round's reading
    of each backward kernel that ``fn`` launches (by the name it is traced
    under)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and "flash_attention_bwd" in e.key:
            k = e.key.split("::")[1].split("<")[0].split("(")[0]
            best[k] = min(best.get(k, float("inf")),
                          e.self_device_time_total / iters / 1e3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--sass")
    ap.add_argument("--compile-only", action="store_true")
    ap.add_argument("--src", help="another flash_attention.cu to vary")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="llama")
    ap.add_argument("--out", help="write the results (JSON) there too")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention.ops import flash_attention_lse
    names = args.variants or list(VARIANTS[args.shape])
    if "kept" not in names:
        names = ["kept"] + names
    fns, libs = build(names, args.shape, args.src)
    names += ["src"] if "src" in fns else []
    (bsz, kvh, g, s, dh), window, kernel = SHAPES[args.shape]
    if args.sass and "kept" in libs:
        sass = pass_sass(libs["kept"], kernel)
        Path(args.sass).write_text(sass)
        print(f"SASS of the pass: {len(sass.splitlines())} lines in "
              f"{args.sass}")
    if args.compile_only:
        return
    gen = torch.Generator(device="cuda").manual_seed(51)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q, k, v, do = rnd(bsz, kvh, g, s, dh), rnd(bsz, kvh, s, dh), \
        rnd(bsz, kvh, s, dh), rnd(bsz, kvh, g, s, dh)
    o, lse = flash_attention_lse(q, k, v, window=window)
    scale = dh ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    out, calls = {}, {}
    want = None
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty(lse.shape, dtype=torch.float32, device="cuda")
    acc = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    for name in names:
        if name not in fns:
            continue

        def call(fn=fns[name], name=name):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                     acc.data_ptr(), bsz, kvh, g, s, s, dh, scale, 1, window,
                     0.0, stream)
            assert err == 0, (name, err)
        call()
        torch.cuda.synchronize()
        got = [x.float() for x in (dq, dk, dv)]
        if name == "kept":
            want = got
        timing_only = name != "src" and VARIANTS[args.shape][name][1]
        errs = (None if timing_only or want is None else
                [(a - w).abs().max().item() for a, w in zip(got, want)])
        calls[name] = call
        out[name] = dict(device_ms={}, max_abs_err_vs_kept=errs,
                         timing_only=timing_only)
    # rounds over the variants in turn, so that the card's drift (clocks,
    # heat) falls on all of them alike; the best round of each is kept
    for _ in range(3):
        for name, call in calls.items():
            device_ms(call, out[name]["device_ms"])
    for name in calls:
        out[name]["total_ms"] = sum(out[name]["device_ms"].values())
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
