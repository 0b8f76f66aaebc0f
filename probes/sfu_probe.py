#!/usr/bin/env python3
"""The rate of ex2.approx.ftz.f32 (MUFU.EX2) on the card, alone and in the
selective scan's step (``sfu_probe.cu``): K independent chains a thread,
256 threads a block, 8 blocks an SM (64 warps), device time from
torch.profiler; prints exponentials per clock per SM at the card's maximum
SM clock, beside the 16 that the compute-capability 9.0 table gives.

    python3 probes/sfu_probe.py       # on a machine with the card and nvcc

Builds into ``src/repro_torch/_build/`` (listed in .gitignore).
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
from stage_probe import device_us  # noqa: E402


def main():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "sfu_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(HERE / "sfu_probe.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(out)).sfu_probe
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    clock = float(smi.stdout.strip().split(",")[-1]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 8, 4096
    sink = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for way, label in ((0, "x = ex2(x c)"), (1, "h = h ex2(d a) + d")):
        for k in (1, 4, 8, 16):
            def call():
                err = fn(sink.data_ptr(), blocks, iters, k, way, stream)
                assert err == 0, f"CUDA error {err}"
            us = device_us(call, 20)
            rate = blocks * 256 * iters * k / (us * 1e-6) / clock / sms
            rows[f"{way}/{k}"] = dict(us=us, per_clock_per_sm=rate)
            print(f"{label}, {k:2d} chains a thread: {us:.1f} us, "
                  f"{rate:.2f} exponentials a clock an SM", flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
