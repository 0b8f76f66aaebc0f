#!/usr/bin/env python3
"""What staging a table in shared memory costs on the card, by way
(``stage_probe.cu``): the launch floor, plain 16-byte loads, one TMA bulk
copy, and clusters of 8 whose CTAs each multicast 1/8 of the table, with
release/acquire or relaxed cluster barriers.  Device time a launch from
torch.profiler, for 128 KiB (demo's table) and 8 KiB, for one cluster's
CTAs and for 120 CTAs (one wave).

    python3 probes/stage_probe.py       # on a machine with the card and nvcc

Builds into ``src/repro_torch/_build/`` (listed in .gitignore).
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WAYS = {0: "launch floor", 1: "plain 16-byte loads", 2: "TMA bulk copy",
        3: "multicast x8, release barriers", 4: "multicast x8, relaxed",
        5: "multicast x8, relaxed, no exit barrier"}


def device_us(fn, iters=100):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.self_device_time_total for e in evts) / iters


def main():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "stage_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(HERE / "stage_probe.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(out)).stage_probe
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p] * 2
    table = torch.randn(1 << 16, device="cuda")
    sink = torch.empty(1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    for nbytes in (131072, 8192):
        for way, label in WAYS.items():
            cluster = 8 if way >= 3 else 1
            for grid in (cluster, 120):
                def call():
                    err = fn(table.data_ptr(), nbytes, way, cluster, grid,
                             sink.data_ptr(), stream)
                    assert err == 0, f"CUDA error {err}"
                print(f"{nbytes:7d} bytes, {grid:3d} CTAs, {label}: "
                      f"{device_us(call):.2f} us", flush=True)


if __name__ == "__main__":
    main()
