#!/usr/bin/env python3
"""How long nvcc takes to build each kernel source, with the build's flags
(``_build.NVCC_FLAGS``, which carry ``-split-compile=0``) and without
``-split-compile``: every source at once, as ``_build.build_all`` starts
them, then the named sources one at a time; for each source alone, whether
ptxas reports the same registers and spill stores a kernel both ways.

    python3 probes/nvcc_time_probe.py [source ...]   # default: the three
                                                     # slowest to build

Needs nvcc (the machine with the card); builds into a temporary directory.
"""
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _flags(split: bool):
    from repro_torch.kernels import _build
    return [f for f in _build.NVCC_FLAGS
            if split or not f.startswith("-split-compile")]


def _cmd(name, split, out_dir):
    from repro_torch.kernels import _build
    return [_build.nvcc_path(), *_flags(split), "-o",
            str(Path(out_dir) / f"{name}-{int(split)}.so"),
            str(_build.CSRC_DIR / f"{name}.cu")]


def _ptxas(log: str):
    """(registers, spill stores) of each kernel, in ptxas's order."""
    return (re.findall(r"Used (\d+) registers", log),
            re.findall(r"(\d+) bytes spill stores", log))


def main():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    names = sys.argv[1:] or ["paged_decode", "scatter_rows",
                             "flash_attention"]
    print(f"nvcc {_build.nvcc_version()}; {os.cpu_count()} cores")
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        procs = {n: subprocess.Popen(_cmd(n, True, out_dir),
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.DEVNULL)
                 for n in _build.SOURCES}
        done = {}
        while len(done) < len(procs):
            for n, p in procs.items():
                if n not in done and p.poll() is not None:
                    done[n] = round(time.perf_counter() - t0, 1)
            time.sleep(0.1)
        print(f"all sources at once (build flags): {done} s")
        for n in names:
            row = {}
            for split in (False, True):
                t = time.perf_counter()
                r = subprocess.run(_cmd(n, split, out_dir),
                                   capture_output=True, text=True)
                if r.returncode:
                    raise SystemExit(r.stdout + r.stderr)
                row[split] = (time.perf_counter() - t,
                              _ptxas(r.stdout + r.stderr))
            print(f"{n} alone: {row[False][0]:.1f} s without -split-compile, "
                  f"{row[True][0]:.1f} s with it; same registers "
                  f"{row[False][1][0] == row[True][1][0]}, same spill stores "
                  f"{row[False][1][1] == row[True][1][1]}", flush=True)


if __name__ == "__main__":
    main()
