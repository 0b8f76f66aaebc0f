#!/usr/bin/env python3
"""Count the SASS instructions of the port's built kernels, by class.

    python3 probes/sass_count.py [--tree SRC] [--lib NAME ...] [--match STR]
                                 [--dump FILE]

Builds the libraries of ``repro_torch`` (``kernels/_build``; from ``SRC``,
default this checkout's ``src/``) with nvcc, disassembles each with
``cuobjdump -sass`` and prints, for every kernel whose name holds
``--match``, its instruction count by opcode class (MUFU.EX2, FFMA, FMUL,
FADD, SHFL, LDS, LDG, STG, BAR, ...) and its local-memory accesses (spills
show as LDL/STL).  Atomics and reductions keep their whole opcode
(``ATOMG.E.CAS.STRONG.GPU``, ``REDG.E.ADD.F16x2.FTZ.RN.STRONG.GPU``, ...):
the suffix says whether an add is native or a compare-and-swap loop.  Prints one JSON line at the end; ``--dump`` writes the
matching kernels' whole SASS to FILE.  Needs the CUDA
toolkit (nvcc, cuobjdump); no card.
"""
import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def counts(sass: str, match: str):
    """{kernel: Counter(opcode)} over the functions of one cuobjdump dump."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter() if match in name else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)",
                     line)
        if m and name and out.get(name) is not None:
            op = m.group(1)
            base = op.split(".")[0]
            full = base == "MUFU" or base.startswith(("ATOM", "RED"))
            out[name][op if full else base] += 1
    return {k: v for k, v in out.items() if v is not None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT / "src"))
    ap.add_argument("--lib", nargs="*", default=["selective_scan",
                                                 "scatter_rows"])
    ap.add_argument("--match", default="")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.tree)
    from repro_torch.kernels import _build
    _build.build_all()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    result, dumped = {}, []
    for lib in args.lib:
        path = _build._lib_path(lib)
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        if args.dump:
            for part in sass.split("Function : ")[1:]:
                if args.match in part.split("\n", 1)[0]:
                    dumped.append("Function : " + part)
        for kernel, c in counts(sass, args.match).items():
            short = kernel[:120]
            result[short] = dict(c)
            top = ", ".join(f"{op} {n}" for op, n in c.most_common(14))
            spills = c.get("LDL", 0) + c.get("STL", 0)
            print(f"{lib}: {short}\n  {sum(c.values())} instructions; "
                  f"local (spill) accesses {spills}; {top}", flush=True)
    if args.dump:
        Path(args.dump).write_text("".join(dumped))
    print(json.dumps({"tree": args.tree, "sass": result}))


if __name__ == "__main__":
    main()
