#!/usr/bin/env python3
"""Compare ptxas's registers and spills, instance by instance, between two
build logs: ``chip_smoke.py``'s output (its ``ptxas[<source>]`` lines) or
nvcc's own ``-Xptxas -v`` output, of two trees.

    python3 probes/ptxas_compare.py OLD_LOG NEW_LOG [--source paged_decode]

An instance is keyed by its mangled name with the anonymous namespace's
per-file hash taken out, so the same template instance of two trees'
sources matches.  Prints each instance that differs, each one only one
log has, the count of identical ones, and whether either log holds a
``C7515`` line (ptxas serialising a wgmma).  Exits 1 if an instance both
logs hold differs.
"""
import argparse
import re
import sys

_HASHED = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}")


def parse(text, source=None):
    """{instance: [spill line, registers line]} of one log."""
    out, cur = {}, None
    for line in text.splitlines():
        if source and "ptxas[" in line and f"ptxas[{source}]" not in line:
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _HASHED.sub(r"\1:", m.group(1))
            out[cur] = []
        elif cur and ("spill" in line or "Used" in line):
            out[cur].append(re.sub(r".*?(\d+ bytes stack|Used)", r"\1",
                                   line).strip())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--source", help="only this source's ptxas[...] lines")
    args = ap.parse_args(argv)
    texts = [open(p).read() for p in (args.old, args.new)]
    old, new = (parse(t, args.source) for t in texts)
    same = differ = 0
    for k in sorted(old.keys() & new.keys()):
        if old[k] == new[k]:
            same += 1
        else:
            differ += 1
            print(f"differs {k}:\n  old {old[k]}\n  new {new[k]}")
    for name, a, b in (("only old", old, new), ("only new", new, old)):
        for k in sorted(a.keys() - b.keys()):
            print(f"{name} {k}: {a[k]}")
    print(f"{same} instances identical, {differ} differ; C7515 in old "
          f"{'C7515' in texts[0]}, in new {'C7515' in texts[1]}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
