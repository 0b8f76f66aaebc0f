"""The paper's CLI (§3.4) on the port:

    ./spatter -k Gather -p UNIFORM:8:1 -d 8 -l $((2**24))
becomes
    PYTHONPATH=src python -m repro_torch -b hopper -k Gather -p UNIFORM:8:1 \\
        -d 8 -l 16777216 [--json suites/x.json]

Prints the paper's output: the min-of-K time and the useful-bytes
bandwidth, beside the name of the device that ran it.  ``--device`` picks
the device (default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import argparse


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch")
    ap.add_argument("-k", "--kernel", default="Gather",
                    choices=["Gather", "Scatter", "gather", "scatter"],
                    help="access kind (default Gather)")
    ap.add_argument("-p", "--pattern", default="UNIFORM:8:1",
                    help="UNIFORM:N:S | MS1:N:B:G | LAPLACIAN:D:L:S | "
                         "BROADCAST:N:R | i0,i1,...  (default UNIFORM:8:1)")
    ap.add_argument("-d", "--delta", type=int, default=8,
                    help="stride between accesses (default 8)")
    ap.add_argument("-l", "--count", type=int, default=1 << 16,
                    help="access count (default 65536)")
    ap.add_argument("-b", "--backend", default="torch",
                    choices=["torch", "onehot", "scalar", "hopper"],
                    help="backend (default torch)")
    ap.add_argument("-r", "--runs", type=int, default=10,
                    help="min-of-K timing (paper §3.5, default 10)")
    ap.add_argument("--row-width", type=int, default=1,
                    help="floats per element (default 1 = paper's scalar "
                         "element)")
    ap.add_argument("--json", default=None,
                    help="run a JSON suite file instead (paper §3.3)")
    ap.add_argument("--no-batch", action="store_true",
                    help="suite mode: one engine per pattern instead of the "
                         "bucketed planner (plan.py)")
    ap.add_argument("--mode", default="store", choices=["store", "add"],
                    help="scatter write semantics: last-write-wins store "
                         "(paper default) or add accumulation")
    ap.add_argument("--stream-r", action="store_true",
                    help="suite mode: also time the STREAM-like reference")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    return ap


def main(argv=None):
    """Run the CLI; returns the RunResult (one pattern) or SuiteStats."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be >= 1 (min-of-K timing needs a run)")
    if args.stream_r and not args.json:
        ap.error("--stream-r only applies to --json suite mode")
    from .engine import GSEngine
    from .pattern import load_suite, make_pattern
    from .suite import run_suite

    if args.json:
        stats = run_suite(load_suite(args.json), backend=args.backend,
                          runs=args.runs, row_width=args.row_width,
                          mode=args.mode, stream_r=args.stream_r,
                          batch=not args.no_batch, device=args.device)
        device = stats.results[0].device
        print(f"device: {device}")
        print(f"{'name':24s} {'type':16s} {'GB/s':>10s}")
        for r in stats.results:
            print(f"{r.pattern.name:24s} {r.pattern.classify():16s} "
                  f"{r.measured_gbs:10.2f}")
        print(f"\nsuite: min {stats.min_gbs:.2f}  max {stats.max_gbs:.2f}  "
              f"harmonic-mean {stats.hmean_gbs:.2f} GB/s   (paper §3.5)")
        if stats.stream_gbs is not None:
            print(f"stream: {stats.stream_gbs:.2f} GB/s reference")
        if stats.plan is not None:
            print(f"plan : {len(stats.results)} patterns -> "
                  f"{stats.plan.n_buckets} shape buckets "
                  f"(pad waste {stats.plan.pad_waste():.1%})")
        return stats

    p = make_pattern(args.pattern, kind=args.kernel.lower(),
                     delta=args.delta, count=args.count)
    print(f"pattern  : {list(p.index)}")
    print(f"type     : {p.classify()}   delta={p.delta}  count={p.count}")
    # reuse_factor runs np.unique over every address: host work, untimed
    print(f"footprint: {p.footprint()} elems   reuse={p.reuse_factor():.2f}x")
    r = GSEngine(p, backend=args.backend, mode=args.mode,
                 row_width=args.row_width, device=args.device
                 ).run(runs=args.runs)
    print(f"device   : {r.device}")
    print(f"time     : {r.time_s * 1e6:.1f} us (min of {args.runs})")
    print(f"bandwidth: {r.measured_gbs:.2f} GB/s measured")
    return r


if __name__ == "__main__":
    main()
