"""The paper's CLI (§3.4) on the port:

    ./spatter -k Gather -p UNIFORM:8:1 -d 8 -l $((2**24))
becomes
    PYTHONPATH=src python -m repro_torch -b hopper -k Gather -p UNIFORM:8:1 \\
        -d 8 -l 16777216 [--json suites/x.json]

Prints the paper's output: the min-of-K time and the useful-bytes
bandwidth, beside the name of the device that ran it.  ``--device`` picks
the device (default ``cuda``; ``cpu`` runs the kernels' plain versions).

Suite mode places its bucket launches with ``--mesh N|BxL|auto|auto-suite``
(``plan.Placement``): N devices on the pattern-batch axis, a B x L
(batch x lane) grid, or the cost model's choice per bucket (``auto``) or
for the suite (``auto-suite``), over the CUDA devices; it prints each
bucket's placement.  A mesh of more devices than the machine has is an
error naming the count (the CPU is one device).

``--lint SUITE`` audits every bucket callable the planner would build for
SUITE (``repro_torch.analysis``: the census of one untimed call of each on
zero operands, on ``--device``) plus the serving layer's concurrency lint;
``--cost SUITE`` prices their traffic.  Both honour ``--mesh``,
``--backend``, ``--mode``, ``--row-width`` and ``--device``, refuse
run-shaped options, write their JSON report with ``--lint-out`` /
``--cost-out`` (the schema of spatterd's ``GET /lint`` and ``GET /cost``)
and exit 1 on any violation.
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
    ap.add_argument("--mesh", default="0", metavar="N|BxL|auto",
                    help="suite mode: place bucket launches over N devices "
                         "(pattern-batch axis), a BxL (batch x lane) grid, "
                         "or 'auto' / 'auto-suite' (least predicted "
                         "traffic, per bucket / per suite); default 0 = "
                         "one device")
    ap.add_argument("--mode", default="store", choices=["store", "add"],
                    help="scatter write semantics: last-write-wins store "
                         "(paper default) or add accumulation")
    ap.add_argument("--stream-r", action="store_true",
                    help="suite mode: also time the STREAM-like reference "
                         "and report paper Eq. 1's Pearson R")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--lint", default=None, metavar="SUITE",
                    help="spatterlint: audit every bucket callable the "
                         "planner would build for SUITE, and the serving "
                         "layer's locks (repro_torch.analysis); exits 1 on "
                         "any violation")
    ap.add_argument("--lint-out", default=None, metavar="FILE",
                    help="--lint: also write the JSON report (the schema "
                         "GET /lint serves)")
    ap.add_argument("--cost", default=None, metavar="SUITE",
                    help="spattercost: the predicted traffic of every "
                         "bucket launch of SUITE, held against a census of "
                         "each; exits 1 on any violation")
    ap.add_argument("--cost-out", default=None, metavar="FILE",
                    help="--cost: also write the JSON report (the schema "
                         "GET /cost serves)")
    return ap


# options a static audit takes; every other one shapes a run
_AUDIT_OPTIONS = ("mesh", "backend", "mode", "row_width", "device")


def _given(ap, argv) -> set[str]:
    """The dests of the options ``argv`` names (explicit defaults too)."""
    given = set()
    for action in ap._actions:
        for opt in action.option_strings:
            if any(a == opt or (opt.startswith("--")
                                and a.startswith(opt + "="))
                   for a in argv):
                given.add(action.dest)
    return given


def _audit(ap, args, given):
    """--lint / --cost: the report, printed (and dumped); exit 1 on a
    violation."""
    what = "lint" if args.lint is not None else "cost"
    bad = sorted(given - set(_AUDIT_OPTIONS) - {what, f"{what}_out"})
    if bad:
        ap.error(f"{', '.join('--' + b.replace('_', '-') for b in bad)}: "
                 f"not applicable to --{what} (static audit; only --mesh/"
                 f"--backend/--mode/--row-width/--device apply)")
    from .serve.schema import parse_mesh
    try:
        mesh = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(f"--mesh: {e}")
    kw = dict(mesh=mesh or None, mode=args.mode, row_width=args.row_width,
              device=args.device,
              backends=((args.backend,) if "backend" in given
                        else ("torch", "hopper")))
    try:
        if what == "lint":
            from .analysis.lint import lint_serve, lint_suite_file
            report = lint_serve().merge(lint_suite_file(args.lint, **kw))
        else:
            from .analysis.cost import cost_suite_file
            report = cost_suite_file(args.cost, **kw)
    except (ValueError, OSError) as e:
        ap.error(f"--{what}: {e}")
    out = args.lint_out if what == "lint" else args.cost_out
    if out:
        report.dump(out)
    print(report.summary())
    if not report.ok:
        raise SystemExit(1)
    return report


def main(argv=None):
    """Run the CLI; returns the RunResult (one pattern), the SuiteStats,
    or the --lint / --cost report."""
    import sys
    ap = _parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    given = _given(ap, argv)
    if args.lint is not None and args.cost is not None:
        ap.error("--lint and --cost are separate audits: pass one")
    if args.lint is not None or args.cost is not None:
        return _audit(ap, args, given)
    for opt in ("lint_out", "cost_out"):
        if opt in given:
            ap.error(f"--{opt.replace('_', '-')} requires "
                     f"--{opt.split('_')[0]} SUITE")
    if args.runs < 1:
        ap.error("--runs must be >= 1 (min-of-K timing needs a run)")
    if args.stream_r and not args.json:
        ap.error("--stream-r only applies to --json suite mode")
    from .serve.schema import parse_mesh
    try:
        mesh = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(f"--mesh: {e}")
    if mesh and not args.json:
        ap.error("--mesh only applies to --json suite mode")
    if mesh and args.no_batch:
        ap.error("--mesh requires the bucketed planner (drop --no-batch)")
    from .engine import GSEngine
    from .pattern import load_suite, make_pattern
    from .suite import run_suite

    if args.json:
        patterns = load_suite(args.json)
        placements = None
        if mesh:
            from .plan import SuitePlan, device_pool, resolve_mesh
            try:
                placements = resolve_mesh(
                    SuitePlan.build(patterns), mesh, backend=args.backend,
                    row_width=args.row_width,
                    devices=device_pool(args.device))
            except ValueError as e:
                ap.error(f"--mesh: {e}")
        stats = run_suite(patterns, backend=args.backend,
                          runs=args.runs, row_width=args.row_width,
                          mode=args.mode, stream_r=args.stream_r,
                          batch=not args.no_batch, device=args.device,
                          mesh=placements)
        device = stats.results[0].device
        print(f"device: {device}")
        print(f"{'name':24s} {'type':16s} {'GB/s':>10s} "
              f"{'modeled(h100)':>13s} {'sector_eff':>10s}")
        for r in stats.results:
            print(f"{r.pattern.name:24s} {r.pattern.classify():16s} "
                  f"{r.measured_gbs:10.2f} {r.modeled_gbs:13.1f} "
                  f"{r.sector_efficiency:10.3f}")
        print(f"\nsuite: min {stats.min_gbs:.2f}  max {stats.max_gbs:.2f}  "
              f"harmonic-mean {stats.hmean_gbs:.2f} GB/s measured   "
              f"(paper §3.5)")
        if stats.stream_gbs is not None:
            print(f"stream: {stats.stream_gbs:.2f} GB/s reference   "
                  f"Pearson R={stats.stream_r:.3f} measured vs "
                  f"modeled(h100) (paper Eq. 1)")
        if stats.plan is not None:
            waste = stats.plan.pad_waste_for(
                placements or [None] * stats.plan.n_buckets)
            print(f"plan : {len(stats.results)} patterns -> "
                  f"{stats.plan.n_buckets} shape buckets "
                  f"(pad waste {waste:.1%})")
        if placements is not None:
            for b, pl in zip(stats.plan.buckets, placements):
                print(f"mesh : {b.spec.kind} lanes {b.spec.idx_len} "
                      f"footprint {b.spec.footprint} x{len(b.members)}: "
                      f"{pl.placement if pl else 'single'}")
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
    print(f"model    : {r.modeled_gbs:.1f} GB/s modeled(h100), sector "
          f"efficiency {r.sector_efficiency:.3f}")
    return r


if __name__ == "__main__":
    main()
