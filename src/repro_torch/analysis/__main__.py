"""spatterlint / spattercost matrix runner on the port —
``python -m repro_torch.analysis``.

Default (lint) mode audits every (suite x placement x backend) cell, each
bucket from the census of one call on zero operands, plus the serving
layer's ast lint; writes one merged JSON report and exits non-zero on any
violation::

    PYTHONPATH=src python -m repro_torch.analysis --device cpu \\
        --devices 'cpu*8' --suite suites/demo.json --suite suites/apps.json \\
        --suite suites/widelane.json \\
        --mesh 0 --mesh 1x1 --mesh 8x1 --mesh 4x2 --mesh 1x8 \\
        --out LINT_report.json

On the card leave out ``--device`` (it is ``cuda``) and give
``--devices 'cuda:0*8'`` to hold eight shards on one card.  ``--cost``
switches to the traffic matrix (``analysis.cost``); ``--write-baseline
FILE`` also freezes each unit's predicted I/O bytes as the
``cost-regression`` gate's baseline (the committed one is
``COST_baseline_torch.json``, written by the command above with ``--cost
--write-baseline COST_baseline_torch.json``).

A cell that needs more devices than ``--devices`` lists is exit 2, not a
skip: a matrix that audited less must not read as clean.
"""
from __future__ import annotations

import argparse
import sys


def parse_devices(spec: str) -> list[str]:
    """``"cuda:0*8"`` -> eight ``cuda:0``; ``"cpu,cpu"`` -> two ``cpu``:
    a comma list, each entry with an optional ``*N`` repeat."""
    out = []
    for part in spec.split(","):
        name, _, n = part.strip().partition("*")
        if not name or (n and not n.isdigit()):
            raise ValueError(f"--devices: bad entry {part!r} (DEV or DEV*N)")
        out.extend([name] * (int(n) if n else 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="spatterlint/spattercost on the port: audit the "
                    "planner's bucket callables over a suite x placement "
                    "matrix")
    ap.add_argument("--suite", action="append", default=[], metavar="FILE",
                    help="suites/*.json file (repeatable)")
    ap.add_argument("--mesh", action="append", default=[],
                    metavar="N|BxL|auto",
                    help="placement cell: 0 (one device), N, BxL, auto "
                         "(per bucket) or auto-suite; repeatable; default "
                         "0 only")
    ap.add_argument("--backend", action="append", default=[],
                    choices=["torch", "onehot", "scalar", "hopper"],
                    help="backend(s) to audit (default: torch + hopper)")
    ap.add_argument("--mode", default="store", choices=["store", "add"])
    ap.add_argument("--device", default="cuda",
                    help="device of unplaced launches (default cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--devices", default=None, metavar="DEV[*N],...",
                    help="devices placements are laid over, repeats "
                         "allowed (default: the CUDA devices, or the one "
                         "CPU)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the merged JSON report here")
    ap.add_argument("--no-serve-lint", action="store_true",
                    help="skip the repro_torch/serve ast concurrency lint")
    ap.add_argument("--cost", action="store_true",
                    help="run the spattercost traffic matrix instead")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="--cost: freeze each unit's predicted I/O bytes "
                         "to FILE, the cost-regression rule's baseline")
    args = ap.parse_args(argv)
    if args.write_baseline and not args.cost:
        ap.error("--write-baseline requires --cost")
    if args.cost and args.no_serve_lint:
        ap.error("--no-serve-lint does not apply to --cost (the traffic "
                 "matrix has no serve lint)")
    if args.cost and not args.suite:
        ap.error("--cost needs at least one --suite FILE")
    if not args.suite and args.no_serve_lint:
        ap.error("nothing to lint: pass --suite and/or drop "
                 "--no-serve-lint")

    from ..serve.schema import parse_mesh
    try:
        devices = (parse_devices(args.devices) if args.devices is not None
                   else None)
        meshes = [parse_mesh(m) for m in args.mesh] or [0]
    except ValueError as e:
        ap.error(str(e))
    backends = tuple(args.backend) or ("torch", "hopper")
    kw = dict(backends=backends, mode=args.mode, device=args.device,
              devices=devices)

    if args.cost:
        from .cost import CostReport, cost_suite_file, write_baseline
        report = CostReport()
        try:
            for suite in args.suite:
                for mesh in meshes:
                    report = report.merge(cost_suite_file(
                        suite, mesh=mesh or None, **kw))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.write_baseline:
            # one key may come from several cells; its bytes are a pure
            # function of the key, so the cells agree
            units = {u.exec_key: u.io_bytes for u in report.units}
            write_baseline(units, args.write_baseline,
                           meta={"suites": args.suite,
                                 "meshes": args.mesh or ["0"],
                                 "backends": list(backends)})
            print(f"baseline: {args.write_baseline} ({len(units)} unit(s))")
    else:
        from .lint import lint_serve, lint_suite_file
        from .report import LintReport
        report = LintReport()
        if not args.no_serve_lint:
            report = report.merge(lint_serve())
        try:
            for suite in args.suite:
                for mesh in meshes:
                    report = report.merge(lint_suite_file(
                        suite, mesh=mesh or None, **kw))
        except ValueError as e:
            # a cell that cannot be built (more devices than listed, a bad
            # suite) fails loudly: a skipped cell is not a clean cell
            print(f"error: {e}", file=sys.stderr)
            return 2

    if args.out:
        report.dump(args.out)
    print(report.summary())
    if args.out:
        print(f"report: {args.out}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
