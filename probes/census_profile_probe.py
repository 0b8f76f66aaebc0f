#!/usr/bin/env python3
"""Does torch.profiler see every kernel a lint census launches, and does
that change once the process has traced heavy work?  Takes the census of
each hopper bucket of demo and of the CLI gather (``repro_torch.analysis.
lint.lint_plan``) with each census under its own torch.profiler session,
and prints, a census: its launches, the Spatter kernels the trace holds,
and how many device records the trace holds in all (the zero operands'
fill kernels, then the bucket's kernel).  Rounds: fresh, again, after
``chip_smoke.gather_times`` (phase 4's profiled gathers) and after
``chip_smoke.profile_serve`` (falcon-mamba-7b's traced prefill and
decode).

    python3 probes/census_profile_probe.py   # on a machine with the card and nvcc
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402


def census_round(torch, tag, pats):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis import census as C
    from repro_torch.analysis import lint
    real, rows = C.of_key, []

    def recorded(key, fn, **kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cz = real(key, fn, **kw)
        n_device = sum(e.device_type.name == "CUDA" for e in prof.events())
        rows.append((dict(cz.launches), c._profiled_kernels(prof),
                     n_device))
        return cz
    C.of_key = recorded
    t0 = time.perf_counter()
    try:
        for p in pats:
            lint.lint_plan(p, backend="hopper", device="cuda:0")
    finally:
        C.of_key = real
    print(f"== {tag} ({time.perf_counter() - t0:.2f} s)", flush=True)
    for launched, seen, n_device in rows:
        print(f"  census {launched}  trace {seen}  device records "
              f"{n_device}", flush=True)


def main():
    torch = c.setup()
    c.build()
    from repro_torch import load_suite
    from repro_torch.pattern import Pattern
    pats = (load_suite(str(ROOT / "suites" / "demo.json")),
            [Pattern.from_json(c._cli_doc("Gather"))])
    census_round(torch, "fresh", pats)
    census_round(torch, "again", pats)
    c.gather_times(torch)
    census_round(torch, "after gather_times", pats)
    c.profile_serve(torch)
    census_round(torch, "after profile_serve", pats)


if __name__ == "__main__":
    main()
