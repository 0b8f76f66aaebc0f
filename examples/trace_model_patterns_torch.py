"""Extract Spatter patterns from a model served by the port: the paper's §2
on PyTorch.

The paper traced DoE mini-apps through an instrumented QEMU to harvest
their gather/scatter patterns (Table 5).  Here one forward of a model's
smoke config (float32, random weights from seed 0) is traced
(``repro_torch.tracing.trace_gs``): every gather and scatter, through the
port's backends or aten's indexed ops, with its byte volume (Table 1's
"G/S MB (%)" column), distilled into replayable patterns, which the
engine then runs on the hand-written kernels (``hopper``; on the CPU
their plain versions), each scatter in its own mode (store or add).

    PYTHONPATH=src python examples/trace_model_patterns_torch.py [arch] \\
        [--device cuda|cpu]

The port of ``examples/trace_model_patterns.py``; ``--device`` defaults
to ``cuda`` and raises without a card.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import dump_suite, run_suite
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.zoo import Model
from repro_torch.tracing import trace_gs

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="deepseek-v2-236b",
                choices=ARCH_IDS)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
cfg = dataclasses.replace(get_smoke_config(args.arch), dtype="float32")
lm = Model(cfg).init(device=args.device)
tokens = torch.from_numpy(np.random.default_rng(0).integers(
    2, cfg.vocab, (2, 64))).to(args.device)

print(f"=== tracing {cfg.arch_id} (reduced config) forward pass ===")
report = trace_gs(lambda t: T.forward(cfg, lm, t, gs_backend="hopper"),
                  tokens)
print(report.summary())

print("\n=== distilled Spatter patterns (replayable) ===")
accesses = [a for a in report.accesses if a.n_lookups > 0][:6]
print(dump_suite([a.to_pattern() for a in accesses]))

print("\n=== replaying them through the engine ===")
for mode in ("store", "add"):           # a scatter replays in its own mode
    patterns = [a.to_pattern() for a in accesses if a.mode == mode]
    if not patterns:
        continue
    stats = run_suite(patterns, backend="hopper", runs=2, mode=mode,
                      device=args.device)
    for r in stats.results:
        print(f"{r.pattern.name:24s} {mode:5s} rows={r.pattern.count:<8} "
              f"row_elems={r.pattern.index_len:<6} "
              f"{r.measured_gbs:6.2f} GB/s")
