"""End-to-end training driver: pipeline -> train step -> supervisor.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --device cpu --steps 30 --batch 8 --seq 32 \\
        --ckpt-dir "$(mktemp -d)"
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --layers 8 --batch 4 --seq 4096 --steps 4 --ckpt-every 1000  # card

The port of ``repro/launch/train.py`` with its flags, and ``--device``:
the deterministic ``TokenPipeline`` (a batch is a pure function of
(--seed, i)), ``runtime.train.make_train_step`` (AdamW, the warmup-cosine
schedule over --steps, global-norm clipping), and ``TrainSupervisor``
(async checkpoints every --ckpt-every steps into --ckpt-dir, crash
restart from the latest, the straggler log, a checkpoint on SIGTERM).
Weights are drawn on the device from a ``torch.Generator`` seeded by
--seed.  ``--device`` defaults to ``cuda`` and raises without it; ``cpu``
runs the kernels' plain versions.  On CUDA every attention layer's
forward and backward runs the hand-written flash kernels (printed as
launch counts); a ``vlm`` model trains on zero image embeddings and an
``audio`` one on frames of 0.01 (seq / frame_ratio a row), as the JAX
driver does.  The embedding and any MoE dispatch go through the
``torch`` backend (the row kernels have no backward).  A step's metrics
are read back to the host, so its wall time includes the device's work.
``run`` takes the parsed flags and returns a ``TrainResult``: the
supervisor's step stats, each step's metrics (loss, grad_norm, step),
the stragglers and the run's kernel launches.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data import TokenPipeline
from ..engine import resolve_device
from ..kernels import launches
from ..models.zoo import Model, count_params
from ..optim import AdamWConfig, init_opt_state, warmup_cosine
from ..runtime.supervisor import SupervisorConfig, TrainSupervisor
from ..runtime.train import make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M param runs)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the kernels' plain versions")
    return ap


def config(args):
    """The config the flags name, its width or depth cut as they say."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
        overrides["d_ff"] = args.d_model * 4
        overrides["head_dim"] = max(16, args.d_model // max(1, cfg.n_heads))
    if args.layers:
        overrides["n_layers"] = args.layers
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


@dataclasses.dataclass
class TrainResult:
    stats: list                   # the supervisor's StepStats, one a step run
    metrics: list[dict]           # each step's loss, grad_norm and step
    straggler_events: list[int]
    launches: dict                # kernel launches during the run


def run(args) -> TrainResult:
    """Train as the flags say."""
    cfg = config(args)
    dev = resolve_device(args.device)
    model = Model(cfg)
    opt_cfg = AdamWConfig(
        lr=warmup_cosine(args.lr, warmup=max(10, args.steps // 20),
                         total=args.steps))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    n_params = count_params(cfg)
    print(f"[train] arch={cfg.arch_id} params={n_params / 1e6:.1f}M "
          f"device={dev} steps={args.steps}", flush=True)

    def make_batch(i):
        b = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(i).items()}
        dtype = getattr(torch, cfg.dtype)
        if cfg.family == "audio":
            b["frames"] = torch.full(
                (args.batch, args.seq // cfg.frame_ratio, cfg.d_model), 0.01,
                dtype=dtype, device=dev)
        if cfg.family == "vlm":
            b["img_embeds"] = torch.zeros(
                (args.batch, cfg.n_img_tokens, cfg.d_model), dtype=dtype,
                device=dev)
        return b

    step_core = make_train_step(model, opt_cfg,
                                microbatches=args.microbatches)
    history = []                  # each step's metrics, restarts included

    def build(ckpt_mgr):
        lm = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev, trainable=True)
        params = dict(lm.named_parameters())
        opt = init_opt_state(params)
        start = 0
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            restored = ckpt_mgr.restore(latest, {"params": params,
                                                 "opt": opt})
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(restored["params"][k])
            opt = restored["opt"]
            start = latest
            print(f"[train] RESUMING from checkpoint step {latest} in "
                  f"{ckpt_mgr.ckpt.dir} ({max(0, args.steps - latest)} of "
                  f"{args.steps} steps left; a fresh --ckpt-dir starts "
                  "over)", flush=True)

        def step_fn(state, i):
            # the state's params are lm's own tensors: the step updates
            # them, and the moments, in place
            _, opt_, metrics = step_core(lm, state["opt"], make_batch(i))
            # reading the metrics waits for the step's device work
            metrics = {k: float(v) for k, v in metrics.items()}
            history.append(metrics)
            return {"params": state["params"], "opt": opt_}, metrics

        return {"params": params, "opt": opt}, step_fn, start

    sup = TrainSupervisor(SupervisorConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every))
    before = dict(launches)
    sup.run(build, args.steps)
    res = TrainResult(sup.stats, history, sup.straggler_events,
                      {k: launches[k] - before[k] for k in launches})
    losses = [s.loss for s in sup.stats]
    if losses:
        k = max(1, len(losses) // 10)
        print(f"[train] loss first-{k}-mean {np.mean(losses[:k]):.4f} -> "
              f"last-{k}-mean {np.mean(losses[-k:]):.4f}  "
              f"stragglers={len(sup.straggler_events)}", flush=True)
    if dev.type == "cuda":
        ran = {k: v for k, v in res.launches.items() if v}
        print(f"[train] kernel launches {ran}", flush=True)
    sup.ckpt.close()
    return res


def main(argv=None) -> TrainResult:
    return run(_parser().parse_args(argv))


if __name__ == "__main__":
    main()
