"""Fault-tolerance demo on the port: train, checkpoint, crash, resume.

    PYTHONPATH=src python examples/train_ft_demo_torch.py --device cpu
    PYTHONPATH=src python examples/train_ft_demo_torch.py --d-model 512

Trains the llama3-8b smoke config (float32, no remat) on the synthetic
pipeline, simulates a node failure at step 25 (a raised exception), and
shows the supervisor restoring from the latest async checkpoint (step 20,
or 10 while 20's write is in flight) and continuing to a lower loss: ``examples/train_ft_demo.py`` on the
PyTorch port.  Without ``--device`` it runs on the card, where the flash
kernels' backward takes head size 128 only: ``--d-model 512`` widens the
smoke config through ``launch.train.config``, as that driver's flag does
(4 heads of 128, d_ff 2048).
"""
import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.data import TokenPipeline
from repro_torch.engine import resolve_device
from repro_torch.launch.train import config
from repro_torch.models.zoo import Model
from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
from repro_torch.runtime.supervisor import SupervisorConfig, TrainSupervisor
from repro_torch.runtime.train import make_train_step

STEPS = 60
CRASH_AT = 25


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--d-model", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        config(argparse.Namespace(arch="llama3-8b", smoke=True, layers=0,
                                  d_model=args.d_model)),
        dtype="float32", remat="none")
    model = Model(cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    opt_cfg = AdamWConfig(lr=warmup_cosine(3e-3, warmup=5, total=STEPS),
                          weight_decay=0.0)
    core = make_train_step(model, opt_cfg)
    crash = {"armed": True, "restored_from": None}

    def build(ckpt):
        lm = model.init(torch.Generator(device=dev).manual_seed(0), dev,
                        trainable=True)
        params = dict(lm.named_parameters())
        opt = init_opt_state(params)
        start = ckpt.latest_step() or 0
        if start:
            restored = ckpt.restore(start, {"params": params, "opt": opt})
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(restored["params"][k])
            opt = restored["opt"]
            crash["restored_from"] = start
            print(f"--- restored from checkpoint step {start} ---")

        def step_fn(state, i):
            if i == CRASH_AT and crash["armed"]:
                crash["armed"] = False
                raise RuntimeError(f"simulated node failure at step {i}")
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch(i).items()}
            _, o, m = core(lm, state["opt"], batch)
            return ({"params": state["params"], "opt": o},
                    {k: float(v) for k, v in m.items()})

        return {"params": params, "opt": opt}, step_fn, start

    with tempfile.TemporaryDirectory() as d:
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=d, ckpt_every=10,
                                               max_restarts=2))
        sup.run(build, STEPS)
        losses = [s.loss for s in sup.stats]
        print(f"\nfirst-5 loss {np.mean(losses[:5]):.3f} -> "
              f"last-5 loss {np.mean(losses[-5:]):.3f} "
              f"(crash + restore happened mid-run; stragglers logged: "
              f"{len(sup.straggler_events)})")
        sup.ckpt.close()
    # the latest checkpoint on disk at the crash: step 20's, or step 10's
    # where step 20's asynchronous write was still in flight
    assert crash["restored_from"] in (10, 20), crash
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "did not learn"
    print("FT demo OK")
    return sup, crash


if __name__ == "__main__":
    main()
