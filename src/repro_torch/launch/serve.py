"""Batched serving: prefill, then greedy token-by-token decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --device cpu --batch 2 --prompt-len 8 --gen 4

The port of ``repro/launch/serve.py`` for the ported architectures.  The
weights are random, drawn on the device from a ``torch.Generator`` seeded
by ``--seed``; the prompts are the same numpy draws as there.  The
prefill returns the decode cache itself, with room for ``prompt_len +
gen`` positions (``Model.prefill``; a dense model's KV cache is paged, its
page table drawn from ``--seed``), so decode starts at position
``prompt_len`` with no splice.  ``--device`` defaults to
``cuda`` and raises without it; ``--device cpu`` runs the kernels' plain
versions.  Times are host clocks around work that ends in a device
synchronise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..engine import resolve_device
from ..kernels import launches
from ..models.zoo import Model


@dataclasses.dataclass
class ServeResult:
    arch: str
    device: str
    batch: int
    prompt_len: int
    gen: int
    prefill_ms: float
    decode_ms: float                 # all ``gen`` decode steps
    tok_s: float                     # batch * gen / decode time
    weight_bytes: int
    prompts: torch.Tensor            # (B, prompt_len), on the device
    tokens: torch.Tensor             # (B, gen + 1): [:, 0] from the prefill
    logits: torch.Tensor             # (B, gen + 1, V): prefill, each step
    launches_prefill: dict           # kernel launches during the prefill
    launches_decode: dict            # and during the decode steps
    model: Model
    params: torch.nn.Module


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the kernels' plain versions")
    return ap


def _delta(before: dict) -> dict:
    return {k: launches[k] - before[k] for k in launches}


def main(argv=None) -> ServeResult:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    rng = np.random.default_rng(args.seed)
    b, plen = args.batch, args.prompt_len
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab, (b, plen))).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- prefill ---------------------------------------------------------------
    sync()
    before = dict(launches)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, max_len=plen + args.gen,
                                  seed=args.seed)
    sync()
    t_prefill = time.perf_counter() - t0
    launches_prefill = _delta(before)
    print(f"[serve] prefill: {b}x{plen} in {t_prefill * 1e3:.1f} ms")

    # -- decode ----------------------------------------------------------------
    tok = logits.argmax(-1, keepdim=True)                   # (B, 1)
    all_logits, all_tokens = [logits], [tok]
    before = dict(launches)
    t0 = time.perf_counter()
    for i in range(args.gen):
        logits, cache = model.decode_step(params, cache, tok, plen + i)
        tok = logits.argmax(-1, keepdim=True)
        all_logits.append(logits)
        all_tokens.append(tok)
    sync()
    t_dec = time.perf_counter() - t0
    launches_decode = _delta(before)
    toks_s = b * args.gen / t_dec if t_dec > 0 else float("inf")
    tokens = torch.cat(all_tokens, dim=1)
    print(f"[serve] decode: {args.gen} steps x batch {b} in "
          f"{t_dec * 1e3:.1f} ms  ({toks_s:.1f} tok/s)")
    print("[serve] sample:", tokens[0, 1:13].tolist())
    return ServeResult(
        arch=cfg.arch_id, device=str(dev), batch=b, prompt_len=plen,
        gen=args.gen, prefill_ms=t_prefill * 1e3, decode_ms=t_dec * 1e3,
        tok_s=toks_s,
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in params.parameters()),
        prompts=prompts, tokens=tokens, logits=torch.stack(all_logits, 1),
        launches_prefill=launches_prefill, launches_decode=launches_decode,
        model=model, params=params)


if __name__ == "__main__":
    main()
