"""Batched serving: prefill, then greedy token-by-token decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --device cpu --batch 2 --prompt-len 8 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --layers 7 --gs-backend hopper   # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \\
        --batch 2 --prompt-len 8192 --gen 32 --gs-backend hopper  # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --batch 4 --prompt-len 8192 --gen 32 --gs-backend hopper  # the card
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch starcoder2-15b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --batch 2 --prompt-len 8192 --gen 32 \\
        --gs-backend hopper                                      # the card
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch kimi-k2-1t-a32b --layers 2 --batch 4 --prompt-len 2048 \\
        --gen 32 --gs-backend hopper                             # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
        --batch 16 --prompt-len 6000 --gen 32 --gs-backend hopper  # the card
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch internvl2-26b --batch 4 --prompt-len 2048 --gen 32  # the card

The port of ``repro/launch/serve.py`` for the ported architectures.  The
weights are random, drawn on the device from a ``torch.Generator`` seeded
by ``--seed``; the prompts are the same numpy draws as there.  The
prefill returns the decode cache itself, with room for ``prompt_len +
gen`` positions (``Model.prefill``; a dense model's KV cache is paged, its
page table drawn from ``--seed``; a mamba or RG-LRU layer keeps its final
state), so decode starts at position
``prompt_len`` with no splice.  ``--device`` defaults to
``cuda`` and raises without it; ``--device cpu`` runs the kernels' plain
versions.  ``--gs-backend`` (default ``torch``) is the backend of the
indexed ops (the embedding gather, the MoE dispatch's gathers and
scatter-adds; the JAX package's ``gs_backend``): ``hopper`` runs the
hand-written row kernels.  ``--layers N`` cuts the depth to N layers at
the published width (deepseek-v2-236b's 60 layers hold 471 GB in
bfloat16, six cards' memory; 7 layers, 50 GB, fit one; kimi-k2-1t-a32b's
61 hold 2.05 TB, and 2, its dense layer and one MoE layer, 39.9 GB).
``run`` serves a config object, so a caller may cut it otherwise.

whisper-base (the ``audio`` family) follows the JAX driver: the prompt
stands for ``prompt_len // frame_ratio`` frames, stub embeddings drawn
from ``--seed`` at scale 0.01 after the prompts, which the prefill encodes
(it yields no logits); decoding starts from BOS (token 1) at position 0,
with room for ``prompt_len + gen`` decoder positions, so ``logits`` holds
the ``gen`` steps' only and ``tokens[:, 0]`` is BOS.  Times are host
clocks around work that ends in a device synchronise.

internvl2-26b (the ``vlm`` family): the JAX driver never passes image
embeddings (``repro/launch/serve.py:57-59``), so the CLI serves its text
only, as there.  ``run(..., images=True)`` is no flag and no part of
the JAX driver: it is the hook through which ``chip_smoke.py``'s phase 18
serves images in the same timed and counted window as every other
model.  It puts ``n_img_tokens`` stub embeddings drawn from ``--seed``
after the prompts (N(0, 1), the scale of the table's rows) before each
prompt: the cache has room for n_img + prompt_len + gen positions and
decoding starts at n_img + prompt_len.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..backends import BACKENDS
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
    gs_backend: str
    prefill_ms: float
    decode_ms: float                 # all ``gen`` decode steps
    tok_s: float                     # batch * gen / decode time
    weight_bytes: int
    prompts: torch.Tensor            # (B, prompt_len), on the device
    tokens: torch.Tensor             # (B, gen + 1): [:, 0] from the prefill
    logits: torch.Tensor             # (B, gen + 1, V): prefill, each step
                                     # (audio: BOS, then (B, gen, V))
    launches_prefill: dict           # kernel launches during the prefill
    launches_decode: dict            # and during the decode steps
    model: Model
    params: torch.nn.Module
    frames: torch.Tensor | None = None   # audio: the (B, F, d) stub frames
    img_embeds: torch.Tensor | None = None   # vlm: the (B, n_img, d) ones


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
    ap.add_argument("--gs-backend", default="torch", choices=BACKENDS,
                    help="backend of the embedding gather and the MoE "
                         "dispatch; hopper: the hand-written row kernels")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's)")
    return ap


def _delta(before: dict) -> dict:
    return {k: launches[k] - before[k] for k in launches}


def main(argv=None, images: bool = False) -> ServeResult:
    """The CLI; ``images`` as for ``run``."""
    args = _parser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return run(cfg, args.batch, args.prompt_len, args.gen, args.seed,
               args.device, args.gs_backend, images)


def run(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
        device=None, gs_backend: str = "torch",
        images: bool = False) -> ServeResult:
    """Draw ``cfg``'s weights from ``seed`` on ``device`` (default cuda),
    prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen`` greedy steps, the indexed ops on ``gs_backend``; ``images``
    (a ``vlm`` config only) puts stub image embeddings before each
    prompt."""
    dev = resolve_device(device)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    b, plen = batch, prompt_len
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab, (b, plen))).to(dev)
    audio = cfg.family == "audio"
    if audio:
        frames = torch.from_numpy(0.01 * rng.standard_normal(
            (b, plen // cfg.frame_ratio, cfg.d_model))).to(
                dev, params.embed.table.dtype)
    if images and cfg.family != "vlm":
        raise ValueError(f"{cfg.arch_id} takes no images")
    img = (torch.from_numpy(rng.standard_normal(
        (b, cfg.n_img_tokens, cfg.d_model))).to(dev, params.embed.table.dtype)
        if images else None)
    n_img = 0 if img is None else img.shape[1]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- prefill ---------------------------------------------------------------
    sync()
    before = dict(launches)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, frames if audio else prompts,
                                  max_len=n_img + plen + gen, seed=seed,
                                  gs_backend=gs_backend, img_embeds=img)
    sync()
    t_prefill = time.perf_counter() - t0
    launches_prefill = _delta(before)
    print(f"[serve] prefill: {b}x{plen} in {t_prefill * 1e3:.1f} ms")

    # -- decode ----------------------------------------------------------------
    if audio:                      # BOS at position 0: no prefill logits
        tok = torch.ones((b, 1), dtype=torch.int64, device=dev)
        all_logits, start = [], 0
    else:
        tok = logits.argmax(-1, keepdim=True)               # (B, 1)
        all_logits, start = [logits], n_img + plen
    all_tokens = [tok]
    before = dict(launches)
    t0 = time.perf_counter()
    for i in range(gen):
        logits, cache = model.decode_step(params, cache, tok, start + i,
                                          gs_backend=gs_backend)
        tok = logits.argmax(-1, keepdim=True)
        all_logits.append(logits)
        all_tokens.append(tok)
    sync()
    t_dec = time.perf_counter() - t0
    launches_decode = _delta(before)
    toks_s = b * gen / t_dec if t_dec > 0 else float("inf")
    tokens = torch.cat(all_tokens, dim=1)
    print(f"[serve] decode: {gen} steps x batch {b} in "
          f"{t_dec * 1e3:.1f} ms  ({toks_s:.1f} tok/s)")
    print("[serve] sample:", tokens[0, 1:13].tolist())
    return ServeResult(
        arch=cfg.arch_id, device=str(dev), batch=b, prompt_len=plen,
        gen=gen, gs_backend=gs_backend, prefill_ms=t_prefill * 1e3,
        decode_ms=t_dec * 1e3, tok_s=toks_s,
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in params.parameters()),
        prompts=prompts, tokens=tokens, logits=torch.stack(all_logits, 1),
        launches_prefill=launches_prefill, launches_decode=launches_decode,
        model=model, params=params, frames=frames if audio else None,
        img_embeds=img)


if __name__ == "__main__":
    main()
