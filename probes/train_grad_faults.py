"""Show that phase 19's one-step check catches a faulty flash backward.

Takes ``chip_smoke.grad_readings`` (one step of llama3-8b at full width and
``TRAIN_CHECK``'s 2 layers, through the plain attention and through the
kernels) with the backward kernel as built, and with faults planted at run
time around that same kernel (no source is changed):

  * ``dk_one_head``: dK from the first query head of each group only (the
    kernel at G 1 on that head's q, out, dO and lse), as if the dK/dV pass
    summed one of the G heads;
  * ``dq_unscaled``: dQ without its softmax scale;
  * ``no_delta``: D = rowsum(dO o O) taken as 0 (the kernel given O = 0);
  * ``causal_off``: the backward without the causal mask;
  * ``dk_1pct``, ``dv_1pct``: dK or dV 1% too large, the limits'
    resolution.

Prints each run's readings against ``chip_smoke.grad_faults``'s limits and
writes them all, per leaf, to ``chiprun_out/train_grad_faults.json``.

    python3 probes/train_grad_faults.py        # on the card, ~2 min

Exit 0 when the kernel as built passes and every planted fault fails.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    import chip_smoke as c
    torch = c.setup()
    c.build()
    from repro_torch.kernels.flash_attention import ops
    real = ops.flash_attention_bwd

    def one_head(t):
        return t[:, :, :1].contiguous()

    def dk_one_head(q, k, v, o, lse, do, *, scale, causal):
        dq, _, dv = real(q, k, v, o, lse, do, scale=scale, causal=causal)
        _, dk, _ = real(one_head(q), k, v, one_head(o), one_head(lse),
                        one_head(do), scale=scale, causal=causal)
        return dq, dk, dv

    def dq_unscaled(q, k, v, o, lse, do, *, scale, causal):
        dq, dk, dv = real(q, k, v, o, lse, do, scale=scale, causal=causal)
        return dq / scale, dk, dv

    def no_delta(q, k, v, o, lse, do, *, scale, causal):
        return real(q, k, v, torch.zeros_like(o), lse, do, scale=scale,
                    causal=causal)

    def causal_off(q, k, v, o, lse, do, *, scale, causal):
        return real(q, k, v, o, lse, do, scale=scale, causal=False)

    def dk_1pct(q, k, v, o, lse, do, *, scale, causal):
        dq, dk, dv = real(q, k, v, o, lse, do, scale=scale, causal=causal)
        return dq, dk * 1.01, dv

    def dv_1pct(q, k, v, o, lse, do, *, scale, causal):
        dq, dk, dv = real(q, k, v, o, lse, do, scale=scale, causal=causal)
        return dq, dk, dv * 1.01

    faults = [dk_one_head, dq_unscaled, no_delta, causal_off, dk_1pct,
              dv_1pct]
    readings = c.grad_readings(
        torch, [("kernel", None)] + [(f.__name__, f) for f in faults])
    print(f"limits: loss {c.TRAIN_LOSS_RTOL:.2e}, gradient "
          f"{c.TRAIN_GRAD_RTOL:.2e}, its norm {c.TRAIN_NORM_RTOL:.2e} "
          f"(relative)", flush=True)
    verdicts = {}
    for name, r in readings.items():
        worst = {key: max(r[key], key=r[key].get)
                 for key in ("norm_rel", "diff_rel")}
        bad = c.grad_faults(r)
        verdicts[name] = bad
        print(f"{name}: loss {r['loss_rel']:.3e} apart; gradient "
              f"{r['diff_rel'][worst['diff_rel']]:.3e} ({worst['diff_rel']})"
              f", its norm {r['norm_rel'][worst['norm_rel']]:.3e} "
              f"({worst['norm_rel']}) -> "
              f"{'FAILS: ' + '; '.join(bad) if bad else 'passes'}",
              flush=True)
    out = ROOT / "chiprun_out" / "train_grad_faults.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(readings, indent=1))
    caught = sum(bool(verdicts[f.__name__]) for f in faults)
    sound = not verdicts["kernel"]
    print(f"the kernel as built {'passes' if sound else 'FAILS'}; {caught} "
          f"of {len(faults)} planted faults fail", flush=True)
    ok = sound and caught == len(faults)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
