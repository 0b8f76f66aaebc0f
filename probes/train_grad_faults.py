"""Show that phase 19's and phase 20's one-step checks catch a faulty flash
backward.

Takes ``chip_smoke.grad_readings`` (one step at full width through the
plain attention and through the kernels: llama3-8b at ``TRAIN_CHECK``'s 2
layers, or with ``--arch gemma2-27b`` at ``GEMMA2_TRAIN_CHECK``'s, one
local and one global layer, window 4,096 and softcap 50) with the
backward kernel as built, and with faults planted at run time around that
same kernel (no source is changed):

  * ``dk_one_head``: dK from the first query head of each group only (the
    kernel at G 1 on that head's q, out, dO and lse), as if the dK/dV pass
    summed one of the G heads;
  * ``dq_unscaled``: dQ without its softmax scale;
  * ``no_delta``: D = rowsum(dO o O) taken as 0 (the kernel given O = 0);
  * ``causal_off``: the backward without the causal mask;
  * ``dk_1pct``, ``dv_1pct``: dK or dV 1% too large, the limits'
    resolution;

and for gemma2-27b also

  * ``no_cap_factor``: dS not multiplied by the softcap's derivative 1 -
    (s / c)^2 (the plain version's equations without it, a (row, KV head)
    at a time);
  * ``window_off``: the backward without the window (the kernel given
    window 0 and the windowed forward's lse);
  * ``keyless_p_one``: P = 1 instead of 1 / T for a row that the window
    leaves no key, as a kernel copying P = exp(s - lse) would give it
    (lse = -1e30): dV gains (T - 1) / T of those rows' dO.  A causal
    self-attention has no such row (row i sees key i), so the step cannot
    show this fault; it is run through phase 1's backward cases with such
    rows (``flash_bwd_option_checks``), each of which must fail;
  * ``keyless_lse``: the lse instance's lse of those rows ln T instead of
    -1e30 (the backward, whose mask decides there, does not read it): run
    through the same cases, each of which must fail.

Prints each run's readings against ``chip_smoke.grad_faults``'s limits
(phase 19's, or ``GEMMA2_TRAIN_LIMITS``) and writes them all, per leaf, to
``chiprun_out/train_grad_faults[_gemma2-27b].json``.

    python3 probes/train_grad_faults.py [--arch gemma2-27b]  # the card

Exit 0 when the kernel as built passes and every planted fault fails.
"""
import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b",
                    choices=("llama3-8b", "gemma2-27b"))
    args = ap.parse_args(argv)
    import chip_smoke as c
    torch = c.setup()
    c.build()
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (_masked_scores,
                                                         sees_no_key)
    real = ops.flash_attention_bwd
    real_lse = ops.flash_attention_lse

    def one_head(t):
        return t[:, :, :1].contiguous()

    def dk_one_head(q, k, v, o, lse, do, *, scale, **kw):
        dq, _, dv = real(q, k, v, o, lse, do, scale=scale, **kw)
        _, dk, _ = real(one_head(q), k, v, one_head(o), one_head(lse),
                        one_head(do), scale=scale, **kw)
        return dq, dk, dv

    def dq_unscaled(q, k, v, o, lse, do, *, scale, **kw):
        dq, dk, dv = real(q, k, v, o, lse, do, scale=scale, **kw)
        return dq / scale, dk, dv

    def no_delta(q, k, v, o, lse, do, *, scale, **kw):
        return real(q, k, v, torch.zeros_like(o), lse, do, scale=scale, **kw)

    def causal_off(q, k, v, o, lse, do, *, scale, **kw):
        return real(q, k, v, o, lse, do, scale=scale, **{**kw,
                                                         "causal": False})

    def dk_1pct(q, k, v, o, lse, do, *, scale, **kw):
        dq, dk, dv = real(q, k, v, o, lse, do, scale=scale, **kw)
        return dq, dk * 1.01, dv

    def dv_1pct(q, k, v, o, lse, do, *, scale, **kw):
        dq, dk, dv = real(q, k, v, o, lse, do, scale=scale, **kw)
        return dq, dk, dv * 1.01

    def no_cap_factor(q, k, v, o, lse, do, *, scale, **kw):
        f32 = torch.float32
        out = [torch.empty(x.shape, dtype=f32, device=x.device)
               for x in (q, k, v)]
        for b in range(q.shape[0]):
            for h in range(q.shape[1]):
                qs, ks, vs, os_, dos = (x[b:b + 1, h:h + 1].to(f32)
                                        for x in (q, k, v, o, do))
                s, mask = _masked_scores(qs, ks, scale=scale, **kw)
                p = torch.exp(s - lse[b:b + 1, h:h + 1, ..., None]) * mask
                ds = p * (torch.einsum("bhgqd,bhtd->bhgqt", dos, vs)
                          - (dos * os_).sum(-1, keepdim=True))
                out[0][b:b + 1, h:h + 1] = torch.einsum(
                    "bhgqt,bhtd->bhgqd", ds, ks) * scale
                out[1][b:b + 1, h:h + 1] = torch.einsum(
                    "bhgqt,bhgqd->bhtd", ds, qs) * scale
                out[2][b:b + 1, h:h + 1] = torch.einsum(
                    "bhgqt,bhgqd->bhtd", p, dos)
        return tuple(x.to(q.dtype) for x in out)

    def window_off(q, k, v, o, lse, do, *, scale, **kw):
        return real(q, k, v, o, lse, do, scale=scale, **{**kw, "window": 0})

    def keyless_p_one(q, k, v, o, lse, do, *, scale, **kw):
        dq, dk, dv = real(q, k, v, o, lse, do, scale=scale, **kw)
        t = k.shape[2]
        empty = sees_no_key(q.shape[3], t, kw.get("window", 0), q.device)
        extra = do[..., empty, :].float().sum((2, 3)) * (t - 1) / t
        return dq, dk, (dv.float() + extra[:, :, None]).to(dv.dtype)

    def keyless_lse(q, k, v, **kw):
        o, lse = real_lse(q, k, v, **kw)
        t = k.shape[2]
        lse[..., sees_no_key(q.shape[3], t, kw.get("window", 0),
                             q.device)] = math.log(t)
        return o, lse

    faults = [dk_one_head, dq_unscaled, no_delta, causal_off, dk_1pct,
              dv_1pct]
    shape, limits, tag = c.TRAIN_CHECK, None, ""
    if args.arch == "gemma2-27b":
        faults += [no_cap_factor, window_off]
        shape, limits = c.GEMMA2_TRAIN_CHECK, c.GEMMA2_TRAIN_LIMITS
        tag = "_gemma2-27b"
    readings = c.grad_readings(
        torch, [("kernel", None)] + [(f.__name__, f) for f in faults],
        arch=args.arch, shape=shape)
    loss_rtol, norm_rtol, grad_rtol = limits or (
        c.TRAIN_LOSS_RTOL, c.TRAIN_NORM_RTOL, c.TRAIN_GRAD_RTOL)
    print(f"{args.arch} limits: loss {loss_rtol:.2e}, gradient "
          f"{grad_rtol:.2e}, its norm {norm_rtol:.2e} (relative)",
          flush=True)
    verdicts = {}
    for name, r in readings.items():
        worst = {key: max(r[key], key=r[key].get)
                 for key in ("norm_rel", "diff_rel")}
        bad = c.grad_faults(r, limits)
        verdicts[name] = bad
        print(f"{name}: loss {r['loss_rel']:.3e} apart; gradient "
              f"{r['diff_rel'][worst['diff_rel']]:.3e} ({worst['diff_rel']})"
              f", its norm {r['norm_rel'][worst['norm_rel']]:.3e} "
              f"({worst['norm_rel']}) -> "
              f"{'FAILS: ' + '; '.join(bad) if bad else 'passes'}",
              flush=True)
    out = ROOT / "chiprun_out" / f"train_grad_faults{tag}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(readings, indent=1))
    caught = sum(bool(verdicts[f.__name__]) for f in faults)
    n_faults = len(faults)
    if args.arch == "gemma2-27b":
        n_faults += 2
        caught += keyless_cases_fail(c, torch, ops, "flash_attention_bwd",
                                     keyless_p_one, 2)
        caught += keyless_cases_fail(c, torch, ops, "flash_attention_lse",
                                     keyless_lse, 1)
    sound = not verdicts["kernel"]
    print(f"the kernel as built {'passes' if sound else 'FAILS'}; {caught} "
          f"of {n_faults} planted faults fail", flush=True)
    ok = sound and caught == n_faults
    sys.exit(0 if ok else 1)


def keyless_cases_fail(c, torch, ops, attr, fault, min_t):
    """Whether every phase-1 backward case with rows that see no key and T
    >= ``min_t`` (P = 1 and 1 / T differ from T 2 on) fails with ``fault``
    in ``ops``'s ``attr``'s place (1) or not (0)."""
    saved = getattr(ops, attr)
    setattr(ops, attr, fault)
    failed = passed = 0
    try:
        for case, (_, run) in zip(c._bwd_option_case_list(),
                                  c.flash_bwd_option_checks(torch)):
            _, _, s, t, _, _, w, _, _ = case
            if not (w and s - 1 >= t + w - 1 and t >= min_t):
                continue
            try:
                run()
                passed += 1
            except c.SmokeFailure:
                failed += 1
    finally:
        setattr(ops, attr, saved)
    print(f"{fault.__name__}: {failed} of {failed + passed} phase-1 cases "
          f"with rows that see no key fail", flush=True)
    return int(failed > 0 and passed == 0)


if __name__ == "__main__":
    main()
