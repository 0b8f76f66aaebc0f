"""Show that the one-step checks of phases 19, 20 and 21 catch a faulty
backward (flash attention's, the selective scan's, the RG-LRU's).

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

With ``--arch falcon-mamba-7b`` (``FM_TRAIN_CHECK``: 2 layers, 1 x
4,096 tokens) the faults are planted in the scan's backward:

  * ``ddt_no_h_term``: ddt without its sum_n g h_{t-1} a dA term (the
    plain backward's equations without it);
  * ``walk_off_by_one``: the state's cotangent carried back by dA_t where
    dA_{t+1} belongs (likewise);
  * ``du_no_skip``: du without dy D (the kernel's du less it);
  * ``dbc_one_cta``: dB and dC summed over the first CTA's 128 channels
    only (the kernel on those channels);
  * ``ckpt_neighbour``: each chunk of 8 steps rebuilt from its
    neighbour's checkpoint, the state 8 steps earlier (the kernel given
    the checkpoint rolled by one chunk).

With ``--arch recurrentgemma-9b`` (``RG_TRAIN_CHECK``: rec, rec, attn at 1
x 4,096 tokens) in the recurrence's and in flash's dh-256 backward:

  * ``rglru_off_by_one``: g carried back by a_t where a_{t+1} belongs (the
    plain backward's equations with it);
  * ``window_off_256``: flash's backward without the window of 2,048;
  * ``dh_last_dropped``: the cotangent of h_S not added.  The model's loss
    never reads h_S (it is the decode cache), so the step cannot show
    this fault; it is run through phase 1's recurrence cases
    (``rglru_bwd_cases``' list), each of which with a cotangent of h_S
    must fail.

Prints each run's readings against ``chip_smoke.grad_faults``'s limits
(phase 19's, ``GEMMA2_TRAIN_LIMITS``, ``FM_TRAIN_LIMITS`` or
``RG_TRAIN_LIMITS``) and writes them all, per leaf, to
``chiprun_out/train_grad_faults[_<arch>].json``.

    python3 probes/train_grad_faults.py [--arch ARCH]  # the card

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
                    choices=("llama3-8b", "gemma2-27b", "falcon-mamba-7b",
                             "recurrentgemma-9b"))
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
    targets = {f.__name__: "flash_attention_bwd" for f in faults}
    if args.arch == "falcon-mamba-7b":
        faults = scan_faults(c, torch)
        targets = {f.__name__: "selective_scan_bwd" for f in faults}
        shape, limits = c.FM_TRAIN_CHECK, c.FM_TRAIN_LIMITS
        tag = "_falcon-mamba-7b"
    if args.arch == "recurrentgemma-9b":
        faults = [rglru_off_by_one(torch)]
        targets = {faults[0].__name__: "rglru_scan_bwd"}

        def window_off_256(q, k, v, o, lse, do, *, scale, **kw):
            return real(q, k, v, o, lse, do, scale=scale,
                        **{**kw, "window": 0})
        faults.append(window_off_256)
        targets["window_off_256"] = "flash_attention_bwd"
        shape, limits = c.RG_TRAIN_CHECK, c.RG_TRAIN_LIMITS
        tag = "_recurrentgemma-9b"
    readings = c.grad_readings(
        torch, [("kernel", None)] + [(f.__name__, {targets[f.__name__]: f})
                                     for f in faults],
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
    if args.arch == "recurrentgemma-9b":
        n_faults += 1
        caught += dh_last_cases_fail(c, torch)
    sound = not verdicts["kernel"]
    print(f"the kernel as built {'passes' if sound else 'FAILS'}; {caught} "
          f"of {n_faults} planted faults fail", flush=True)
    ok = sound and caught == n_faults
    sys.exit(0 if ok else 1)


def scan_faults(c, torch):
    """The scan's planted backwards (the module docstring's list), each in
    ``selective_scan_bwd``'s place."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    real = scan_ops.selective_scan_bwd
    f32 = torch.float32

    def plain(fault):
        """The plain backward's equations (``selective_scan_bwd_ref``) with
        ``fault``, on the card's tensors."""
        def bwd(u, dt, b, c_, a, d_skip, dy, dh_final=None, ckpt=None):
            bsz, l, d = u.shape
            n = b.shape[2]
            u32, dt32, b32, c32, dy32 = (x.to(f32) for x in (u, dt, b, c_,
                                                             dy))
            hs = torch.zeros((bsz, l + 1, n, d), dtype=f32, device=u.device)
            for t in range(l):
                e = torch.exp(dt32[:, t, None, :] * a[None])
                hs[:, t + 1] = (hs[:, t] * e + (dt32[:, t] * u32[:, t])[
                    :, None, :] * b32[:, t, :, None])
            g = (torch.zeros((bsz, n, d), dtype=f32, device=u.device)
                 if dh_final is None else dh_final.clone())
            du, ddt = torch.empty_like(u32), torch.empty_like(u32)
            db, dc = torch.empty_like(b32), torch.empty_like(b32)
            da = torch.zeros((n, d), dtype=f32, device=u.device)
            for t in reversed(range(l)):
                gy, uu, dd = dy32[:, t], u32[:, t], dt32[:, t]
                bt, ct = b32[:, t, :, None], c32[:, t, :, None]
                hp, h = hs[:, t], hs[:, t + 1]
                e = torch.exp(dd[:, None, :] * a[None])
                g = gy[:, None, :] * ct + (g * e if fault == "off_by_one"
                                           else g)
                dc[:, t] = (gy[:, None, :] * h).sum(2)
                db[:, t] = (g * (dd * uu)[:, None, :]).sum(2)
                du[:, t] = gy * d_skip[0] + dd * (g * bt).sum(1)
                h_term = 0.0 if fault == "no_h_term" else hp * a[None] * e
                ddt[:, t] = (g * (uu[:, None, :] * bt + h_term)).sum(1)
                da += (g * hp * dd[:, None, :] * e).sum(0)
                g = g if fault == "off_by_one" else g * e
            dd_skip = (dy32 * u32).sum((0, 1))[None]
            return (du.to(u.dtype), ddt.to(u.dtype), db.to(u.dtype),
                    dc.to(u.dtype), da, dd_skip)
        return bwd

    ddt_no_h_term = plain("no_h_term")
    ddt_no_h_term.__name__ = "ddt_no_h_term"
    walk_off_by_one = plain("off_by_one")
    walk_off_by_one.__name__ = "walk_off_by_one"

    def du_no_skip(u, dt, b, c_, a, d_skip, dy, dh_final=None, ckpt=None):
        du, *rest = real(u, dt, b, c_, a, d_skip, dy, dh_final, ckpt)
        return ((du.float() - dy.float() * d_skip[0]).to(du.dtype), *rest)

    def dbc_one_cta(u, dt, b, c_, a, d_skip, dy, dh_final=None, ckpt=None):
        out = list(real(u, dt, b, c_, a, d_skip, dy, dh_final, ckpt))
        w = scan_ops.CTA_CHANNELS

        def cut(x):
            return x[..., :w].contiguous()
        part = real(cut(u), cut(dt), b, c_, cut(a), cut(d_skip), cut(dy),
                    None if dh_final is None else cut(dh_final), cut(ckpt))
        out[2], out[3] = part[2], part[3]
        return tuple(out)

    def ckpt_neighbour(u, dt, b, c_, a, d_skip, dy, dh_final=None,
                       ckpt=None):
        return real(u, dt, b, c_, a, d_skip, dy, dh_final,
                    torch.roll(ckpt, 1, dims=1))
    return [ddt_no_h_term, walk_off_by_one, du_no_skip, dbc_one_cta,
            ckpt_neighbour]


def rglru_off_by_one(torch):
    """The recurrence's plain backward with g carried back by a_t where
    a_{t+1} belongs."""
    from repro_torch.kernels.rglru_scan.ref import fma_f32

    def bwd(a, beta, gx, h0, hs, dhs, dh_last=None):
        g = torch.zeros_like(h0) if dh_last is None else dh_last.clone()
        da, dbeta, dgx = (torch.empty_like(a) for _ in range(3))
        for t in reversed(range(a.shape[1])):
            g = fma_f32(a[:, t], g, dhs[:, t])
            da[:, t] = g * (hs[:, t - 1] if t > 0 else h0)
            dbeta[:, t] = g * gx[:, t]
            dgx[:, t] = g * beta[:, t]
        return da, dbeta, dgx, a[:, 0] * g if a.shape[1] else g
    bwd.__name__ = "rglru_off_by_one"
    return bwd


def dh_last_cases_fail(c, torch):
    """Whether every phase-1 case of the recurrence's backward with a
    cotangent of h_S fails with that cotangent dropped in
    ``rglru_scan_bwd``'s place (1), while the cases without one pass (or
    not: 0)."""
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    real = rglru_ops.rglru_scan_bwd

    def dh_last_dropped(a, beta, gx, h0, hs, dhs, dh_last=None):
        return real(a, beta, gx, h0, hs, dhs, None)
    gen = torch.Generator(device="cuda").manual_seed(73)
    failed = passed = sound = 0
    rglru_ops.rglru_scan_bwd = dh_last_dropped
    try:
        for bsz, w, s, with_dh in c.RGLRU_BWD_CASES:
            ins = c._rglru_inputs(torch, gen, bsz, s, w)
            dhs = torch.randn(bsz, s, w, generator=gen, device="cuda")
            dh = (torch.randn(bsz, w, generator=gen, device="cuda")
                  if with_dh else None)
            try:
                c.check_rglru_bwd(torch, ins, dhs, dh, f"B={bsz} S={s} "
                                  f"W={w} dh_last={with_dh}")
                if with_dh:
                    passed += 1
                else:
                    sound += 1
            except c.SmokeFailure:
                failed += with_dh
    finally:
        rglru_ops.rglru_scan_bwd = real
    print(f"dh_last_dropped: {failed} of {failed + passed} phase-1 cases "
          f"with a cotangent of h_S fail; {sound} without one pass",
          flush=True)
    return int(failed > 0 and passed == 0)


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
