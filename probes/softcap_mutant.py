"""Show that the flash kernel's softcap is checked where it bites.

Copies ``src/`` and ``chip_smoke.py`` into a temporary directory, takes the
softcap out of both flash kernels there (the float32 kernel's
``tanhf(x / softcap) * softcap`` and the bf16 tensor-core kernel's
``cap_in``), builds that copy, and runs ``chip_smoke``'s flash checks on
it:

  * every case where the softcap bites (``flash_cap_checks``, phase 1, and
    ``gemma2_flash_cap_checks``, phase 4) must fail;
  * the cases with softcap 50 on unit-normal q and k (phase 1's edge cases
    and gemma2's prefill shape, window 4096 and none) are run too, and
    their passes counted: there the cap moves the scores by under 1%.

    python3 probes/softcap_mutant.py        # on the card, ~2 min

Exit 0 when every biting case failed on the copy.  The copy is deleted at
the end; the repository's own sources are not touched.
"""
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CU = Path("src/repro_torch/csrc/flash_attention.cu")
MUTATIONS = (
    ("if (softcap > 0.f) x = tanhf(x / softcap) * softcap;", ""),
    ("const float cap_in = softcap > 0.f ? scale / softcap : 0.f;",
     "const float cap_in = 0.f;"),
)


def run(label, checks, failure):
    """Run each ``(where, check)``; returns how many failed."""
    failed = 0
    for where, check in checks:
        try:
            err = check()
            print(f"  {label} passed: {where} (max |err| {err})", flush=True)
        except failure as e:
            failed += 1
            print(f"  {label} FAILED: {e}", flush=True)
    return failed


def main():
    tmp = Path(tempfile.mkdtemp(prefix="softcap_mutant_"))
    try:
        shutil.copytree(ROOT / "src", tmp / "src", ignore=shutil.
                        ignore_patterns("_build", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        text = (tmp / CU).read_text()
        for old, new in MUTATIONS:
            if text.count(old) != 1:
                sys.exit(f"mutation site not found once: {old!r}")
            text = text.replace(old, new)
        (tmp / CU).write_text(text)
        sys.path.insert(0, str(tmp))
        import chip_smoke as c
        assert Path(c.__file__).resolve().parent == tmp.resolve()
        torch = c.setup()
        c.build()
        bite = list(c.flash_cap_checks(torch))
        n_bite = len(bite)
        caught = run("bite", bite, c.SmokeFailure)
        del bite
        g2 = list(c.gemma2_flash_cap_checks(torch))
        n_bite += len(g2)
        caught += run("gemma2 bite", g2, c.SmokeFailure)
        del g2
        # the unit-normal cases with softcap 50 that were there before
        gen = torch.Generator(device="cuda").manual_seed(6)
        plain = []
        for (bsz, kvh, g, s, dh, dtype, causal, window,
             cap) in c._flash_edge_cases(torch):
            q, k, v = c._flash_inputs(torch, gen, bsz, kvh, g, s, dh, dtype)
            if cap:
                where = (f"edge B={bsz} KVH={kvh} G={g} S={s} dh={dh} "
                         f"{dtype} causal={causal} window={window}")
                plain.append((where, lambda q=q, k=k, v=v, causal=causal,
                              window=window, cap=cap, where=where:
                              c.check_flash(torch, q, k, v, causal, window,
                                            cap, where)))
        bsz, kvh, gq, s, dh = c.GEMMA2_FLASH_SHAPE
        q, k, v = c._flash_inputs(torch, gen, bsz, kvh, gq, s, dh,
                                  torch.bfloat16)
        for window in (c.GEMMA2_WINDOW, 0):
            kw = dict(causal=True, window=window, softcap=c.GEMMA2_SOFTCAP)
            where = f"gemma2 {c.GEMMA2_FLASH_SHAPE} {kw}"
            plain.append((where, lambda kw=kw, where=where:
                          c.check_flash_sliced(torch, q, k, v, kw, where)[0]))
        missed = run("unit-normal", plain, c.SmokeFailure)
        print(f"softcap removed from both flash kernels: {caught} of {n_bite} "
              f"cases where the softcap bites fail; {len(plain) - missed} of "
              f"{len(plain)} unit-normal softcap-50 cases pass", flush=True)
        sys.exit(0 if caught == n_bite else 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
