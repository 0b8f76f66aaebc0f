"""Quickstart on the port: the Spatter pattern language and engine on
PyTorch, through the hand-written CUDA kernels (the ``hopper`` backend).

    PYTHONPATH=src python examples/quickstart_torch.py               # on a card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions

The four steps of ``examples/quickstart.py``: the paper's CLI pattern, a
strided sweep, three Table 5 proxies through ``run_suite``, and a custom
scatter.  ``modeled(h100)`` is ``bandwidth.h100_sector_model``'s rate: a
model, not a measurement.
"""
import argparse

from repro_torch import GSEngine, appdb, make_pattern, run_suite


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "versions run")
    args = ap.parse_args(argv)
    dev = args.device

    # 1. The paper's own CLI example (§3.4), scaled down:
    #    ./spatter -k Gather -p UNIFORM:8:1 -d 8 -l $((2**24))
    p = make_pattern("UNIFORM:8:1", kind="gather", delta=8, count=2 ** 16)
    r = GSEngine(p, backend="hopper", device=dev).run(runs=5)
    print(f"STREAM-like gather on {r.device}: {r.measured_gbs:8.2f} GB/s "
          f"measured   {r.modeled_gbs:7.1f} GB/s modeled(h100)  "
          f"sector_eff={r.sector_efficiency:.3f}")

    # 2. A strided pattern: bandwidth halves per stride doubling (paper
    #    Fig 3), in the sector model as in the measurement
    for stride in (1, 2, 4, 8):
        p = make_pattern(f"UNIFORM:8:{stride}", delta=8 * stride,
                         count=2 ** 14)
        r = GSEngine(p, backend="hopper", device=dev).run(runs=3)
        print(f"stride-{stride}: {r.measured_gbs:8.2f} GB/s measured   "
              f"modeled(h100) {r.modeled_gbs:7.1f} GB/s")

    # 3. Application-derived patterns (paper Table 5) through the planner
    pats = appdb.scale_counts([appdb.get("PENNANT-G4"), appdb.get("AMG-G0"),
                               appdb.get("LULESH-G2")], 1 / 1024)
    stats = run_suite(pats, backend="hopper", runs=3, device=dev)
    for res in stats.results:
        print(f"{res.pattern.name:12s} [{res.pattern.classify():15s}] "
              f"{res.measured_gbs:8.2f} GB/s measured  "
              f"{res.modeled_gbs:7.1f} GB/s modeled(h100)")
    print(f"suite harmonic mean: {stats.hmean_gbs:.2f} GB/s")

    # 4. Custom pattern, scatter kernel, another backend and row width
    p = make_pattern("CUSTOM:0,4,8,12", kind="scatter", delta=1, count=4096)
    r = GSEngine(p, backend="onehot", row_width=8, device=dev).run(runs=3)
    print(f"custom scatter (onehot backend, row=8): "
          f"{r.measured_gbs:.2f} GB/s")


if __name__ == "__main__":
    main()
