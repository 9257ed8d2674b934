"""Probabilistic TPC-H end-to-end on the PyTorch port (the twin of
examples/tpch_probabilistic.py): generate a synthetic probabilistic
database, run the paper's query suite in all four modes, and show the Q20
plan (the paper's Fig. 6 worked example) step by step.

    PYTHONPATH=src python examples/tpch_probabilistic_torch.py [--orders 2000]
    PYTHONPATH=src python examples/tpch_probabilistic_torch.py --device cpu

``--device`` defaults to the card and raises on a host without one.  The
tables are float64, as in the JAX example.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.core.config import enable_x64, resolve_device

enable_x64()

from repro_torch.db import tpch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    """Run the suite; returns {(query, mode): summary} and Q20's top
    suppliers as (name, probability) pairs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--orders", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"generating TPC-H-like probabilistic db (n_orders={args.orders})")
    db = tpch.generate(n_orders=args.orders, seed=0, device=dev)
    print({k: v for k, v in db.scale.items()})

    summaries = {}
    print(f"\n{'query':8s} {'mode':18s} {'wall s':>8s}  result summary")
    for qname, fn in tpch.QUERIES.items():
        for mode in tpch.MODES:
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(db, mode)
            _sync(dev)
            dt = time.perf_counter() - t0
            if "confidence" in out and out["confidence"].dim() == 0:
                summary = f"confidence={float(out['confidence']):.4f}"
            elif "valid" in out:
                summary = f"{int(out['valid'].sum())} groups"
            else:
                summary = ",".join(sorted(out))
            summaries[(qname, mode)] = summary
            print(f"{qname:8s} {mode:18s} {dt:8.3f}  {summary}")

    # --- Q20 narrated (paper Fig. 6) ------------------------------------
    print("\nQ20 aggregate mode (suppliers in nation 3 with excess "
          "'forest' stock):")
    out = tpch.q20(db, "aggregate")
    valid = out["valid"].cpu()
    names = out["s_name"].cpu()[valid].tolist()
    probs = out["prob"].cpu()[valid].tolist()
    top = sorted(zip(names, probs), key=lambda x: -x[1])[:10]
    for n_, p_ in top:
        print(f"  supplier {int(n_):4d}  P(qualifies) = {p_:.4f}")
    return dict(summaries=summaries, q20_top=top)


if __name__ == "__main__":
    main()
