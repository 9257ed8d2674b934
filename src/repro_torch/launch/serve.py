"""Serving launcher: the probabilistic-DB query service (the paper's
workload as a server), port of ``repro.launch.serve``'s ``--db`` loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --db --scale 200 \
        --rounds 3 --sweep 64 --cache-capacity 16 [--device cuda]

The loop drives :class:`repro_torch.db.serving.QueryService`: each round
submits every TPC-H serving plan (round 0 lowers and places cold, later
rounds are structural plan-cache hits -- the same bindings, bit-identical
results), then a parameterized Q6 what-if sweep runs ``--sweep`` points
through the family's one binding.  It prints per-round latency, cached
queries per second and the service's hit/miss/eviction counters.  The
reference's language-model serving path (without ``--db``) waits for the
port of the LM scaffolding (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import argparse
import time

import torch


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_db(args) -> int:
    """The ``--db`` service loop: submit / cached hit / evict over the
    TPC-H plan library, then the parameterized Q6 sweep."""
    from ..db import tpch
    from ..db.serving import QueryService

    db = tpch.generate(n_orders=args.scale, device=args.device)
    svc = QueryService(db.tables(), capacity=args.cache_capacity,
                       device=args.device)
    plans = tpch.serving_plans()
    hit_seconds = 0.0
    hit_requests = 0
    for r in range(max(1, args.rounds)):
        _sync(args.device)
        t0 = time.perf_counter()
        hits = 0
        for plan in plans.values():
            _, info = svc.submit(plan)
            hits += int(info["hit"])
        _sync(args.device)
        dt = time.perf_counter() - t0
        if r > 0:                     # warm rounds measure serving QPS
            hit_seconds += dt
            hit_requests += len(plans)
        print(f"[serve-db] round {r}: {len(plans)} queries in {dt:.3f}s "
              f"({hits}/{len(plans)} cache hits)")
    if hit_requests:
        print(f"[serve-db] cached throughput: "
              f"{hit_requests / hit_seconds:.1f} queries/s")
    if args.sweep > 0:
        n = args.sweep
        batch = dict(disc_lo=torch.full((n,), 5, device=args.device),
                     disc_hi=torch.full((n,), 7, device=args.device),
                     qty_lim=torch.arange(1, n + 1, device=args.device))
        _sync(args.device)
        t0 = time.perf_counter()
        _, info = svc.sweep(tpch.q6_family(), batch)
        _sync(args.device)
        print(f"[serve-db] q6 sweep: {info['points']} points in "
              f"{time.perf_counter() - t0:.3f}s")
    print(f"[serve-db] stats: {svc.stats.as_dict()}")
    print(f"[serve-db] plan cache: {svc.cache.info()}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", action="store_true",
                    help="serve probabilistic TPC-H queries")
    ap.add_argument("--scale", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3,
                    help="request rounds over the plan library (round 0 "
                         "is cold, later rounds hit the cache)")
    ap.add_argument("--sweep", type=int, default=64,
                    help="parameter points of the Q6 what-if sweep (0 "
                         "disables)")
    ap.add_argument("--cache-capacity", type=int, default=16,
                    help="bounded plan-cache entries")
    ap.add_argument("--device", default="cuda",
                    help="where the tables live and the plans run")
    args = ap.parse_args(argv)
    if not args.db:
        ap.exit(2, "serve: only --db is ported; the language-model serving "
                   "path waits for the LM scaffolding (ROADMAP Queue 1 "
                   "item 6)\n")
    return serve_db(args)


if __name__ == "__main__":
    raise SystemExit(main())
