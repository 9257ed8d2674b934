"""Distributed PGF query on a mesh of ``torch.distributed`` ranks (the
twin of examples/distributed_query.py): the paper's aggregate query as
one step on every rank -- per-rank UDA accumulate, one merge, the
replicated FFT finalize -- then a TPC-H plan on the same mesh, bit-equal
to one device.

    PYTHONPATH=src python examples/distributed_query_torch.py [--ranks 8]
    PYTHONPATH=src python examples/distributed_query_torch.py --device cpu

The ranks are processes started by
:func:`repro_torch.testing.ranks.run_ranks` (the JAX example's
``--xla_force_host_platform_device_count`` devices), joined in a gloo
group and laid out as a ("data", "model") mesh of ranks / 2 x 2 (one
row when there are fewer than two).  ``--device`` defaults to the card,
which every rank then shares, and raises on a host without one.
"""
import argparse
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np
import torch


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _bit_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bit_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_bit_equal, a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def rank_main(n: int, groups: int, num_freq: int, orders: int,
              device: str) -> dict:
    """One rank: the aggregate step on its row block, then TPC-H Q3 on the
    mesh three ways against this rank's single-device run."""
    import torch.distributed as tdist

    from repro_torch.db import distributed as dist
    from repro_torch.db import tpch
    from repro_torch.launch.mesh import make_mesh

    world = tdist.get_world_size()
    data = max(1, world // 2)
    mesh = make_mesh((data, world // data), ("data", "model"),
                     device=device)
    out = dict(mesh=dict(zip(mesh.axis_names,
                             (mesh.shape[a] for a in mesh.axis_names))))

    rng = np.random.default_rng(0)
    probs = rng.uniform(0, 1, n).astype(np.float32)
    # selective query: most tuples fail the predicate (value 0); the exact
    # global SUM distribution lives on the F-grid of the survivors
    values = np.zeros(n, np.float32)
    hot = rng.choice(n, 400, replace=False)
    values[hot] = rng.integers(1, 4, 400)
    gids = rng.integers(0, groups, n).astype(np.int32)

    # each rank holds only its row block (local=True: the step takes it)
    step = dist.make_query_step(mesh, max_groups=groups, num_freq=num_freq,
                                local=True)
    pd, vd, gd = dist.shard_columns(mesh, (probs, values, gids))
    step(pd, vd, gd)                             # warm-up
    _sync(device)
    t0 = time.perf_counter()
    conf, normal, cum, coeffs = step(pd, vd, gd)
    _sync(device)
    out["step_s"] = time.perf_counter() - t0
    grid = torch.arange(num_freq, device=coeffs.device, dtype=coeffs.dtype)
    out.update(mass=float(coeffs.sum()), conf0=float(conf[0]),
               mean0=float(normal[0, 0]), sigma0=float(normal[0, 1].sqrt()),
               mean_exact=float((coeffs * grid).sum()),
               closed_form=float(torch.sum(torch.from_numpy(probs)
                                           * torch.from_numpy(values))))

    # ---- the sharded relational frontend: a TPC-H plan on the mesh.
    db = tpch.generate(n_orders=orders, seed=0, device=mesh.device)
    ref = tpch.q3(db, "aggregate")
    runs = {
        "sharded": dict(),
        # every over-budget build side on the hash exchange (ShuffleJoin:
        # build rows and probe keys to their key % shards owners, matched
        # there, responses shuffled home)
        "shuffle": dict(plan_opts=dict(join_gather_budget=64,
                                       copartition=False)),
        # the co-partitioned join -> aggregate pipeline: matched rows stay
        # at their owner and the GROUP BY runs there (the port's
        # compile_plan only takes it when asked)
        "copartitioned": dict(order_join_budget=64,
                              plan_opts=dict(copartition=True)),
    }
    for name, kw in runs.items():
        dist.reset_collective_counts()
        _sync(device)
        t0 = time.perf_counter()
        got = tpch.q3(db, "aggregate", mesh=mesh, **kw)
        _sync(device)
        out[name] = dict(seconds=time.perf_counter() - t0,
                         bit_equal=_bit_equal(ref, got),
                         collectives=dict(dist.COLLECTIVE_COUNTS))
    out["rows"] = dict(lineitem=db.lineitem.capacity,
                       orders=db.orders.capacity)
    return out


def main(argv=None) -> dict:
    """Spawn the ranks, print rank 0's report; returns it."""
    from repro_torch.core.config import resolve_device
    from repro_torch.testing.ranks import run_ranks

    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--tuples", type=int, default=1 << 18)
    ap.add_argument("--orders", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    n, groups, num_freq = args.tuples, 256, 1024
    with tempfile.TemporaryDirectory() as store:
        r = run_ranks(rank_main, args.ranks, backend="gloo",
                      device=args.device, store_dir=store,
                      args=(n, groups, num_freq, args.orders,
                            args.device))[0]
    print(f"mesh: {r['mesh']} over {args.ranks} gloo ranks on "
          f"{args.device}")
    print(f"{n:,} probabilistic tuples -> {groups} groups + exact global "
          f"distribution ({num_freq} support) in {r['step_s'] * 1e3:.1f} ms "
          f"({n / r['step_s'] / 1e6:.2f} Mtuples/s)")
    print(f"  global COUNT-ish distribution mass: {r['mass']:.6f}")
    print(f"  group 0: confidence={r['conf0']:.4f} E[SUM]={r['mean0']:.1f} "
          f"sigma={r['sigma0']:.2f}")
    print(f"  E[global SUM] from exact PGF = {r['mean_exact']:.1f} "
          f"(closed form {r['closed_form']:.1f})")
    shards = r["mesh"]["data"]
    rows = r["rows"]
    print(f"TPC-H Q3 via the sharded frontend on {shards} data shards in "
          f"{r['sharded']['seconds'] * 1e3:.1f} ms: bit-equal to "
          f"single-device = {r['sharded']['bit_equal']} (rows/rank "
          f"{rows['lineitem'] // shards:,} vs {rows['lineitem']:,} "
          "replicated)")
    print(f"TPC-H Q3 with shuffle-partitioned joins (gather budget 64) in "
          f"{r['shuffle']['seconds'] * 1e3:.1f} ms: bit-equal to "
          f"single-device = {r['shuffle']['bit_equal']} (build rows/rank "
          f"{rows['orders'] // shards:,} vs {rows['orders']:,} gathered)")
    fused = r["copartitioned"]
    print(f"TPC-H Q3 with the co-partitioned join->agg pipeline in "
          f"{fused['seconds'] * 1e3:.1f} ms: bit-equal to single-device = "
          f"{fused['bit_equal']}, shuffle_back round-trips = "
          f"{fused['collectives'].get('shuffle_back', 0)} (collectives: "
          f"{fused['collectives']})")
    return r


if __name__ == "__main__":
    main()
