"""Out-of-core streamed query on the PyTorch port (the twin of
examples/out_of_core_query.py): a probabilistic aggregation over a host
table LARGER than the per-device row budget.

The fact table stays on the host as a :class:`~repro_torch.db.table.
HostTable` (numpy columns, never on the device as a whole);
``compile_plan`` with ``device_row_budget`` lowers its scan to a
StreamedScan and runs the aggregation pass as waves -- canonical-chunk
aligned slabs copied host->device through two buffers, per-(chunk, group)
UDA states folded across waves, one canonical fold at the end.  The
result is bit-identical to the fully device-resident compile at any wave
size, while the device holds two wave slabs instead of the table.

The second half goes one step down the memory hierarchy: the table is
saved to one ``.npy`` file per column (``HostTable.save``), reopened
memory-mapped (``HostTable.open``), and the same streamed plan runs
against the disk-backed table -- slab assembly reads only the touched row
ranges of the columns the plan reads (the lowering's column pruning).

    PYTHONPATH=src python examples/out_of_core_query_torch.py [--rows 200000]
    PYTHONPATH=src python examples/out_of_core_query_torch.py --device cpu

``--device`` defaults to the card and raises on a host without one.
Float64, as in the JAX example.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core.config import enable_x64, resolve_device

enable_x64()

from repro_torch.db import physical as phys
from repro_torch.db import plans
from repro_torch.db.plans import GroupAgg, Scan, Select, compile_plan
from repro_torch.db.table import HostTable


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    if isinstance(x, tuple):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _bit_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(((x == y) | (x.isnan() & y.isnan())).all()
                 if x.is_floating_point() else torch.equal(x, y))
        for x, y in zip(la, lb))


def main(argv=None) -> dict:
    """Run the walkthrough; returns the streamed result and the mmap
    run's stream counters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--budget", type=int, default=4096,
                    help="resident rows of the fact scan per device")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # A synthetic fact table: uncertain rows, 16 groups, built straight
    # into numpy -- it never becomes a single device tensor.
    n = args.rows
    rng = np.random.default_rng(0)
    fact = HostTable(
        {"region": rng.integers(0, 16, n).astype(np.int64),
         "amount": rng.integers(1, 100, n).astype(np.int64)},
        prob=rng.uniform(0.2, 1.0, n))
    print(f"host table: {fact.capacity} rows, "
          f"{len(fact.columns) + 2} columns (numpy, host memory)")

    plan = GroupAgg(Select(Scan("fact"), lambda t: t["amount"] > 10),
                    ("region",), "amount", "SUM", 16, "normal",
                    extra=(("count", "", "COUNT", "normal"),))

    # ~500-row canonical chunks keep the wave size tracking the budget
    # (not the table), so the device footprint is flat however large the
    # host table grows.
    chunks = max(1, n // 500)
    opts = dict(device_row_budget=args.budget, canonical_chunks=chunks)

    lowered = phys.lower_plan(
        GroupAgg(Select(Scan("fact"), lambda t: t["amount"] > 10),
                 ("region",), "amount", "SUM", 16, "normal"),
        {"fact": fact.pad_to_multiple(chunks).capacity},
        n_shards=1, sharded=False, **opts)
    print("\nphysical plan:\n" + phys.explain(lowered) + "\n")

    streamed = compile_plan(plan, None, device=dev, **opts)({"fact": fact})
    print("streamed result (per-region SUM distribution, first 4 groups):")
    mu, var = streamed["sum"]
    for g in range(4):
        print(f"  region {g}: E[sum]={float(mu[g]):12.2f} "
              f"sd={float(torch.sqrt(var[g])):9.2f} "
              f"E[count]={float(streamed['count'][0][g]):9.1f}")

    # The contract: bit-identical to the fully resident compile -- same
    # plan, same canonical chunk grid (the grid defines the summation
    # order), no budget, whole table on the device.
    resident = compile_plan(plan, None, canonical_chunks=chunks,
                            device=dev)({"fact": fact.to_table(dev)})
    assert _bit_equal(streamed, resident)
    size = sum(x.numel() for x in _leaves(streamed))
    print(f"\nstreamed == resident, bit for bit ({size} result elements)")

    # ---- the disk-backed half: save -> open (mmap) -> stream ----------
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fact.cols")
        fact.save(path)
        on_disk = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        disk = HostTable.open(path)         # mmap_mode="r"
        assert isinstance(disk.prob, np.memmap)
        print(f"\nsaved to {len(os.listdir(path))} files "
              f"({on_disk / 1e6:.1f} MB on disk), reopened memory-mapped")

        plans.reset_stream_stats()
        mapped = compile_plan(plan, None, device=dev, **opts)({"fact": disk})
        st = plans.stream_stats()
        assert _bit_equal(mapped, resident)
        print(f"mmap-streamed == resident, bit for bit -- {st['waves']} "
              f"waves, {st['slab_bytes'] / 1e6:.1f} MB shipped "
              "(column-pruned slabs: only the demanded columns leave "
              "the page cache)")
    return dict(streamed=streamed, stream_stats=st)


if __name__ == "__main__":
    main()
