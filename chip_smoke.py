#!/usr/bin/env python3
"""Drive the PyTorch port's resident TPC-H path, its streamed
(out-of-core) path, its value layer, its multi-rank path, its serving
layer with its batched sweeps, its language-model serving, its
language-model training and its language-model mesh on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Sixteen phases, each of which raises on a failed check (exit code != 0):

1. Set-up: print the card's name and power limit, build the five CUDA
   kernels from ``src/repro_torch/kernels/csrc`` and print the build time.
2. Kernels: run each kernel against its plain PyTorch version on the card
   at the shapes the two paths give it (one canonical chunk of 750,000
   tuples of the TPC-H SF1 path; the polynomial products of the value
   layer, and larger ones).  Each kernel gets two times: its own
   __global__ launches alone (``ms``, from the profiler's kernel rows;
   for the redesigned kernels, all five now, every device operation of
   the wrapper call) and its wrapper as the path calls it (``wrapper_ms``,
   CUDA events around whole calls, set-up included); the plain version
   and, where one PyTorch call computes the same function, that call
   (``library_ms``) are timed with CUDA events.  Each kernel's bound is
   bytes over 3.35 TB/s or operations over 67 TFLOP/s float32, whichever
   is larger.  The CF kernels also run with every tuple live, with
   bank-conflicting values, at the value layer's COUNT shapes (odd N,
   N = 1, 2; also held against float64 terms) and over skewed groups;
   the grouped cumulant kernel on both its routes and over skewed groups;
   each checked, rerun bit-equal and timed; and ``cumulant_sums`` alone on
   the value layer's 10^8 tuples at the gamma-mixture fit's 6 orders.
   polymul also runs at the edge shapes of its partition (a factor of one
   coefficient, asymmetric products, tile and slice boundaries +-1).
   The five redesigned kernels' times print beside those of their first
   design; logcf also runs with its twiddle table in device memory
   instead of shared memory.
3. TPC-H path: generate the SF1 tables on the card, reset the kernels'
   launch counters, run Q1/Q3/Q6/Q18/Q20 in all four modes (plus Q6 with
   ``num_freq=4096`` and Q18 ``method="exact"``) through the port's entry
   points, read the counters, and check bit-equal reruns and
   kernel-independent cross-checks.  Then time and profile the queries.
4. Streamed path at SF1: lineitem as a host table (numpy, pinned slab
   buffers), Q1/Q3/Q6/Q18/Q20 in aggregate mode plus Q6 exact and Q18
   exact with ``STREAM_OPTS`` (4 waves of 2 canonical chunks; orders and
   partsupp resident): the counters reset, each query once, the counters
   read; each result bit-equal to its resident run and each query's
   launches equal to its resident run's; wall ms, slabs, bytes, copy
   rate and peak device memory printed.  Q6 exact again from
   memory-mapped columns (``HostTable.save`` / ``open``).  Then the fault
   and retry checks: a transient slab-copy fault resumes bit-equal; a
   persistent one converges by wave halving (``run_plan``); ``run_plan``
   on ``q18_topk`` with a too-small kappa and max_groups converges; each
   converged result equals a first run at its ``final_params``.
5. Value-layer path, at the paper's sizes: exact COUNT of 10^8 tuples
   (Fig. 9) in float32 and float64, its gamma-mixture and Normal fits
   (Fig. 10), exact SUM over the SF1 lineitem, ``q18_topk`` at SF1 with
   kappa 8 and 2, and two schoolbook products; one warm-up, then the
   counters reset, every call timed, the counters read; moment, mass,
   tail and bit-equal-rerun checks.
6. Small size (n_orders=2000): both paths on the CPU's plain versions
   against the card's kernels.
7. Streamed at SF5 cardinalities (30,000,000 lineitem rows on the
   host, 32 canonical chunks, 16 waves of 2): Q1 aggregate and Q6 exact
   double-buffered and synchronous, the host->device copy rate beside a
   plain pinned ``copy_`` of one slab, the peak device memory against the
   resident run of the same query, bit-equal to it.
8. Mesh at SF1 (``compile_plan(root, mesh)``): (a) a one-rank NCCL group
   in this process; (b) three gloo ranks sharing the card (8 canonical
   chunks over 3 ranks: the ragged split), which open the SF1 tables this
   process saved and materialise them on the card; (c) four gloo ranks as
   a (2, 2) data x model mesh (Q6 exact and Q18 exact: Q6's N/2 + 1
   unique logcf columns and Q18's frequency slabs split over the model
   axis).  (a) and (b) run the SF1 aggregate queries, both exact
   variants, Q3 with the co-partitioned pipeline forced and Q20 with
   ShuffleJoin; every rank's result must be bit-equal to phase 3's (a
   digest of every leaf's bits) and the launches per query, summed over
   ranks, equal to phase 3's times the model ranks (each runs its data
   block's chunks) and, for the forced co-partitioned Q3 (a
   hash-partitioned pass runs every chunk on every owner), times the data
   ranks.  (b) also checks zero exchange
   overflow, a stale-stats ``run_plan`` (orders x customer on a
   ShuffleJoin, stats from a half-size snapshot) that converges through
   the exchange escalation bit-equal to a first run at its
   ``final_params``,
   an exchange fault that propagates from every rank, and Q1 / Q6 exact
   streamed bit-equal to phase 3.  Each rank's wall ms per query, the
   collective counts and each rank's peak device memory are printed.
   Ranks that share one card say nothing about scaling.
9. Serving at SF1 (``db/serving.py``), run on phase 8 (a)'s tables while
   its NCCL group is up: the counters reset; a ``QueryService`` (capacity
   16) over the SF1 catalogue, a library of 7 plans with phase 3's
   capacities (Q1, Q3, Q6, Q6 ``num_freq=4096``, Q18 reweight, Q18 exact,
   Q20) submitted in three rounds of fresh plan objects: the cold round's
   results equal phase 3's (digests), every warm submit is a hit that
   calls ``physical.lower_plan`` zero times (a wrapper here), returns the
   cold bits and launches what the cold run launched.  A 64-point
   ``q6_family`` sweep equals 64 sequential submits point by point; a
   32-point resweep hits.  A capacity-2 service
   over 4 Q6 variants (lineitem a HostTable) evicts 2 entries, which die;
   its entries share one device copy of lineitem, and device memory
   returns to within 1 MB of its level before the service.  A streamed
   submit (``STREAM_OPTS``) twice, a hit equal to resident; Q6 and Q1 on
   the NCCL mesh twice, hits equal to phase 3; a healed replay of
   ``q18_topk`` with kappa 2 (one attempt, a hit, the same bits);
   ``launch.serve.main(["--db"])``.  Cold, warm and lowering ms per plan,
   warm queries/s and sweep ms per point are printed.
10. LM serving (``configs/``, ``models/``, ``launch.serve.generate``),
   plain PyTorch in bfloat16 (no kernel of the DB path runs; the
   counters must not move): (a) yi_6b at its full published config
   (6.06 B parameters, random weights from a seeded generator on the
   card): ``generate`` at the serve defaults (batch 4, prompt 32, 16
   tokens) twice, equal tokens; ms a decode step, tokens/s, the step's
   weight-streaming bound (parameter bytes over 3.35 TB/s), peak device
   memory, and a profiled window of decode steps (device busy share,
   device operations a step).  (b) Each of the ten archs at its full
   published widths, cut to one period of its layer pattern (plus
   recurrentgemma's 2-layer tail; MoE dropless): a forward over 2 x 256
   tokens (embeddings for internvl2 and hubert), finite; for the nine
   causal ones 256 single-token decode steps against ``init_cache``,
   max |decode - forward| / max |forward| within ``LM_DECODE_BOUND``.
   (c) Each reduced config (float32), the same weights on the CPU and the
   card: forward logits within ``LM_CARD_CPU_BOUND``.  (d)
   ``launch.serve.main(["--arch", a, "--device", "cuda"])`` for each
   causal arch (internvl2's embedding inputs refused).
11. LM training (``train/``, ``models/api.loss_fn`` with remat,
   ``launch.train``), the launch counters reset before it and read after
   it: (a) yi_6b at its full published config, bf16, ``make_train_step``
   (AdamW with bf16 moments, accum 1, remat on) for 3 steps of 2 x 512
   ``TokenStream`` tokens, the first a warm-up, then one profiled step:
   ms a step, tokens/s, the model FLOPs a step needs (6 N T and the
   masked attention) and their bound at 989 TFLOP/s beside those remat
   and the unmasked scores add, peak memory, device busy share, device
   ops a step; loss, grad norm and parameters finite.  The same model
   then trains at its 4096 context (2 x 4096 tokens, four key chunks):
   the same figures, and one step's loss + backward and clip + AdamW
   timed apart.  (b) Each arch at full widths one period deep (as
   phase 10 (b)), one train step on 1 x 256 tokens (the bf16 attention
   backward); nemotron, whose train state (4 x 25.8 GB) exceeds the card,
   takes the loss, gradients and clip without the AdamW step.  (c) The
   reduced configs (float32), the same weights and batch on the CPU and
   the card: every gradient within ``LM_CARD_CPU_BOUND`` of its leaf's
   scale.  (d) Reduced yi_6b through ``run_with_failures`` (a failure
   after step 4 of 8, checkpoints every 3) against an uninterrupted run:
   parameters and moments bit-equal.  (f) ``compressed_psum`` over two
   gloo ranks sharing the card: both ranks bit-equal to the shared-scale
   int8 mean, within 5% of the true mean.  (g) ``launch.train.main``
   (reduced yi_6b, 4 steps).  (e) ``ProbabilisticSampler`` on 4,096
   float32 probabilities: exactly one ``logcf`` launch and no other in
   the whole phase; then, against the plain version on the card, the log
   CF within the kernel phase's 2e-5 of sum |term|, the PGF within 2e-5,
   the capacity at eps 1e-2 equal (1e-4 and 1e-6 printed beside float64).
   Kernel and plain share the float32 frequency grid, so they are held to
   each other; against float64 terms each is printed (at N = 4,097 with
   p in [0.5, 0.95] the float32 grid alone errs by ~1.7e-4 of sum |term|).
12. LM mesh (``sharding.Rules``, ``sharding.ShardedModel``, the sharded
   ``make_train_step``, ``checkpoint`` under a mesh, ``train.elastic``):
   four gloo ranks sharing the card, each resetting its launch counters
   (all must stay 0).  (a) yi_6b at its full widths cut to 1 layer,
   bf16, 3 steps of 4 x 512 tokens (AdamW, remat) on a (2, 2) ("data",
   "model") mesh, against the same model and batches on one rank (rank
   0, before the mesh runs): loss within ``MESH_LOSS_RTOL``, grad norm
   within ``MESH_NORM_RTOL``; ms a step, peak memory a rank, bytes
   received a step by collective kind.  (b) olmoe_1b_7b the same way (64
   experts, 8 active, split over the model axis, routing global): the
   same bounds, and each layer's dropped (token, choice) pairs equal to
   one rank's.  (c) (a) again: every rank's parameter blocks bit-equal.
   (d) (a)'s state after step 2, saved under (2, 2) (full arrays),
   restored under (4, 1) with ``restore(shardings=)`` and resharded back
   with ``elastic.reshard``: every leaf bit-equal to the saved block; a
   step after it bit-equal to (a)'s third.  (e) yi_6b as in (a) on a
   (1, 4) mesh (its 4 KV heads split four ways), against the same one
   rank.  (f) yi_6b's layer with float32 weights on (2, 2): a decode
   of a 5-token prompt and 3 steps on a cache of blocks (KV heads over the
   model axis) against one rank's, within ``MESH_DECODE_ATOL``.  The
   model axis splits the compute (``sharding.py``'s module docstring:
   heads, MLP width, vocabulary, experts; ``"tp"`` bytes), and the step
   gathers one segment's parameters at a time (``ShardedModel.gathered``:
   a parameter the layers compute on as its model block over the data
   axes only), so remat gathers again.
13. The dry-run (``launch/cells.py``, ``launch/dryrun.py``), started in
   subprocesses at the top of the run (``DryRuns``), beside phases 1-12.
   (a) ``DRYRUN_CELLS`` on both production meshes (fake process groups of
   256 and 512 ranks, fake tensors): a line a cell (peak GB a device, the
   FLOPs against the model's, bytes, bytes received by kind, the three
   roofline terms and the dominant one).  (b) ``CARD_CELLS`` for real on
   a one-rank NCCL mesh (1, 1) at full width and depth (seeded weights):
   the FLOPs of the step (the dry-run's own formulas over the real
   operations, ``LiveBytes``) equal the dry-run's trace of the same cell
   at the same settings, the step's peak (max allocated less what was
   allocated before) within ``PEAK_RTOL`` or ``PEAK_ATOL`` of the
   dry-run's, the launch counters equal the dry-run's (the pgf cell
   reaches ``logcf`` and ``group_cumulant_sums``, each held to its plain
   version in phase 1), the output finite; ms a step beside the dry-run's
   dominant term.  (c) Phase 12's bytes received by kind, every rank and
   step, equal the dry-run of its configuration on a fake world of 4.
14. The pgf cell (``db.distributed.make_query_step``) for real at 2^20
   tuples, 4,096 groups and 2^16 CF frequencies: on a one-rank NCCL mesh
   (1, 1), and on two gloo ranks sharing the card on (1, 2), whose model
   axis splits the CF's frequencies (each rank's window through
   ``group_logcf``).  Each run's launches equal its dry-run's (phase 13's
   subprocesses), and the (1, 2) CF equals the (1, 1) CF within
   ``CF_BOUND``.
15. The batched sweep (``QueryService(sweep_mode="vmap")``,
   ``db/sweep.py``) on phase 9's SF1 tables, right after phase 9: phase
   9's 64-point ``q6_family`` sweep in launches of
   ``VMAP_POINTS_PER_LAUNCH`` points (a ``batch_row_budget``), cold and
   again as a hit, with the counters reset before it; every point held to
   phase 9's scan sweep within ``VMAP_RTOL`` of each leaf's scale
   (``VMAP_CUMULANT_RTOL`` of each cumulant order's).  Then every 4th
   point with the exact SUM rider (4,096 frequencies) against its own
   scan sweep (run before the counters reset).  The first launch's 16
   points again on phase 8 (a)'s one-rank NCCL mesh, bit-equal to one
   device's (after the counters are read).  ``group_cumulant_sums``
   and ``group_logcf`` must launch.  Ms a point cold and warm beside phase
   9's scan sweep in this run and the 143.81 PERF.md records, the peak
   device memory
   above the tables, the errors and the launches are printed.
16. Every sweep the reference's service takes, with reports
   (``with_report=True``: a stacked ``ExecutionReport``, each count a
   point's).  (a) Right after phase 15, on phase 9's SF1 tables: TPC-H
   Q3 as a family with its substitution parameters lifted (SEGMENT on
   ``customer``, DATE on ``orders`` and ``lineitem``: parameters on both
   build sides of the nested joins), 16 points (4 segments x 4 dates in
   March 1995), scan and vmap: every leaf of the vmap sweep within
   ``VMAP_RTOL`` of the scan sweep's scale (cumulant orders
   ``VMAP_CUMULANT_RTOL``), every report count equal point by point,
   ``group_cumulant_sums`` launched (counters reset just before the vmap
   sweep, read just after).  (b) Phase 15's Q6 vmap sweep again with a
   report: bit-equal to phase 15's result, its report at every 4th point
   equal to the scan sweep's.  (c) In phase 14's two gloo ranks sharing
   the card, after its pgf runs, at SF0.1, 8 points: the Q3 family through
   CoPartitionedJoin + PartitionedAgg (``copartition=True``, a join budget
   of 4; both nodes checked in ``compiled.explain``), bit-equal to one
   device's vmap sweep, no exchange overflowing and its passes' counts
   equal to one device's;
   and a join on a computed key at a small ``shuffle_slack`` that
   overflows at some points and not at others: each point's counts equal
   the scan sweep's, and exactly the overflowing points are NaN-poisoned.
   Ms a point, peak memory, errors and launches are printed.

The line before the last is the card's name and power limit; a JSON line
of per-kernel numbers comes before it; the last line is the fixed result
JSON.  Details (all numbers, the ptxas report of the build) go to
``DIR/chip_smoke.json`` and ``DIR/build.log``, by default under
``build/chip_smoke`` of the checkout.
"""
from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SF1 = dict(n_orders=1_500_000, lines_per_order=4, n_parts=200_000,
           n_suppliers=1_000, n_customers=150_000, n_nations=25, seed=0)
CHUNK = 750_000               # tuples of one canonical chunk at SF1
Q3_GROUPS = 262_144
Q18_GROUPS = 1_500_000
Q18_EXACT_OPTS = dict(cf_budget_elems=1 << 28)
Q18_NORMAL_GROUPS = 2_097_152
Q20_GROUPS = 131_072
#: minimum launches of each kernel in one run of the main path.
MIN_LAUNCHES = {"group_cumulant_sums": 16, "cumulant_sums": 8, "logcf": 8,
                "group_logcf": 24}
#: launches of each kernel in one run of the value-layer path: logcf for
#: the two 1,000-tuple and four 400-tuple COUNTs, cumulant_sums for the
#: 10^8-tuple fit, polymul for the 1001 x 1001 and 401 x 801 products.
VALUE_LAUNCHES = {"logcf": 6, "group_logcf": 0, "cumulant_sums": 1,
                  "group_cumulant_sums": 0, "polymul": 2}
FIG9_N = 100_000_000
Q18_TOPK_GROUPS = 2_097_152
#: The streamed SF1 path: lineitem (6,000,000 rows, 750,000 a canonical
#: chunk) streams from a HostTable; orders (1,500,000 rows) and partsupp
#: (800,000), the build sides of Q3 and Q20, stay resident under the
#: budget; waves of 2 canonical chunks: SF1_WAVES waves a phase.
STREAM_OPTS = dict(device_row_budget=2_000_000, stream_wave_chunks=2)
SF1_WAVES = 4
#: the kernels the streamed path runs (polymul is the value layer's).
STREAM_KERNELS = ("logcf", "group_logcf", "cumulant_sums",
                  "group_cumulant_sums")
#: The larger scale: TPC-H SF5's orders and lineitem (7,500,000 orders,
#: 30,000,000 lineitem rows) as host tables, on a grid of 32 canonical
#: chunks (937,500 rows each); n_parts stays at SF1's 200,000 and
#: n_suppliers at 1,000 (PERF.md §4).
SF5 = dict(n_orders=7_500_000, lines_per_order=4, n_parts=200_000,
           n_suppliers=1_000, n_customers=750_000, n_nations=25, seed=0)
SF5_CHUNKS = 32
#: device_row_budget of each SF5 query, in canonical chunks' rows, for
#: waves of 2 chunks (16 waves): a pruned slab of c of lineitem's 10
#: columns (+ p, valid) is (c + 2) / 12 of a full row, and a wave takes
#: (budget / width) // (2 chunks) chunks (db/cost.py wave_schedule).  Q1
#: reads 5 columns (2.8 * 12 / 7 = 4.8 chunks), Q6 exact 3 (2.0 * 12 / 5):
#: 2,625,000 and 1,875,000 rows.
SF5_BUDGET_CHUNKS = {"q1/aggregate": 2.8, "q6/aggregate_exact": 2.0}
SF5_WAVES = 16
#: what each kernel replaces on the TPU.
REPLACES = {
    "logcf": "src/repro/kernels/pb_cf.py:41",
    "group_logcf": "src/repro/kernels/group_cf.py:67",
    "cumulant_sums": "src/repro/kernels/cumulants.py:31",
    "group_cumulant_sums": "src/repro/kernels/group_cumulants.py:57",
    "polymul": "src/repro/kernels/polymul.py:34",
}
SOURCES = {
    "logcf": "src/repro_torch/kernels/csrc/logcf.cu",
    "group_logcf": "src/repro_torch/kernels/csrc/group_logcf.cu",
    "cumulant_sums": "src/repro_torch/kernels/csrc/cumulants.cu",
    "group_cumulant_sums": "src/repro_torch/kernels/csrc/group_cumulants.cu",
    "polymul": "src/repro_torch/kernels/csrc/polymul.cu",
}
#: the __global__ functions each kernel's C entry launches, and how many
#: launches one wrapper call makes (csrc/*.cu).  group_logcf launches
#: cf_partial only where a group has more than SHORT_MAX tuples: 2 at the
#: Q18 shape, 3 with long groups.  group_cumulant_sums makes 2 launches on
#: route (a) (cumulants.cu, at most NO_SORT_MAX groups) and 3 on route (b)
#: (group_cumulants.cu).  polymul makes one launch (polymul_cluster) for a
#: product below polymul.WIDE_BLOCKS_FROM multiply-adds, two above it.
GLOBALS = {
    "logcf": (("cf_twiddles", "cf_partial", "cf_mirror_sum"), 3),
    "group_logcf": (("cf_twiddles", "cf_partial", "group_logcf_direct"), 2),
    "cumulant_sums": (("cumulant_tiles", "cumulant_rows_sum"), 2),
    "group_cumulant_sums": (("cumulant_tiles", "cumulant_rows_sum",
                             "cumulant_group_bounds", "group_cumulants_pieces",
                             "group_cumulants_direct"), 3),
    "polymul": (("polymul_cluster", "polymul_partial", "polymul_fold"), 2),
}
#: the five kernels redesigned since their first CUDA design: their ``ms``
#: counts every device operation of a wrapper call (the wrapper's own
#: casts and, on route (b) of group_cumulant_sums, its sort included).
#: Values: the first design's kernel ms and wrapper ms on the same shapes
#: (PERF.md's kernel table, "earlier" column; group_cumulant_sums at Q3's
#: shape, EARLIER_Q1 at Q1's; polymul at 1001 x 1001), measured on
#: EARLIER_CARD; printed beside
#: this run's times, never in the kernels line.
REDESIGNED = {"logcf": (21.966, 22.129), "group_logcf": (1.645, 2.177),
              "cumulant_sums": (0.0314, 0.0362),
              "group_cumulant_sums": (0.307, 0.819),
              "polymul": (0.0101, 0.0257)}
EARLIER_Q1 = (0.038, 0.690)
EARLIER_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: float ops per (frequency, tuple) pair of a CF term as the kernels form
#: it: re = q + p cos (FMA = 2), im = p sin, |.|^2 (FMA + multiply = 3),
#: the clamp, logf, atan2f and the two accumulating adds.  The phase is
#: integer work and the twiddle a table read; 1 - p is formed once per
#: tuple and the halving once per output.  A transcendental counts as one
#: op, so the bound is a lower bound.
CF_OPS_PER_PAIR = 11


def cumulant_ops_per_tuple(orders: int) -> int:
    """Horner over each kappa_j's own degree j (j FMAs, 2 ops each), v^j
    (orders - 1 multiplies) and the accumulating FMAs (2 * orders)."""
    return orders * orders + 4 * orders - 1


def cumulant_witness(p, v, g, num_groups: int, orders: int) -> tuple:
    """What the cumulant kernels are held to, per group (g None: one
    group), in float64, in slices of 2^24 tuples: the plain version's sums
    evaluated in float64 on the same float32 inputs, and the
    absolute-coefficient scale sum_i sum_d |c_jd| p_i^d |v_i|^j.  The
    kernels are conditioning-limited, so they are held to 1e-5 of the
    scale.  The float32 run of the plain version is no witness at this
    size: its index_add_ adds a group's terms by float32 atomics, in an
    order that changes from run to run, and at a 750,000-tuple group errs
    by more than 1e-5 of the scale itself (reported beside each check)."""
    import numpy as np
    import torch
    from repro_torch.core.approx import _bernoulli_cumulant_polys
    from repro_torch.kernels import ref
    dev = p.device
    signed = torch.as_tensor(_bernoulli_cumulant_polys()[
        1:orders + 1, :orders + 1], dtype=torch.float64, device=dev)
    want = torch.zeros((num_groups, orders), dtype=torch.float64, device=dev)
    scale = torch.zeros_like(want)
    for lo in range(0, p.shape[0], 1 << 24):
        sl = slice(lo, lo + (1 << 24))
        pw = p[sl].double()[None, :] ** torch.arange(
            orders + 1, device=dev, dtype=torch.float64)[:, None]
        vp = v[sl].double()[None, :] ** torch.arange(
            1, orders + 1, device=dev, dtype=torch.float64)[:, None]
        for out, rows in ((want, ((signed @ pw) * vp).T),
                          (scale, ((signed.abs() @ pw) * vp.abs()).T)):
            out += rows.sum(0) if g is None else ref.segment_sum(
                rows, g[sl], num_groups)
    return want, scale


def cumulant_rel_err(got, want, scale) -> float:
    """Max |got - want| / scale (scale at least 1), got shaped like want or
    flat."""
    return float(((got.double() - want.double()).abs()
                  / scale.clamp(min=1).reshape(want.shape)).max())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches after one
    warm-up call (CUDA events around the whole run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(name: str, fn, reps: int, per_call: int | None = None
              ) -> tuple:
    """Device ms per call of ``fn`` from the profiler's kernel rows: in
    kernel ``name``'s own __global__ launches, and in every device
    operation of the call (the wrapper's set-up too).  Returns (own ms,
    all ms, launches seen, launches expected, {kernel row: launches})."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    names, default_per_call = GLOBALS[name]
    pattern = re.compile(r"(?<!\w)(" + "|".join(names) + r")(?!\w)")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # A short spin kernel before and after the calls: a session's
        # first or last kernel row has gone missing (one of 20 polymul
        # calls at 1 x 16,384 in four sessions of four); the spins' rows
        # are left out of every sum below.
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    us, all_us, seen, rows = 0.0, 0.0, 0, {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or "spin_kernel" in e.key):
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        all_us += t
        if pattern.search(e.key):
            us += t
            seen += e.count
            rows[e.key[:80]] = rows.get(e.key[:80], 0) + e.count
    return (us / 1e3 / reps, all_us / 1e3 / reps, seen,
            reps * (per_call or default_per_call), rows)


def timings(name: str, fn, reps: int, per_call: int | None = None,
            launched=None) -> dict:
    """The kernel's device ms (``ms``: its own __global__ launches, or for
    a REDESIGNED kernel every device operation of the wrapper call; both
    kept as ``own_ms`` and ``device_ms``) and the wrapper's ms as the main
    path calls it (``wrapper_ms``, CUDA events around whole calls).

    The profiler now and then loses kernel rows of a session (13 of 15
    launches of 6.7 ms logcf calls seen once, 10 of 20 of 0.26 ms
    cumulant_sums calls once, all 40 of polymul's once, and all of a
    polymul shape's in four sessions running), so a kernel whose rows
    fall short is profiled again, at most four times in all.  If every
    session fell short, ``ms`` is the CUDA-event time of whole calls, an
    upper bound of the device time (``timed_by`` says which clock), and
    the launch is proved by ``launched()``: by default that one call of
    ``fn`` adds to the wrapper's own launch count."""
    import torch
    for attempt in range(1, 5):
        own, dev_ms, seen, expected, rows = kernel_ms(name, fn, reps,
                                                      per_call)
        if seen == expected or (name not in REDESIGNED and seen > 0):
            break
        print(f"{name}: the profiler saw {seen} of {expected} launches "
              f"({rows}); profiling again" if attempt < 4 else
              f"{name}: the profiler saw {seen} of {expected} launches "
              f"({rows}) in four sessions; timing with CUDA events")
    wrapper_ms = cuda_ms(fn, reps)
    profiled = seen == expected or (name not in REDESIGNED and seen > 0)
    if not profiled:
        if launched is None:
            from repro_torch.kernels import ops

            def launched():
                before = ops.launches()[name]
                fn()
                torch.cuda.synchronize()
                return ops.launches()[name] > before
        check(launched(), f"{name}: neither the profiler nor the wrapper's "
              f"count saw a launch of {GLOBALS[name][0]}")
        own = dev_ms = wrapper_ms
    return dict(ms=dev_ms if name in REDESIGNED else own, own_ms=own,
                device_ms=dev_ms, wrapper_ms=wrapper_ms,
                timed_by="profiler" if profiled else "cuda_events",
                profiled_launches=seen, expected_launches=expected,
                profile_attempts=attempt)


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def wrapped_angle_err(got, want):
    import torch
    d = (got.double() - want.double() + torch.pi) % (2 * torch.pi) - torch.pi
    return d.abs()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------- kernels
def cf_plain_sums(p, v, k, num_freq) -> tuple:
    """The plain terms of a scalar CF at frequencies ``k`` summed in
    float64: (log-abs, angle, sum |log-abs term|, sum |angle term|)."""
    from repro_torch.kernels import ref
    tl, ta = ref._cf_terms(p[None, :], v[None, :], k[:, None].double(),
                           num_freq)
    tl, ta = tl.double(), ta.double()
    return tl.sum(-1), ta.sum(-1), tl.abs().sum(-1), ta.abs().sum(-1)


def cf_window_errors(la, an, p, v, num_freq, starts, width) -> tuple:
    """Max abs errors (log-abs, angle mod 2 pi) of a scalar CF on the
    frequency windows [s, s + width) against the plain terms summed in
    float64, and the max error over sum |term| (at least 1)."""
    import torch
    err_la, err_an, rel = 0.0, 0.0, 0.0
    for lo in starts:
        k = lo + torch.arange(width, device=p.device)
        w_la, w_an, s_la, s_an = cf_plain_sums(p, v, k, num_freq)
        e_la = (la[k].double() - w_la).abs()
        e_an = wrapped_angle_err(an[k], w_an)
        err_la = max(err_la, float(e_la.max()))
        err_an = max(err_an, float(e_an.max()))
        rel = max(rel, float((e_la / s_la.clamp(min=1)).max()),
                  float((e_an / s_an.clamp(min=1)).max()))
    return err_la, err_an, rel


def cf_gap(la, an, la2, an2, p, v, num_freq, starts, width) -> float:
    """Max |difference| of two scalar CFs (log-abs, angle mod 2 pi) on the
    frequency windows [s, s + width), over sum |term| (at least 1)."""
    import torch
    rel = 0.0
    for lo in starts:
        k = lo + torch.arange(width, device=p.device)
        _, _, s_la, s_an = cf_plain_sums(p, v, k, num_freq)
        e_la = (la[k].double() - la2[k].double()).abs()
        e_an = wrapped_angle_err(an[k], an2[k])
        rel = max(rel, float((e_la / s_la.clamp(min=1)).max()),
                  float((e_an / s_an.clamp(min=1)).max()))
    return rel


def against_earlier(name: str, t: dict, label: str = "",
                    earlier: tuple | None = None) -> str:
    ms, wrapper_ms = earlier or REDESIGNED[name]
    return (f"{name}{label} redesigned: kernel {t['ms']:.4f} ms (own "
            f"launches {t['own_ms']:.4f} ms), wrapper {t['wrapper_ms']:.4f} "
            f"ms on {card_line()}; first design: kernel {ms} ms, wrapper "
            f"{wrapper_ms} ms on {EARLIER_CARD}")


def table_ab(fn, reps: int) -> dict:
    """Device ms of a logcf call (every device op, as ``ms``) with the
    twiddle table in shared memory, as the wrapper places it up to
    ``pb_cf.DIRECT_TABLE_MAX`` entries, and in device memory, the path
    above it; run shared, device, device, shared and averaged per side."""
    from repro_torch.kernels import pb_cf
    keep = pb_cf.DIRECT_TABLE_MAX
    got = {"shared_ms": [], "device_ms": []}
    try:
        for side in ("shared_ms", "device_ms", "device_ms", "shared_ms"):
            pb_cf.DIRECT_TABLE_MAX = keep if side == "shared_ms" else 0
            got[side].append(timings("logcf", fn, reps)["device_ms"])
    finally:
        pb_cf.DIRECT_TABLE_MAX = keep
    out = {k: sum(v) / len(v) for k, v in got.items()}
    out["device_over_shared"] = out["device_ms"] / out["shared_ms"]
    return out


def print_table_ab(label: str, ab: dict) -> None:
    print(f"{label} twiddle table: shared memory {ab['shared_ms']:.4f} ms, "
          f"device memory {ab['device_ms']:.4f} ms (x"
          f"{ab['device_over_shared']:.3f})")


def group_skew_cases(put, dev) -> dict:
    """group_logcf beyond Q18's shape: a skewed chunk (three groups of
    100,000 tuples, groups of SHORT_MAX and SHORT_MAX + 1, of 1, 2 and 4
    tuples, 1.3M empty groups; the window ending at N - 1), the two
    extremes -- 8 groups of 100,000 tuples, and 1.5M groups of 1-4 tuples
    -- and 1.5M empty groups (the output pass alone), each against the
    plain terms summed in float64 per group (tolerance 2e-5 of sum
    |term|), bit-equal on a rerun, timed with hoisted operands (cf_partial
    runs where a group is longer than SHORT_MAX)."""
    import numpy as np
    import torch
    from repro_torch.kernels import group_cf, ref
    rng = np.random.default_rng(2)
    short = group_cf.SHORT_MAX
    mixed = np.zeros(Q18_GROUPS, np.int64)
    slots = rng.permutation(Q18_GROUPS)
    at = 0
    for size, count in ((100_000, 3), (short, 1000), (short + 1, 1000),
                        (1, 100_000), (2, 50_000), (4, 37_500)):
        mixed[slots[at:at + count]] = size
        at += count
    cases = (("skewed", mixed, 256, 256 - 89, 89),
             ("8 x 100,000", np.full(8, 100_000), 256, 89, 89),
             ("1.5M x 1-4", rng.integers(1, 5, Q18_GROUPS), 256, 89, 89),
             ("no tuples", np.zeros(Q18_GROUPS, np.int64), 256, 89, 89))
    out = {}
    for label, sizes, nf, lo, cnt in cases:
        G = sizes.shape[0]
        gids = np.repeat(np.arange(G), sizes)
        rng.shuffle(gids)
        n = gids.shape[0]
        p = put(rng.uniform(0.0, 1.0, n), torch.float32)
        v = put(rng.integers(1, 51, n), torch.int64)
        g = put(gids, torch.int64)
        ops_ = group_cf.presort_operands(p, v, g, nf, G)
        run = lambda: group_cf.group_logcf(
            p, v, g, num_groups=G, num_freq=nf, freq_lo=lo, freq_cnt=cnt,
            operands=ops_)
        long_groups = bool((sizes > short).any())
        t = timings("group_logcf", run, 5, per_call=3 if long_groups else 2)
        la, an = run()
        check(bit_equal((la, an), run()),
              f"group_logcf {label}: rerun is not bit-equal")
        kk = lo + torch.arange(cnt, dtype=torch.float64, device=dev)
        tl, ta = ref._cf_terms(p[:, None], v[:, None], kk[None, :], nf)
        rel = 0.0
        for got, terms, angle in ((la, tl, False), (an, ta, True)):
            terms = terms.double()
            want = ref.segment_sum(terms, g, G)
            scale = ref.segment_sum(terms.abs(), g, G).clamp(min=1)
            err = (wrapped_angle_err(got, want) if angle
                   else (got.double() - want).abs())
            rel = max(rel, float((err / scale).max()))
            del terms, want, scale, err
        del tl, ta
        b = bound_ms(n * 12 + 2 * G * cnt * 4, n * cnt * CF_OPS_PER_PAIR)
        out[label] = dict(n=n, groups=G, window=[lo, lo + cnt], ms=t["ms"],
                          wrapper_ms=t["wrapper_ms"], bound_ms=b[0],
                          bound_by=b[1], max_err_over_sum_abs=rel)
        print(f"group_logcf {label}: n={n} G={G} N={nf} window=[{lo},"
              f"{lo + cnt}) kernel {t['ms']:.4f} ms, wrapper "
              f"{t['wrapper_ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); max "
              f"err / sum|term| {rel:.3e} (tolerance 2e-5); bit-equal rerun")
        check(rel <= 2e-5, f"group_logcf {label} disagrees: {rel}")
        del p, v, g, ops_, la, an
    return out


def group_cumulant_skew_cases(put) -> dict:
    """group_cumulant_sums beyond Q1's and Q3's shapes, as the path calls
    it (unsorted operands), orders = 8, 30% of the tuples with p = 0: G at
    the no-sort bucket (route (a)) and one above it (route (b)), 1.5M
    groups of 1-4 tuples, one 750,000-tuple group among Q3's 262,144, and
    groups of exactly SHORT_MAX and SHORT_MAX + 1 tuples with an empty
    group after each pair; each within 1e-5 of the absolute-coefficient
    scale of the plain version in float64 (cumulant_witness), its empty
    rows exactly zero, bit-equal on a rerun, timed."""
    import numpy as np
    import torch
    from repro_torch.kernels import group_cumulants
    rng = np.random.default_rng(3)
    orders = 8
    short, bucket = group_cumulants.SHORT_MAX, group_cumulants.NO_SORT_MAX
    pairs = np.zeros(60_000, np.int64)
    pairs[0::3], pairs[1::3] = short, short + 1
    one = np.zeros(Q3_GROUPS, np.int64)
    one[Q3_GROUPS // 3] = CHUNK
    cases = (("G = NO_SORT_MAX", np.full(bucket, CHUNK // bucket)),
             ("G = NO_SORT_MAX + 1", np.full(bucket + 1,
                                             CHUNK // (bucket + 1))),
             ("1.5M x 1-4", rng.integers(1, 5, Q18_GROUPS)),
             ("one 750,000-tuple group", one),
             ("SHORT_MAX, SHORT_MAX + 1, empty", pairs))
    out = {}
    for label, sizes in cases:
        G = sizes.shape[0]
        gids = np.repeat(np.arange(G), sizes)
        rng.shuffle(gids)
        n = gids.shape[0]
        pr = rng.uniform(0.0, 1.0, n)
        pr[rng.uniform(0.0, 1.0, n) < 0.3] = 0.0
        p = put(pr, torch.float32)
        v = put(rng.integers(1, 51, n), torch.float32)
        g = put(gids, torch.int64)
        run = lambda: group_cumulants.group_cumulant_sums(
            p, v, g, num_groups=G, orders=orders)
        route = "a" if G <= bucket else "b"
        t = timings("group_cumulant_sums", run, 5,
                    per_call=2 if route == "a" else 3)
        got = run()
        check(bit_equal(got, run()),
              f"group_cumulant_sums {label}: rerun is not bit-equal")
        want, scale = cumulant_witness(p, v, g, G, orders)
        rel = cumulant_rel_err(got, want, scale)
        rel_plain = cumulant_rel_err(group_cumulants.group_cumulant_sums_plain(
            p, v, g, G, orders), want, scale)
        empty = put(np.flatnonzero(sizes == 0), torch.int64)
        zero = not bool(got[empty].view(torch.int32).any())
        b = bound_ms(n * 16 + G * orders * 4,
                     n * cumulant_ops_per_tuple(orders))
        out[label] = dict(n=n, groups=G, grouped_route=route, ms=t["ms"],
                          own_ms=t["own_ms"], wrapper_ms=t["wrapper_ms"],
                          bound_ms=b[0], bound_by=b[1],
                          max_err_over_scale=rel,
                          plain_float32_max_err_over_scale=rel_plain,
                          empty_groups=int(empty.shape[0]))
        print(f"group_cumulant_sums {label}: n={n} G={G} route ({route}) "
              f"kernel {t['ms']:.4f} ms (own launches {t['own_ms']:.4f} ms), "
              f"wrapper {t['wrapper_ms']:.4f} ms, bound {b[0]:.4f} ms "
              f"({b[1]}); max err / scale {rel:.3e} (tolerance 1e-5; float32 "
              f"plain {rel_plain:.3e}); {int(empty.shape[0])} empty groups "
              f"{'exactly zero' if zero else 'NOT ZERO'}; bit-equal rerun")
        check(rel <= 1e-5, f"group_cumulant_sums {label} disagrees: {rel}")
        check(zero, f"group_cumulant_sums {label}: an empty group is not 0")
        del p, v, g, got, want, scale
    return out


def kernel_phase(dev, rng) -> dict:
    """Each kernel against its plain version at the SF1 path's shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels import (cumulants, group_cf, group_cumulants,
                                     pb_cf, ref)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def probs(n, live):
        """Q-shaped masked probabilities: a share `live` of rows alive."""
        p = rng.uniform(0.0, 1.0, n)
        return put(np.where(rng.uniform(0, 1, n) < live, p, 0.0),
                   torch.float32)

    rows = {}

    # 1. logcf at Q6's shape: N = 4096, one chunk of 750,000 tuples.  The
    # plain (N, n) tile does not fit, so the timed launch is held against
    # the plain terms on three frequency windows at full n -- both ends and
    # the seam of the mirrored half around N/2 (terms as the plain version
    # computes them, summed in float64); the plain version is timed on a
    # tuple prefix.
    n, nf, prefix, win = CHUNK, 4096, 65_536, 128
    half = nf // 2 + 1
    p = probs(n, 0.05)
    v = put(rng.integers(0, 162, n), torch.int64)
    run = lambda: pb_cf.logcf(p, v, num_freq=nf)
    t = timings("logcf", run, 10)
    la, an = run()
    check(bit_equal((la, an), run()), "logcf: rerun is not bit-equal")
    windows = (0, nf // 2 - win // 2, nf - win)
    err_la, err_an, rel = cf_window_errors(la, an, p, v, nf, windows, win)
    plain_ms = cuda_ms(lambda: pb_cf.logcf_plain(p[:prefix], v[:prefix], nf),
                       3)
    ms_prefix = timings("logcf", lambda: pb_cf.logcf(
        p[:prefix], v[:prefix], num_freq=nf), 10)["ms"]
    # The least work: the live tuples (p != 0; the kernel skips the rest
    # bit-identically) at the N/2 + 1 frequencies it computes.
    live = int((p != 0).sum())
    b = bound_ms(n * (4 + 4) + 2 * nf * 4, live * half * CF_OPS_PER_PAIR)
    print(f"logcf: n={n} N={nf} ({live} live tuples) kernel {t['ms']:.4f} "
          f"ms (own launches {t['own_ms']:.4f} ms), wrapper "
          f"{t['wrapper_ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); vs "
          f"plain on frequency windows {windows} x {win} at full n: max err "
          f"{err_la:.3e} (log-abs) {err_an:.3e} (angle mod 2pi), max err / "
          f"sum|term| {rel:.3e} (tolerance 2e-5); on the prefix "
          f"n={prefix}: kernel {ms_prefix:.4f} ms vs plain {plain_ms:.4f} "
          "ms; bit-equal rerun")
    check(rel <= 2e-5, f"logcf disagrees with its plain version: {rel}")
    ab = table_ab(run, 10)
    print_table_ab(f"logcf n={n} N={nf}", ab)
    # The same shape with every tuple live, and with values that are all
    # multiples of 64 (every table read of a warp conflicts 16 ways).
    rng2 = np.random.default_rng(1)
    variants = {}
    p_all = put(rng2.uniform(1e-6, 1.0, n), torch.float32)
    v64 = put(rng2.integers(0, 64, n) * 64, torch.int64)
    for label, pv, vv in (("all live", p_all, v), ("values 64 apart", p_all,
                                                   v64)):
        tv = timings("logcf", lambda: pb_cf.logcf(pv, vv, num_freq=nf), 5)
        la_v, an_v = pb_cf.logcf(pv, vv, num_freq=nf)
        errs = cf_window_errors(la_v, an_v, pv, vv, nf, windows, win)
        bv = bound_ms(n * (4 + 4) + 2 * nf * 4, n * half * CF_OPS_PER_PAIR)
        abv = table_ab(lambda: pb_cf.logcf(pv, vv, num_freq=nf), 5)
        print_table_ab(f"logcf {label}", abv)
        variants[label] = dict(ms=tv["ms"], wrapper_ms=tv["wrapper_ms"],
                               bound_ms=bv[0], bound_by=bv[1],
                               max_err_over_sum_abs=errs[2],
                               twiddle_table=abv)
        print(f"logcf {label}: n={n} N={nf} kernel {tv['ms']:.4f} ms, "
              f"wrapper {tv['wrapper_ms']:.4f} ms, bound {bv[0]:.4f} ms "
              f"({bv[1]}); max err / sum|term| {errs[2]:.3e} (tolerance "
              "2e-5)")
        check(errs[2] <= 2e-5, f"logcf {label} disagrees: {errs[2]}")
    del p_all, v64, la_v, an_v
    # The value layer's COUNTs (odd N = 1001 and 401) and N = 1, 2.  The
    # kernel computes k <= N/2 and mirrors the rest, so: the computed half
    # against the plain version (tolerance 2e-5 of sum|term|), the mirror
    # identity bit for bit, and every frequency of the kernel against a
    # float64 witness (the terms in float64: p, angle and trig; tolerance
    # 2e-5 of sum|term|).  The mirrored half against the plain version and
    # the plain version against the witness are reported: the plain
    # version rounds the angle to float32 at k and at N - k separately, so
    # it is not exactly conjugate-symmetric.
    small = {}
    for n3, nf3 in ((1000, 1001), (400, 401), (1000, 2), (1000, 1)):
        p3 = put(rng2.uniform(0.0, 1.0, n3), torch.float32)
        v3 = torch.ones(n3, dtype=torch.int64, device=dev)
        la3, an3 = pb_cf.logcf(p3, v3, num_freq=nf3)
        check(bit_equal((la3, an3), pb_cf.logcf(p3, v3, num_freq=nf3)),
              f"logcf N={nf3}: rerun is not bit-equal")
        h3 = nf3 // 2 + 1
        k3 = torch.arange(nf3, device=dev)
        w_la, w_an, s_la, s_an = cf_plain_sums(p3, v3, k3, nf3)
        s_la, s_an = s_la.clamp(min=1), s_an.clamp(min=1)
        rel3 = torch.maximum((la3.double() - w_la).abs() / s_la,
                             wrapped_angle_err(an3, w_an) / s_an)
        e3 = float(rel3[:h3].max())
        mk = k3[h3:]
        mirror_ok = bool(torch.equal(la3[mk], la3[nf3 - mk])
                         and torch.equal(an3[mk], -an3[nf3 - mk]))
        em = float(rel3[h3:].max()) if nf3 > h3 else 0.0
        x_la, x_an, x_sla, x_san = cf_plain_sums(p3.double(), v3, k3, nf3)
        x_sla, x_san = x_sla.clamp(min=1), x_san.clamp(min=1)

        def vs_witness(got_la, got_an):
            return torch.maximum((got_la.double() - x_la).abs() / x_sla,
                                 wrapped_angle_err(got_an, x_an) / x_san)
        kx = vs_witness(la3, an3)
        px = vs_witness(w_la, w_an)
        e64, p64 = float(kx.max()), float(px.max())
        km = float(kx[h3:].max()) if nf3 > h3 else 0.0
        pm = float(px[h3:].max()) if nf3 > h3 else 0.0
        t3 = timings("logcf", lambda: pb_cf.logcf(p3, v3, num_freq=nf3), 20)
        small[f"n={n3} N={nf3}"] = dict(
            ms=t3["ms"], wrapper_ms=t3["wrapper_ms"],
            max_err_over_sum_abs=e3, mirrored_max_err_over_sum_abs=em,
            float64_max_err_over_sum_abs=e64,
            float64_mirrored_max_err_over_sum_abs=km,
            plain_float64_max_err_over_sum_abs=p64,
            plain_float64_mirrored_max_err_over_sum_abs=pm)
        print(f"logcf COUNT n={n3} N={nf3}: kernel {t3['ms']:.4f} ms, "
              f"wrapper {t3['wrapper_ms']:.4f} ms; k <= N/2 vs plain: max "
              f"err / sum|term| {e3:.3e} (tolerance 2e-5); mirror identity "
              f"{'exact' if mirror_ok else 'BROKEN'}; every k vs float64 "
              f"{e64:.3e} (tolerance 2e-5); reported: k > N/2 vs plain "
              f"{em:.3e}, k > N/2 vs float64 {km:.3e} (plain {pm:.3e}), "
              f"plain vs float64 at every k {p64:.3e}; bit-equal rerun")
        check(e3 <= 2e-5, f"logcf N={nf3} disagrees: {e3}")
        check(mirror_ok, f"logcf N={nf3}: mirror identity broken")
        check(e64 <= 2e-5, f"logcf N={nf3} disagrees with float64: {e64}")
    # Phase exactness at N = 2^20 with values up to N - 1.
    n2, nf2 = 256, 1 << 20
    p2 = put(rng.uniform(0.01, 0.99, n2), torch.float32)
    v2 = put(np.concatenate([[nf2 - 1, nf2 - 2, 1], rng.integers(
        0, nf2, n2 - 3)]), torch.int64)
    la2, an2 = pb_cf.logcf(p2, v2, num_freq=nf2)
    pl2, pa2 = pb_cf.logcf_plain(p2, v2, nf2)
    e2 = max(float((la2 - pl2).abs().max()),
             float(wrapped_angle_err(an2, pa2).max()))
    print(f"logcf phase exactness: n={n2} N=2^20 max err {e2:.3e} "
          "(tolerance 2e-3)")
    check(e2 <= 2e-3, f"logcf phase at N=2^20: {e2}")
    # Phase 8 (c)'s model split: two windows of the k <= N/2 columns at
    # Q6's shape, each bit-equal to those columns of the whole launch,
    # mirrored back to the whole launch's bits.
    f_loc = -(-half // 2)
    parts = [pb_cf.logcf(p, v, num_freq=nf, freq_lo=lo_, freq_cnt=cnt_)
             for lo_, cnt_ in ((0, f_loc), (f_loc, half - f_loc))]
    whole = pb_cf.mirror(torch.cat([x[0] for x in parts]),
                         torch.cat([x[1] for x in parts]), nf)
    check(bit_equal(whole, (la, an)), "logcf windows: not the whole "
          "launch's bits")
    print(f"logcf windows [0, {f_loc}) and [{f_loc}, {half}) of n={n} "
          f"N={nf}, mirrored: bit-equal to the whole launch")
    print(against_earlier("logcf", t))
    rows["logcf"] = dict(
        max_abs_err=max(err_la, err_an, e2), **t, plain_ms=plain_ms,
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        shape=f"n={n} N={nf} ({live} live)",
        compare_shape=(f"n={n} N={nf} frequency windows {windows} x {win}; "
                       f"n={n2} N=2^20; every frequency of the COUNTs"),
        plain_shape=f"n={prefix} N={nf}", prefix_ms=ms_prefix,
        max_err_over_sum_abs=rel, variants=variants, value_layer=small,
        twiddle_table=ab)
    del p, v, la, an, parts, whole

    # 2. group_logcf at Q18's shape: 187,500 orders x 4 rows per chunk,
    # G = 1.5M, N = 256, the middle frequency slab [89, 178).
    n, G, nf, lo, cnt = CHUNK, Q18_GROUPS, 256, 89, 89
    p = probs(n, 1.0)
    v = put(rng.integers(1, 51, n), torch.int64)
    # chunk 2 of the canonical grid: orders [375000, 562500)
    g = put(np.repeat(np.arange(n // 4) + min(2 * (n // 4), G - n // 4), 4),
            torch.int64)
    ops_ = group_cf.presort_operands(p, v, g, nf, G)
    run = lambda: group_cf.group_logcf(p, v, g, num_groups=G, num_freq=nf,
                                       freq_lo=lo, freq_cnt=cnt,
                                       operands=ops_)
    t = timings("group_logcf", run, 10)      # operands hoisted, as the path
    la, an = run()
    check(bit_equal((la, an), run()), "group_logcf: rerun is not bit-equal")
    kk = lo + torch.arange(cnt, dtype=torch.float64, device=dev)
    tl, ta = ref._cf_terms(p[:, None], v[:, None], kk[None, :], nf)
    want_la = ref.segment_sum(tl, g, G)
    want_an = ref.segment_sum(ta, g, G)
    sc_la = ref.segment_sum(tl.abs(), g, G).clamp(min=1)
    sc_an = ref.segment_sum(ta.abs(), g, G).clamp(min=1)
    err_la = (la - want_la).abs()
    err_an = wrapped_angle_err(an, want_an)
    rel = max(float((err_la / sc_la).max()), float((err_an / sc_an).max()))
    del tl, ta, want_la, want_an, sc_la, sc_an
    plain_ms = cuda_ms(lambda: group_cf.group_logcf_plain(
        p, v, g, G, nf, lo, cnt), 3)
    b = bound_ms(n * 12 + 2 * G * cnt * 4, n * cnt * CF_OPS_PER_PAIR)
    print(f"group_logcf: n={n} G={G} N={nf} window=[{lo},{lo + cnt}) "
          f"kernel {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms vs "
          f"plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); max err "
          f"{float(err_la.max()):.3e} / {float(err_an.max()):.3e}, max err / "
          f"sum|term| {rel:.3e} (tolerance 2e-5); bit-equal rerun")
    check(rel <= 2e-5, f"group_logcf disagrees with its plain version: {rel}")
    skew = group_skew_cases(put, dev)
    print(against_earlier("group_logcf", t))
    rows["group_logcf"] = dict(
        max_abs_err=max(float(err_la.max()), float(err_an.max())), **t,
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
        shape=f"n={n} G={G} N={nf} cnt={cnt}", max_err_over_sum_abs=rel,
        skew=skew)
    del p, v, g, ops_, la, an

    # 3./4. cumulants: Q6's scalar rider and Q1's / Q3's grouped riders,
    # orders = 8, held to the plain version in float64 within 1e-5 of the
    # absolute-coefficient scale (cumulant_witness).
    orders = 8
    n = CHUNK
    p = probs(n, 0.05)
    v = put(rng.integers(0, 162, n), torch.float32)
    run = lambda: cumulants.cumulant_sums(p, v, orders=orders)
    t = timings("cumulant_sums", run, 20)
    got = run()
    check(bit_equal(got, run()), "cumulant_sums: rerun is not bit-equal")
    want, scale = cumulant_witness(p, v, None, 1, orders)
    rel = cumulant_rel_err(got, want, scale)
    rel_plain = cumulant_rel_err(cumulants.cumulant_sums_plain(p, v, orders),
                                 want, scale)
    plain_ms = cuda_ms(lambda: cumulants.cumulant_sums_plain(p, v, orders),
                       10)
    b = bound_ms(n * 8 + orders * 4, n * cumulant_ops_per_tuple(orders))
    print(f"cumulant_sums: n={n} orders={orders} kernel {t['ms']:.4f} ms "
          f"(own launches {t['own_ms']:.4f} ms), wrapper "
          f"{t['wrapper_ms']:.4f} ms vs plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]}); max err / scale {rel:.3e} (tolerance "
          f"1e-5; float32 plain {rel_plain:.3e}); bit-equal rerun")
    check(rel <= 1e-5, f"cumulant_sums disagrees with its plain version: "
          f"{rel}")
    print(against_earlier("cumulant_sums", t))
    rows["cumulant_sums"] = dict(
        max_abs_err=float((got.double() - want[0]).abs().max()), **t,
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
        shape=f"n={n} orders={orders}", max_err_over_scale=rel,
        plain_float32_max_err_over_scale=rel_plain)

    for label, G, live, vmax in (("Q1", 8, 0.6, 51), ("Q3", Q3_GROUPS, 0.05,
                                                      10_000)):
        p = probs(n, live)
        v = put(rng.integers(1, vmax, n), torch.float32)
        if G == 8:
            g = put(rng.integers(0, 6, n), torch.int64)
        else:   # consecutive orders of 4 rows; dead rows in the fill bucket
            g = torch.arange(n, device=dev) // 4
            g = torch.where(p > 0, g % (G - 1), torch.full_like(g, G - 1))
        g = torch.where(p > 0, g, torch.full_like(g, G - 1))
        # As the path calls it: unsorted operands (route (b) sorts inside).
        run = lambda: group_cumulants.group_cumulant_sums(
            p, v, g, num_groups=G, orders=orders)
        route = "a" if G <= group_cumulants.NO_SORT_MAX else "b"
        t = timings("group_cumulant_sums", run, 20,
                    per_call=2 if route == "a" else 3)
        got = run()
        check(bit_equal(got, run()),
              f"group_cumulant_sums ({label}): rerun is not bit-equal")
        want, scale = cumulant_witness(p, v, g, G, orders)
        rel = cumulant_rel_err(got, want, scale)
        rel_plain = cumulant_rel_err(group_cumulants.group_cumulant_sums_plain(
            p, v, g, G, orders), want, scale)
        plain_ms = cuda_ms(lambda: group_cumulants.group_cumulant_sums_plain(
            p, v, g, G, orders), 10)
        b = bound_ms(n * 16 + G * orders * 4,
                     n * cumulant_ops_per_tuple(orders))
        print(f"group_cumulant_sums ({label}, route ({route})): n={n} G={G} "
              f"orders={orders} kernel {t['ms']:.4f} ms (own launches "
              f"{t['own_ms']:.4f} ms), wrapper {t['wrapper_ms']:.4f} ms vs "
              f"plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); max "
              f"err / scale {rel:.3e} (tolerance 1e-5; float32 plain "
              f"{rel_plain:.3e}); bit-equal rerun")
        check(rel <= 1e-5, f"group_cumulant_sums ({label}) disagrees: {rel}")
        print(against_earlier("group_cumulant_sums", t, f" ({label})",
                              EARLIER_Q1 if label == "Q1" else None))
        rows[f"group_cumulant_sums_{label}"] = dict(
            max_abs_err=float((got.double() - want).abs().max()), **t,
            plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            library_ms=None, shape=f"n={n} G={G} orders={orders}",
            grouped_route=route, max_err_over_scale=rel,
            plain_float32_max_err_over_scale=rel_plain)
    rows["group_cumulant_sums"] = rows.pop("group_cumulant_sums_Q3")
    rows["group_cumulant_sums"]["q1_shape"] = rows.pop(
        "group_cumulant_sums_Q1")
    rows["group_cumulant_sums"]["skew"] = group_cumulant_skew_cases(put)
    rows["polymul"] = polymul_rows(put, rng)
    rows["polymul"]["routes"] = polymul_routes(put, rng)
    return rows


def polymul_edge_shapes() -> list:
    """Edge shapes of the polymul kernel: a factor of one coefficient, the
    asymmetric products, and the shapes at a tile and a slice boundary of
    ``polymul.tiling`` and one past either side (output lengths around a
    multiple of the 384-output tiles of the cluster route and the
    1536-output tiles of the two-launch route; shorter factors around a
    multiple of the 32- and 64-value slices)."""
    from repro_torch.kernels import polymul
    small = polymul.tiling(128, 1000).tile
    wide = polymul.tiling(8192, 16_384).tile
    s32 = polymul.tiling(32, 1000).slice
    s64 = polymul.tiling(960, 960).slice
    k64 = 960 // s64 * s64
    shapes = [(1, 1), (1, 16_384), (1024, 128), (16_384, 128)]
    for d in (-1, 0, 1):
        shapes += [(128, small - 127 + d), (8192, 16 * wide - 8191 + d),
                   (s32 + d, 1000), (k64 + d, k64 + d)]
    for na, nb in shapes[4:]:
        tl = polymul.tiling(na, nb)
        check((na + nb - 1) % tl.tile in (tl.tile - 1, 0, 1)
              or min(na, nb) % tl.slice in (tl.slice - 1, 0, 1),
              f"polymul {na}x{nb}: not at a tile or slice boundary ({tl})")
    return shapes


def polymul_rows(put, rng) -> dict:
    """polymul at the value-layer path's shapes (1001 x 1001: two COUNT
    PGFs of 1,000 tuples; 401 x 801: the first product of the grouped SUM)
    and beyond mul_sum's window (1024 x 1024, 128 x 1024, 16,384 x 16,384;
    32,768 x 32,768, where ``tiling`` walks several chunks a slice), then
    at the edge shapes (``polymul_edge_shapes``, a of mixed sign), beside
    conv1d (``library_ms``, TF32 off) and the port's ``fft_convolve``
    (``fft_ms``).  Held against the plain version in float64 relative to
    the per-output scale sum_u |a_u||b_{t-u}|: float32 accumulation in
    increasing u over K terms errs by about eps * sqrt(K) / 6, 1.3e-6 at
    K = 16,384, so the tolerance is 2e-5.  Two runs must give the same
    bits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import pgf
    from repro_torch.kernels import polymul
    shapes = []
    cases = [(na, nb, 0) for na, nb in ((1001, 1001), (401, 801),
                                        (1024, 1024), (128, 1024),
                                        (16_384, 16_384), (32_768, 32_768))]
    cases += [(na, nb, -1) for na, nb in polymul_edge_shapes()]
    for na, nb, a_lo in cases:
        a = put(rng.uniform(a_lo, 1, na), torch.float32)
        b = put(rng.uniform(0, 1, nb), torch.float32)
        run = lambda: polymul.polymul(a, b)
        tl = polymul.tiling(na, nb)
        t = timings("polymul", run, 20, per_call=1 if tl.cluster else 2)
        got = run()
        check(bit_equal(got, run()), f"polymul {na}x{nb}: rerun not bit-equal")
        want = polymul.polymul_plain(a.double(), b.double())
        scale = polymul.polymul_plain(a.double().abs(), b.double())
        err = (got.double() - want).abs()
        rel = float((err / scale.clamp(min=1e-300)).max())
        reps = 2 if na * nb > 1 << 24 else 10
        plain_ms = cuda_ms(lambda: polymul.polymul_plain(a, b), reps)
        conv_ms = cuda_ms(lambda: F.conv1d(
            a[None, None], b.flip(0)[None, None], padding=nb - 1), 20)
        fft_ms = cuda_ms(lambda: pgf.fft_convolve(a, b), 20)
        bd = bound_ms(4 * (2 * na + 2 * nb - 1), 2 * na * nb)
        print(f"polymul {na}x{nb}{' (a of mixed sign)' if a_lo else ''}: "
              f"kernel {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms, "
              f"bound {bd[0]:.3g} ms ({bd[1]}); plain {plain_ms:.4f} ms, "
              f"conv1d {conv_ms:.4f} ms, fft_convolve {fft_ms:.4f} ms; max "
              f"err / scale {rel:.3e} (tolerance 2e-5); bit-equal rerun; "
              f"{tl.threads} threads, {tl.n_tiles} tiles x {tl.n_slices} "
              f"slices of {tl.slice}, "
              + (f"clusters of {tl.cluster}" if tl.cluster else "fold kernel"))
        check(rel <= 2e-5, f"polymul {na}x{nb} disagrees with its plain "
              f"version: {rel}")
        shapes.append(dict(shape=f"{na}x{nb}", **t, plain_ms=plain_ms,
                           library_ms=conv_ms, fft_ms=fft_ms, bound_ms=bd[0],
                           bound_by=bd[1], max_abs_err=float(err.max()),
                           max_err_over_scale=rel, mixed_sign=bool(a_lo),
                           tiling=tl._asdict()))
        if (na, nb) == (1001, 1001):
            print(against_earlier("polymul", t))
    return dict(shapes[0], max_abs_err=max(r["max_abs_err"] for r in shapes),
                shapes=shapes)


def polymul_routes(put, rng) -> dict:
    """polymul's two routes on the same inputs, through the C entry (no
    wrapper, so no launch counted): the cluster route (one launch) and the
    two-launch route (scratch and fold kernel), each with the partition
    ``polymul.tiling`` gives it, at 1001 x 1001 and around the size where
    the wrapper switches (``polymul.WIDE_BLOCKS_FROM``: 8192^2 below it,
    16,384^2 above); each held to 2e-5 of the scale.  On the same
    partition (the cluster route's) the two routes must give the same
    bits."""
    import torch
    from repro_torch.kernels import build, polymul
    out = {}
    for na, nb in ((1001, 1001), (8192, 8192), (16_384, 16_384)):
        a = put(rng.uniform(0, 1, na), torch.float32)
        b = put(rng.uniform(0, 1, nb), torch.float32)
        c = torch.empty(na + nb - 1, dtype=torch.float32, device=a.device)
        want = polymul.polymul_plain(a.double(), b.double())

        def launch(tl, cluster):
            partial = None if cluster else torch.empty(
                tl.n_slices * tl.pitch, dtype=torch.float32, device=a.device)
            return lambda: build.launch(
                "polymul_launch", a.data_ptr(), b.data_ptr(),
                None if partial is None else partial.data_ptr(),
                c.data_ptr(), na, nb, tl.threads, tl.slice, tl.chunk,
                cluster, build.stream_handle(a.device))

        got, ms = {}, {}
        keep = polymul.WIDE_BLOCKS_FROM
        for route, wide_from in (("cluster", 1 << 62), ("two_launches", 0)):
            polymul.WIDE_BLOCKS_FROM = wide_from
            try:
                tl = polymul.tiling(na, nb)
            finally:
                polymul.WIDE_BLOCKS_FROM = keep
            fn = launch(tl, tl.cluster)

            def wrote(fn=fn):
                c.fill_(float("nan"))
                fn()
                return bool(torch.isfinite(c).all())
            ms[route] = timings("polymul", fn, 20,
                                per_call=1 if tl.cluster else 2,
                                launched=wrote)["ms"]
            fn()
            got[route] = c.clone()
            rel = float(((got[route].double() - want).abs()
                         / want.clamp(min=1e-300)).max())
            check(rel <= 2e-5, f"polymul {na}x{nb} {route}: {rel}")
            if route == "cluster":
                launch(tl, 0)()      # the fold kernel on this partition
                check(bit_equal(got[route], c), f"polymul {na}x{nb}: the "
                      "two routes differ on the same partition")
        chosen = "cluster" if polymul.tiling(na, nb).cluster \
            else "two_launches"
        print(f"polymul {na}x{nb} routes: cluster {ms['cluster']:.4f} ms, "
              f"two launches {ms['two_launches']:.4f} ms (the wrapper takes "
              f"{chosen.replace('_', ' ')}); both within 2e-5 of the scale; "
              "the same bits on the same partition")
        out[f"{na}x{nb}"] = dict(ms, chosen=chosen)
    return out


# -------------------------------------------------------------------- path
def run_queries(db, sf1: bool) -> dict:
    """Every query in every mode, plus the exact-CF variants."""
    from repro_torch.db import tpch
    q3_groups = Q3_GROUPS if sf1 else 512
    q18_groups = Q18_GROUPS if sf1 else 2048
    out = {}
    for mode in tpch.MODES:
        out[f"q1/{mode}"] = lambda m=mode: tpch.q1(db, m)
        out[f"q3/{mode}"] = lambda m=mode: tpch.q3(db, m,
                                                   max_groups=q3_groups)
        out[f"q6/{mode}"] = lambda m=mode: tpch.q6(db, m)
        out[f"q18/{mode}"] = lambda m=mode: tpch.q18(
            db, m, max_groups=Q18_NORMAL_GROUPS if sf1 else 2048)
        out[f"q20/{mode}"] = lambda m=mode: tpch.q20(
            db, m, max_groups=Q20_GROUPS if sf1 else 1024)
    out["q6/aggregate_exact"] = lambda: tpch.q6(db, "aggregate",
                                                num_freq=4096)
    out["q18/aggregate_exact"] = lambda: tpch.q18(
        db, "aggregate", method="exact", max_groups=q18_groups,
        num_freq=256, plan_opts=Q18_EXACT_OPTS if sf1 else None)
    return out


def leaves(x, path=""):
    import torch
    if hasattr(x, "columns") and hasattr(x, "prob"):       # a Table
        yield from leaves(dict(columns=x.columns, prob=x.prob,
                               valid=x.valid), path)
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from leaves(x[k], f"{path}.{k}")
    elif isinstance(x, tuple):
        for i, y in enumerate(x):
            yield from leaves(y, f"{path}[{i}]")
    else:
        yield path, torch.as_tensor(x)


def check_finite(name, result) -> None:
    import torch
    for path, t in leaves(result):
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name}{path} not finite")


def bit_equal(a, b) -> bool:
    import torch
    la, lb = list(leaves(a)), list(leaves(b))
    if len(la) != len(lb):
        return False
    for (pa, x), (pb, y) in zip(la, lb):
        if pa != pb or x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_floating_point():
            if not torch.equal(x.view(torch.int32 if x.dtype == torch.float32
                                      else torch.int64),
                               y.view(torch.int32 if y.dtype == torch.float32
                                      else torch.int64)):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def cross_checks(res) -> None:
    """Checks that need no kernel: kappa_1 = p and kappa_2 = p(1-p), so a
    GroupAgg's cumulant columns 0 and 1 are its Normal (mu, var); a valid
    exact-CF row sums to 1 and its mean is the Normal mean of the group."""
    import torch

    def close(a, b, what, rtol=2e-5):
        a, b = a.double(), b.double()
        err = float(((a - b).abs() / b.abs().clamp(min=1)).max())
        print(f"cross-check {what}: max rel err {err:.3e} (tolerance {rtol})")
        check(err <= rtol, f"{what}: {err}")

    q1 = res["q1/aggregate"]
    v = q1["valid"]
    close(q1["cumulants_qty"][v, 0], q1["qty"][0][v], "Q1 kappa1 = mu")
    close(q1["cumulants_qty"][v, 1], q1["qty"][1][v], "Q1 kappa2 = var")
    q3 = res["q3/aggregate"]
    v = q3["valid"]
    close(q3["cumulants"][v, 0], q3["revenue"][0][v], "Q3 kappa1 = mu")
    close(q3["cumulants"][v, 1], q3["revenue"][1][v], "Q3 kappa2 = var")
    q6 = res["q6/aggregate"]
    close(q6["cumulants"][0:1], q6["normal"][0][None], "Q6 kappa1 = mu")
    close(q6["cumulants"][1:2], q6["normal"][1][None], "Q6 kappa2 = var")
    ex = res["q18/aggregate_exact"]
    v = ex["valid"]
    rows = ex["sum_dist"][v].double()
    mass = float((rows.sum(-1) - 1.0).abs().max())
    print(f"cross-check Q18 exact rows sum to 1: max |sum - 1| {mass:.3e} "
          "(tolerance 1e-3)")
    check(mass <= 1e-3, f"Q18 exact row mass {mass}")
    mean = rows @ torch.arange(rows.shape[1], device=rows.device,
                               dtype=torch.float64)
    normal_mu = res["q18/aggregate"]["sum_qty"][0][:v.shape[0]][v].double()
    err = float(((mean - normal_mu).abs() / normal_mu.clamp(min=1)).max())
    print(f"cross-check Q18 exact mean = Normal mean: max rel err {err:.3e} "
          "(tolerance 1e-3)")
    check(err <= 1e-3, f"Q18 exact mean {err}")


# ------------------------------------------------------------- value layer
def value_leaves(x):
    """A value-layer result as a dict of tensors (PGFs, the host fits'
    dataclasses, query dicts), for bit-equal and CPU-vs-card checks."""
    import dataclasses
    import torch
    from repro_torch.core.pgf import PGF
    if isinstance(x, PGF):
        return dict(coeffs=x.coeffs, offset=torch.tensor(x.offset),
                    p_pos_inf=torch.as_tensor(x.p_pos_inf,
                                              dtype=torch.float64),
                    p_neg_inf=torch.as_tensor(x.p_neg_inf,
                                              dtype=torch.float64))
    if dataclasses.is_dataclass(x):
        return {k: torch.as_tensor(v, dtype=torch.float64)
                for k, v in dataclasses.asdict(x).items()}
    return x


def float32_fft_tree(p):
    """Exact COUNT by the JAX package's arithmetic: the product tree with
    every level's FFTs in float32 (repro/core/pgf.py:236-275) — the port
    runs them in float64.  Reported, not checked: it shows why."""
    import torch
    import torch.nn.functional as F
    rows = torch.stack([1.0 - p, p], dim=1)
    while rows.shape[0] > 1:
        carry = None
        if rows.shape[0] % 2:
            carry, rows = rows[-1], rows[:-1]
        n = 2 * rows.shape[1] - 1
        nfft = 1 << max(1, (n - 1).bit_length())
        f = torch.fft.rfft(rows, nfft, dim=-1)
        rows = torch.clamp(torch.fft.irfft(f[0::2] * f[1::2], nfft,
                                           dim=-1)[:, :n], min=0.0)
        if carry is not None:
            rows = torch.cat([rows, F.pad(
                carry, (0, rows.shape[1] - carry.shape[0]))[None]])
    return rows[0, :p.shape[0] + 1]


def moments(coeffs):
    """(mass, mean, variance) of a coefficient vector, in float64."""
    import torch
    c = coeffs.double()
    k = torch.arange(c.shape[0], dtype=torch.float64, device=c.device)
    mass = float(c.sum())
    mean = float((c * k).sum()) / mass
    return mass, mean, float((c * (k - mean) ** 2).sum()) / mass


def check_moments(name, coeffs, mean, var, mass_tol, mean_tol=1e-6,
                  var_tol=1e-4) -> dict:
    m, mu, v = moments(coeffs)
    out = dict(mass_err=m - 1.0, mean_rel=(mu - mean) / mean,
               var_rel=(v - var) / var)
    print(f"{name}: sum - 1 = {out['mass_err']:.3e} (tolerance {mass_tol}), "
          f"mean rel err {out['mean_rel']:.3e} ({mean_tol}), variance rel "
          f"err {out['var_rel']:.3e} ({var_tol})")
    check(abs(out["mass_err"]) <= mass_tol, f"{name}: mass {m}")
    check(abs(out["mean_rel"]) <= mean_tol, f"{name}: mean {mu} vs {mean}")
    check(abs(out["var_rel"]) <= var_tol, f"{name}: variance {v} vs {var}")
    return out


def cumulants_at_fit_shape(p, ones) -> dict:
    """cumulant_sums alone at the 10^8-tuple fit's shape: the 2p = 6 orders
    ``fit_from_data(p, ones, p=3)`` asks for, on the same inputs (the fit's
    wall time also holds the host's mixture solve), against its plain
    version in float64 (1e-5 of the scale) and its bound; bit-equal on a
    rerun."""
    from repro_torch.kernels import cumulants
    orders = 6
    run = lambda: cumulants.cumulant_sums(p, ones, orders=orders)
    t = timings("cumulant_sums", run, 10)
    got = run()
    check(bit_equal(got, run()), "cumulant_sums n=1e8: rerun not bit-equal")
    want, scale = cumulant_witness(p, ones, None, 1, orders)
    rel = cumulant_rel_err(got, want, scale)
    rel_plain = cumulant_rel_err(cumulants.cumulant_sums_plain(p, ones,
                                                               orders),
                                 want, scale)
    plain_ms = cuda_ms(lambda: cumulants.cumulant_sums_plain(p, ones, orders),
                       2)
    n = p.shape[0]
    b = bound_ms(n * 8 + orders * 4, n * cumulant_ops_per_tuple(orders))
    print(f"cumulant_sums n={n} orders={orders}: kernel {t['ms']:.4f} ms "
          f"(own launches {t['own_ms']:.4f} ms), wrapper "
          f"{t['wrapper_ms']:.4f} ms vs plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]}); max err / scale {rel:.3e} (tolerance "
          f"1e-5; float32 plain {rel_plain:.3e}); bit-equal rerun")
    check(rel <= 1e-5, f"cumulant_sums n=1e8 disagrees: {rel}")
    return dict(max_abs_err=float((got.double() - want[0]).abs().max()), **t,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                shape=f"n={n} orders={orders}", max_err_over_scale=rel,
                plain_float32_max_err_over_scale=rel_plain)


def fig9_probs(dev):
    """Fig. 9's smallest n, drawn as benchmarks/fig9_count.py:31 draws it:
    the value path's 10^8 tuples."""
    import numpy as np
    import torch
    return torch.as_tensor(np.random.default_rng(0).uniform(0, 1, FIG9_N),
                           dtype=torch.float32).to(dev)


def value_path(db, p) -> dict:
    """The value layer at the paper's sizes (module docstring, phase 5),
    on the 10^8 tuples ``p`` of :func:`fig9_probs`."""
    import numpy as np
    import torch
    from repro_torch.core import approx, pgf
    from repro_torch.core import poisson_binomial as pb
    from repro_torch.db import operators, tpch
    from repro_torch.kernels import ops
    dev = db.lineitem.device
    report = {}
    p64, ones = p.double(), torch.ones_like(p)
    li = db.lineitem
    prob, qty = li.masked_prob(), li["l_quantity"]
    rng = np.random.default_rng(1)
    p_a, p_b = (torch.as_tensor(rng.uniform(0, 1, 1000),
                                dtype=torch.float32).to(dev) for _ in "ab")
    p_g = torch.as_tensor(rng.uniform(0, 1, 1600), dtype=torch.float32).to(dev)
    v_g = torch.arange(1600, device=dev) // 400 + 1       # 400 each of 1..4
    calls = {
        "count_pgf n=1e8": lambda: pb.count_pgf(p),
        "count_pgf n=1e8 float64": lambda: pb.count_pgf(p64),
        "fit_from_data n=1e8": lambda: approx.fit_from_data(p, ones, p=3),
        "fit_normal n=1e8": lambda: approx.fit_normal(p, ones),
        "sum_pgf SF1": lambda: pb.sum_pgf(prob, qty),
        "q18_topk SF1 kappa=8": lambda: tpch.q18_topk(
            db, max_groups=Q18_TOPK_GROUPS, kappa=8),
        "q18_topk SF1 kappa=2": lambda: tpch.q18_topk(
            db, max_groups=Q18_TOPK_GROUPS, kappa=2),
        "schoolbook 1001x1001": lambda: pb.count_pgf(p_a).mul_sum(
            pb.count_pgf(p_b)),
        "schoolbook grouped SUM n=1600": lambda: pb.sum_pgf(
            p_g, v_g, method="grouped"),
    }
    for fn in calls.values():                  # warm-up (cuFFT plans)
        fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res, wall = {}, {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3
        print(f"value layer {name}: {wall[name]:.1f} ms")
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"value-layer launches: {launches} (expected {VALUE_LAUNCHES}); "
          f"peak device memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f}"
          " GB above the resident tables and inputs)")
    check(launches == VALUE_LAUNCHES, f"value-layer launches {launches}")
    report.update(wall_ms=wall, launches=launches, peak_bytes=peak,
                  peak_above_resident_bytes=peak - base)

    # Exact COUNT at 10^8.  The float32 run's factor rows (fl(1-p), p)
    # miss mass 1 by the rounding of 1 - p: printed as sum log(row mass);
    # its FFTs run in float64 as the float64 run's do, so the two runs
    # differ by that rounding, about 1e-5 of the peak: tolerance 1e-4 of
    # the peak coefficient, and 1e-4 on the float32 mass.
    mean, var = float(p64.sum()), float((p64 * (1 - p64)).sum())
    row_log = float(torch.log((1.0 - p).double() + p64).sum())
    print(f"COUNT n=1e8: sum log(float32 row mass) {row_log:.3e}")
    c32 = res["count_pgf n=1e8"].coeffs
    c64 = res["count_pgf n=1e8 float64"].coeffs
    report["count32"] = check_moments("COUNT n=1e8 float32", c32, mean, var,
                                      mass_tol=1e-4)
    report["count64"] = check_moments("COUNT n=1e8 float64", c64, mean, var,
                                      mass_tol=1e-6)
    peak_c = float(c64.max())
    diff = float((c32.double() - c64).abs().max()) / peak_c
    print(f"COUNT n=1e8 float32 vs float64: max diff / peak {diff:.3e} "
          "(tolerance 1e-4)")
    check(diff <= 1e-4, f"COUNT float32 vs float64 {diff}")
    ref32 = float32_fft_tree(p)
    m, mu, v = moments(ref32)
    report["count_float32_ffts"] = dict(
        mass_err=m - 1.0, mean_rel=(mu - mean) / mean, var_rel=(v - var) / var,
        peak_ratio=float(ref32.max()) / peak_c)
    print("COUNT n=1e8 with float32 FFTs (the JAX package's arithmetic, "
          f"reported): sum - 1 = {m - 1:.3e}, mean rel err "
          f"{(mu - mean) / mean:.3e}, variance rel err {(v - var) / var:.3e}, "
          f"peak / float64 peak {float(ref32.max()) / peak_c:.3e}")
    del ref32
    # Fig. 10: the 0.95-interval lower end, gamma mixture and Normal
    # against the exact (float64) distribution.
    lo = float(pgf.PGF(c64).confidence_interval(0.95)[0])
    fig10 = dict(exact_lo=lo)
    for name, key in (("gamma mixture", "fit_from_data n=1e8"),
                      ("Normal", "fit_normal n=1e8")):
        approx_lo = float(res[key].confidence_interval(0.95)[0])
        fig10[name] = abs(approx_lo - lo) / lo
        print(f"Fig. 10 at n=1e8: {name} 0.95-interval lower end "
              f"{approx_lo:.1f} vs exact {lo:.0f}: rel err {fig10[name]:.3e}")
    report["fig10"] = fig10

    # Exact SUM over the SF1 lineitem (6M float32 rows: mass as above).
    pd, vd = prob.double(), qty.double()
    row_log = float(torch.log((1.0 - prob).double() + pd).sum())
    print(f"SUM SF1: sum log(float32 row mass) {row_log:.3e}")
    report["sum"] = check_moments(
        "SUM SF1", res["sum_pgf SF1"].coeffs, float((vd * pd).sum()),
        float((vd * vd * pd * (1 - pd)).sum()), mass_tol=1e-4)

    # Schoolbook products against fft_convolve of the same factors, within
    # 1e-5 of the peak (float32 accumulation over <= 1001 terms).
    a, b = pb.count_pgf(p_a), pb.count_pgf(p_b)
    parts = [pb.count_pgf(p_g[v_g == k]).stretch(k) for k in range(1, 5)]
    want_g = parts[0].coeffs
    for f in parts[1:]:
        want_g = pgf.fft_convolve(want_g, f.coeffs)
    report["schoolbook"] = {}
    for name, want in (("schoolbook 1001x1001",
                        pgf.fft_convolve(a.coeffs, b.coeffs)),
                       ("schoolbook grouped SUM n=1600", want_g)):
        got = res[name].coeffs
        check(got.shape == want.shape, f"{name}: shape")
        err = float((got.double() - want.double()).abs().max()
                    / want.double().max())
        report["schoolbook"][name] = err
        print(f"{name} vs fft_convolve: max diff / peak {err:.3e} "
              "(tolerance 1e-5)")
        check(err <= 1e-5, f"{name}: {err}")

    # q18_topk: per valid group sum(run_mass) + p_tail = 1; p_empty equals
    # 1 - the group's AtLeastOne confidence; no tail at kappa 8 (an order
    # has at most 4 lines); at kappa 2 a tail in some groups, never above
    # p_tail.
    ids, _, _ = operators.group_ids(li, ["l_orderkey"], Q18_TOPK_GROUPS)
    conf = operators.group_atleastone(li, ids, Q18_TOPK_GROUPS)
    report["q18_topk"] = {}
    for kappa in (8, 2):
        r = res[f"q18_topk SF1 kappa={kappa}"]
        v = r["valid"]
        mass = r["run_mass"].reshape(-1, kappa).double().sum(1)
        tot = float((mass + r["p_tail"].double() - 1.0)[v].abs().max())
        emp = float((r["p_empty"].double() - (1.0 - conf.double()))[v]
                    .abs().max())
        tail = r["tail_mass"][v]
        out = dict(groups=int(v.sum()), mass_err=tot, p_empty_err=emp,
                   tail_max=float(tail.max()),
                   tail_groups=int((tail > 0).sum()))
        report["q18_topk"][kappa] = out
        print(f"q18_topk kappa={kappa}: {out['groups']} groups; max |sum "
              f"run_mass + p_tail - 1| {tot:.3e} (tolerance 1e-5); max "
              f"|p_empty - (1 - AtLeastOne)| {emp:.3e} (tolerance 1e-5); "
              f"tail_mass > 0 in {out['tail_groups']} groups, max "
              f"{out['tail_max']:.3e}")
        check(tot <= 1e-5, f"q18_topk kappa={kappa}: run mass {tot}")
        check(emp <= 1e-5, f"q18_topk kappa={kappa}: p_empty {emp}")
        if kappa == 8:
            check(out["tail_max"] == 0.0, "q18_topk kappa=8: tail mass")
        else:
            check(out["tail_groups"] > 0, "q18_topk kappa=2: no tail")
            check(bool((tail <= r["p_tail"][v]).all()),
                  "q18_topk kappa=2: tail_mass above p_tail")

    for name, fn in calls.items():
        check(bit_equal(value_leaves(res[name]), value_leaves(fn())),
              f"{name}: rerun is not bit-equal")
    print("value layer bit-equal reruns: ok")
    return report


def value_small(device: str) -> dict:
    """The value layer at n_orders=2000 on one device (phase 6)."""
    from repro_torch.core import poisson_binomial as pb
    from repro_torch.db import tpch
    db = tpch.generate(n_orders=2000, seed=0, device=device)
    p, q = db.lineitem.masked_prob(), db.lineitem["l_quantity"]
    return {
        "count cf n=1000": pb.count_pgf(p[:1000], method="cf").coeffs,
        "count tree": pb.count_pgf(p, method="tree").coeffs,
        "sum cf n=500": pb.sum_pgf(p[:500], q[:500], method="cf").coeffs,
        "sum grouped": pb.sum_pgf(p, q, method="grouped").coeffs,
        "schoolbook": pb.count_pgf(p[:1000]).mul_sum(
            pb.count_pgf(p[1000:2000])).coeffs,
        "q18_topk kappa=8": tpch.q18_topk(db, max_groups=2048, kappa=8),
        "q18_topk kappa=2": tpch.q18_topk(db, max_groups=2048, kappa=2),
    }


def compare_small(cpu, gpu) -> dict:
    """Card against CPU at a small size: integer and boolean leaves equal,
    float leaves within 2e-4 of the leaf's largest magnitude (per order
    for cumulant sums, whose columns scale as v^j).

    Cumulant order j is conditioning-limited in float32: kappa_j's
    coefficients sum to C_j in absolute value (1, 2, 6, 26, 150, ...,
    9.5e4 at j = 8), so its sums cancel by up to that factor.  Orders
    j <= 4 are held to 2e-4 * C_j of the column scale; higher orders are
    reported, and the kernels' accuracy there is held in the kernel phase
    against the absolute-coefficient scale."""
    import numpy as np
    import torch
    from repro_torch.core.approx import _bernoulli_cumulant_polys
    c_abs = torch.as_tensor(np.abs(_bernoulli_cumulant_polys()).sum(1)[1:],
                            dtype=torch.float64)
    worst, worst_high = 0.0, 0.0
    for name in cpu:
        for (pa, a), (pb, b) in zip(leaves(cpu[name]), leaves(gpu[name])):
            check(pa == pb and a.shape == b.shape, f"{name}{pa} shape")
            b = b.cpu()
            if not a.is_floating_point():
                check(torch.equal(a, b), f"{name}{pa} differs CPU vs card")
                continue
            if not a.numel():
                continue
            a64, b64 = a.double(), b.double()
            fin = torch.isfinite(a64)
            check(torch.equal(fin, torch.isfinite(b64))
                  and torch.equal(a64[~fin], b64[~fin]),
                  f"{name}{pa}: non-finite entries differ CPU vs card")
            a64, b64 = a64[fin], b64[fin]
            if not a64.numel():
                continue
            if "cumulants" in pa:       # per order: columns differ by v^j
                a64, b64 = (x.reshape(-1, a.shape[-1]) for x in (a64, b64))
                orders = a.shape[-1]
                rel = ((a64 - b64).abs()
                       / a64.abs().amax(0).clamp(min=1e-6) / c_abs[:orders])
                worst_high = max(worst_high, float(rel[:, 4:].max())
                                 if orders > 4 else 0.0)
                rel = rel[:, :4]
            else:
                rel = (a64 - b64).abs() / a64.abs().max().clamp(min=1e-6)
            err = float(rel.max())
            check(err <= 2e-4, f"{name}{pa}: CPU vs card {err}")
            worst = max(worst, err)
    return dict(max_rel=worst, cumulant_orders_above_4_rel=worst_high)


# -------------------------------------------------------------- streamed
def timed(fn) -> tuple:
    """(result, wall ms) of one call that ends in a synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def streamed_queries(db, opts) -> dict:
    """The streamed path's queries: each TPC-H query in aggregate mode and
    the two exact variants, with the SF1 phase's group capacities, and
    ``opts`` added to their plan options (None: the resident runs)."""
    from repro_torch.db import tpch
    kw = {} if opts is None else dict(plan_opts=opts)
    return {
        "q1/aggregate": lambda: tpch.q1(db, "aggregate", **kw),
        "q3/aggregate": lambda: tpch.q3(db, "aggregate",
                                        max_groups=Q3_GROUPS, **kw),
        "q6/aggregate": lambda: tpch.q6(db, "aggregate", **kw),
        "q18/aggregate": lambda: tpch.q18(db, "aggregate",
                                          max_groups=Q18_NORMAL_GROUPS, **kw),
        "q20/aggregate": lambda: tpch.q20(db, "aggregate",
                                          max_groups=Q20_GROUPS, **kw),
        "q6/aggregate_exact": lambda: tpch.q6(db, "aggregate",
                                              num_freq=4096, **kw),
        "q18/aggregate_exact": lambda: tpch.q18(
            db, "aggregate", method="exact", max_groups=Q18_GROUPS,
            num_freq=256, plan_opts=dict(Q18_EXACT_OPTS, **(opts or {}))),
    }


def stream_line(label: str, ms: float, st: dict, peak: int) -> dict:
    """Print and return one streamed run's numbers: wall ms, slabs
    shipped, bytes, host slicing s, device copy s and its rate."""
    gbs = st["slab_bytes"] / st["copy_s"] / 1e9 if st["copy_s"] else 0.0
    print(f"{label}: {ms:.1f} ms, {st['waves']} slabs "
          f"({st['slab_bytes'] / 1e9:.3f} GB), slicing "
          f"{st['slice_s'] * 1e3:.1f} ms, host->device copies "
          f"{st['copy_s'] * 1e3:.1f} ms ({gbs:.2f} GB/s), peak device "
          f"memory {peak / 1e9:.3f} GB above the start")
    return dict(wall_ms=ms, h2d_gb_s=gbs, peak_bytes=peak, **st)


def run_streamed(fn) -> tuple:
    """(result, wall ms, stream_stats, peak device bytes above the start)
    of one streamed call."""
    import torch
    from repro_torch.db import plans
    plans.reset_stream_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, ms = timed(fn)
    return out, ms, plans.stream_stats(), \
        torch.cuda.max_memory_allocated() - base


def streamed_phase(db, out_dir) -> dict:
    """Phase 4 (module docstring): the streamed SF1 path against the
    resident runs, disk-backed Q6 exact, the fault and retry checks."""
    import shutil
    import torch
    from repro_torch.db import tpch
    from repro_torch.db.table import HostTable
    from repro_torch.kernels import ops
    host = tpch.TPCH(**dict(db.tables(),
                            lineitem=HostTable.from_table(db.lineitem)),
                     scale=db.scale)
    report = {}
    ref, ref_launches, ref_ms, ref_peak = {}, {}, {}, {}
    for name, fn in streamed_queries(db, None).items():
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        ref[name], ref_ms[name] = timed(fn)
        ref_launches[name] = ops.launches()
        ref_peak[name] = torch.cuda.max_memory_allocated() - base
    # The streamed path: counters at 0, every query once, counters read.
    rows = {}
    ops.reset_launches()
    for name, fn in streamed_queries(host, STREAM_OPTS).items():
        before = ops.launches()
        got, ms, st, peak = run_streamed(fn)
        launched = {k: v - before[k] for k, v in ops.launches().items()}
        check_finite(f"streamed {name}", got)
        check(bit_equal(ref[name], got),
              f"streamed {name} is not bit-equal to its resident run")
        check(launched == ref_launches[name],
              f"streamed {name} launches {launched}, resident "
              f"{ref_launches[name]}")
        check(st["waves"] == 2 * SF1_WAVES, f"streamed {name}: {st}")
        rows[name] = stream_line(
            f"SF1 streamed {name} (resident {ref_ms[name]:.1f} ms, peak "
            f"{ref_peak[name] / 1e9:.3f} GB above the start)", ms, st, peak)
        rows[name].update(resident_ms=ref_ms[name], launches=launched,
                          resident_peak_bytes=ref_peak[name])
    launches = ops.launches()
    print(f"streamed-path launches: {launches} (each query's equal to its "
          "resident run's); streamed == resident bit for bit: ok")
    for k in STREAM_KERNELS:
        check(launches[k] > 0, f"{k} not launched on the streamed path")
    report.update(queries=rows, launches=launches)

    disk = out_dir / "lineitem_sf1"
    HostTable.from_table(db.lineitem).save(str(disk))
    try:
        mapped = tpch.TPCH(**dict(db.tables(),
                                  lineitem=HostTable.open(str(disk))),
                           scale=db.scale)
        got, ms, st, peak = run_streamed(lambda: tpch.q6(
            mapped, "aggregate", num_freq=4096, plan_opts=STREAM_OPTS))
        check(bit_equal(ref["q6/aggregate_exact"], got),
              "disk-backed streamed Q6 exact is not bit-equal")
        report["q6_exact_memmap"] = stream_line(
            "SF1 streamed q6/aggregate_exact from memory-mapped columns",
            ms, st, peak)
    finally:
        shutil.rmtree(disk, ignore_errors=True)
    report["faults"] = fault_phase(db, host, ref)
    return report


def fault_phase(db, host, ref) -> dict:
    """The fault and retry checks at SF1: a transient slab-copy fault
    resumes bit-equal; a persistent one converges by wave halving; a
    too-small kappa and max_groups converge on q18_topk; each converged
    result equals a first run at its final_params."""
    from repro_torch.db import tpch
    from repro_torch.db.plans import RetryPolicy, compile_plan, run_plan
    from repro_torch.testing import faults
    report = {}
    # 4 waves a phase: occurrence 5 is phase B, wave 1
    with faults.inject(faults.FaultPlan(transfer_calls={5})) as fp:
        got = tpch.q1(host, "aggregate", plan_opts=STREAM_OPTS)
    (i, w), = [(i, w) for i, w, _r, f in fp.log if f]
    check(fp.consumed() and fp.log[i + 1][1] == w, f"fault log {fp.log}")
    check(bit_equal(ref["q1/aggregate"], got),
          "Q1 after a transient slab-copy fault is not bit-equal")
    print(f"transient fault at copy {i} (wave {w}): re-shipped wave {w} "
          f"only, {len(fp.log)} copies, result bit-equal")
    report["transient"] = dict(log=fp.log)

    root = tpch.q1_plan()
    opts = dict(device_row_budget=STREAM_OPTS["device_row_budget"])
    # waves of 4 chunks (3,000,000 rows) fail every time, 2 chunks pass
    chunk_rows = db.lineitem.capacity // 8
    with faults.inject(faults.FaultPlan(transfer_rows_over=3 * chunk_rows)):
        out, rep = run_plan(root, host.tables(),
                            policy=RetryPolicy(max_attempts=4),
                            stream_wave_chunks=4, **opts)
    fin = rep.final_params
    check(rep.waves["attempts"] == 2 and fin["stream_wave_chunks"] == 2,
          f"wave halving: {rep.waves} {fin}")
    first = compile_plan(root, stream_wave_chunks=fin["stream_wave_chunks"],
                         **opts)(host.tables())
    check(bit_equal(first, out) and bit_equal(
        compile_plan(root)(db.tables()), out),
        "wave-halved Q1 differs from a first run at final_params")
    print(f"wave halving: {rep.waves['attempts']} attempts, final_params "
          f"{fin}, bit-equal to a first run at final_params and to resident")
    report["wave_halving"] = dict(waves=rep.waves, final_params=fin)

    # max_groups 2^20 for 1,500,000 orders of 4 lines: both escalate once
    groups, kappa = 1 << (db.scale["n_orders"].bit_length() - 1), 2
    out, rep = run_plan(tpch.q18_topk_plan(groups, kappa), db.tables(),
                        policy=RetryPolicy(max_attempts=3))
    fin = rep.final_params
    check(rep.issues() == {} and rep.waves["attempts"] == 2
          and fin["kappa_scale"] == 2 and fin["groups_scale"] == 2,
          f"q18_topk escalation: {rep.waves} {fin} {rep.issues()}")
    first = compile_plan(tpch.q18_topk_plan(
        groups * fin["groups_scale"], kappa * fin["kappa_scale"]))(
        db.tables())
    check(bit_equal(first, out),
          "escalated q18_topk differs from a first run at final_params")
    print(f"q18_topk escalation (max_groups {groups}, kappa {kappa}): "
          f"{rep.waves['attempts']} attempts, final_params {fin}, clean, "
          "bit-equal to a first run at final_params")
    report["q18_topk_escalation"] = dict(waves=rep.waves, final_params=fin)
    return report


def pinned_copy_gbs(nbytes: int, reps: int = 16) -> float:
    """The link's own rate: GB/s of ``copy_`` from a pinned host buffer of
    ``nbytes`` to the card (CUDA events over ``reps`` copies)."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    stop.record()
    torch.cuda.synchronize()
    return nbytes * reps / (start.elapsed_time(stop) / 1e3) / 1e9


def sf5_phase() -> dict:
    """Phase 7 (module docstring): Q1 aggregate and Q6 exact streamed
    from SF5 host tables, double-buffered and synchronous, against the
    resident runs of the same queries on the same grid."""
    import numpy as np
    import torch
    from repro_torch.db import tpch
    from repro_torch.db.table import HostTable
    t0 = time.perf_counter()
    arrays, scale = tpch.generate_numpy(**SF5)
    hosts = {name: HostTable(a["columns"], a["prob"].astype(np.float32))
             for name, a in arrays.items()}
    del arrays
    gen_s = time.perf_counter() - t0
    li = hosts["lineitem"]
    print(f"SF5 host tables: lineitem {li.capacity} rows, orders "
          f"{hosts['orders'].capacity} rows, {gen_s:.1f} s")
    db = tpch.TPCH(**hosts, scale=scale)
    queries = {
        "q1/aggregate": lambda d, o: tpch.q1(d, "aggregate", plan_opts=o),
        "q6/aggregate_exact": lambda d, o: tpch.q6(
            d, "aggregate", num_freq=4096, plan_opts=o)}
    report = dict(generate_s=gen_s, queries={})
    got = {}
    chunk_rows = -(-li.capacity // SF5_CHUNKS)
    for name, q in queries.items():
        opts = dict(canonical_chunks=SF5_CHUNKS, device_row_budget=int(
            SF5_BUDGET_CHUNKS[name] * chunk_rows))
        row = {}
        for label, o in (("double-buffered", opts),
                         ("synchronous", dict(opts,
                                              stream_double_buffer=False))):
            got[name, label], ms, st, peak = run_streamed(
                lambda q=q, o=o: q(db, o))
            check(st["waves"] == 2 * SF5_WAVES, f"SF5 {name}: {st}")
            row[label] = stream_line(f"SF5 streamed {name} {label}", ms,
                                     st, peak)
        check(bit_equal(got[name, "double-buffered"],
                        got[name, "synchronous"]),
              f"SF5 {name}: synchronous run differs")
        wave = row["double-buffered"]["slab_bytes"] // (2 * SF5_WAVES)
        row["pinned_copy_gb_s"] = pinned_copy_gbs(wave)
        print(f"SF5 {name}: plain pinned copy_ of one slab ({wave} bytes) "
              f"{row['pinned_copy_gb_s']:.2f} GB/s; streamed copies "
              f"{row['double-buffered']['h2d_gb_s']:.2f} GB/s; "
              f"double-buffered {row['double-buffered']['wall_ms']:.1f} ms "
              f"vs synchronous {row['synchronous']['wall_ms']:.1f} ms")
        report["queries"][name] = row
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    resident = tpch.TPCH(**dict(hosts, lineitem=li.to_table("cuda")),
                         scale=scale)
    for name, q in queries.items():
        ref, ms = timed(lambda q=q: q(resident, dict(
            canonical_chunks=SF5_CHUNKS)))
        peak = torch.cuda.max_memory_allocated() - base
        check_finite(f"SF5 resident {name}", ref)
        check(bit_equal(ref, got[name, "double-buffered"]),
              f"SF5 streamed {name} is not bit-equal to resident")
        print(f"SF5 resident {name}: {ms:.1f} ms, peak device memory "
              f"{peak / 1e9:.3f} GB (lineitem on the card included); "
              "streamed == resident bit for bit")
        report["queries"][name]["resident"] = dict(wall_ms=ms,
                                                   peak_bytes=peak)
        torch.cuda.reset_peak_memory_stats()
    return report


# ----------------------------------------------------------------- mesh
def digest(result) -> dict:
    """{leaf path: [shape, dtype, h1, h2]}: two 64-bit polynomial hashes of
    each leaf's bytes, computed on its device (integer arithmetic, so the
    same bits always give the same digest; a changed bit changes both
    hashes with overwhelming likelihood).  Ranks in other processes hold
    their results to phase 3's through these, without moving them."""
    import torch
    out = {}
    for path, t in leaves(result):
        b = t.contiguous().reshape(-1)
        if b.dtype == torch.bool:
            b = b.to(torch.uint8)
        b = b.view(torch.uint8)
        pad = (-b.numel()) % 8
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        w = b.view(torch.int64)
        h1 = h2 = 0
        for lo in range(0, w.numel(), 1 << 26):     # bounded temporaries
            x = w[lo:lo + (1 << 26)]
            i = torch.arange(lo, lo + x.numel(), dtype=torch.int64,
                             device=w.device)
            h1 += int(torch.sum(x * (2 * i + 1)))
            h2 += int(torch.sum((x ^ (i * 0x9E3779B97F4A7C1)) * (i * 6 + 5)))
        out[path] = [list(t.shape), str(t.dtype), h1 % (1 << 64),
                     h2 % (1 << 64)]
    return out


def mesh_queries(db, mesh) -> dict:
    """Phase 8's queries on ``mesh``: the SF1 phase's aggregate queries and
    exact variants, Q3 with its orders join over the gather budget (the
    co-partitioned pipeline) and Q20 with every join over it
    (ShuffleJoin); each must equal its :data:`MESH_PHASE3` query.  The two
    exchange plans run with a report (the query functions' own
    post-processing, inline) and return it too."""
    from repro_torch.db import plans, tpch

    def q3_copartitioned():
        out, rep = plans.compile_plan(
            tpch.q3_plan(max_groups=Q3_GROUPS, order_join_budget=4), mesh,
            with_report=True, copartition=True)(db.tables())
        return dict(valid=out["valid"], revenue=out["sum"],
                    cumulants=out["cumulants"]), rep

    def q20_shuffle_join():
        out, rep = plans.compile_plan(
            tpch.q20_plan(max_groups=Q20_GROUPS), mesh, with_report=True,
            join_gather_budget=4)(db.tables())
        return dict(valid=out.valid, s_name=out["s_name"],
                    prob=out.prob), rep
    return {
        "q1/aggregate": lambda: tpch.q1(db, "aggregate", mesh=mesh),
        "q3/aggregate": lambda: tpch.q3(db, "aggregate",
                                        max_groups=Q3_GROUPS, mesh=mesh),
        "q6/aggregate": lambda: tpch.q6(db, "aggregate", mesh=mesh),
        "q18/aggregate": lambda: tpch.q18(
            db, "aggregate", max_groups=Q18_NORMAL_GROUPS, mesh=mesh),
        "q20/aggregate": lambda: tpch.q20(db, "aggregate",
                                          max_groups=Q20_GROUPS, mesh=mesh),
        "q6/aggregate_exact": lambda: tpch.q6(db, "aggregate",
                                              num_freq=4096, mesh=mesh),
        "q18/aggregate_exact": lambda: tpch.q18(
            db, "aggregate", method="exact", max_groups=Q18_GROUPS,
            num_freq=256, mesh=mesh, plan_opts=Q18_EXACT_OPTS),
        "q3/copartitioned": q3_copartitioned,
        "q20/shuffle_join": q20_shuffle_join,
    }


#: the phase-3 query a phase-8 query must equal, where the names differ
MESH_PHASE3 = {"q3/copartitioned": "q3/aggregate",
               "q20/shuffle_join": "q20/aggregate"}
#: the queries each part of phase 8 runs (mesh_queries names)
MESH_ALL = ("q1/aggregate", "q3/aggregate", "q6/aggregate", "q18/aggregate",
            "q20/aggregate", "q6/aggregate_exact", "q18/aggregate_exact",
            "q3/copartitioned", "q20/shuffle_join")
MESH_MODEL = ("q6/aggregate_exact", "q18/aggregate_exact")
#: the kernels the mesh path runs
MESH_KERNELS = ("logcf", "group_logcf", "cumulant_sums",
                "group_cumulant_sums")


def run_mesh_queries(db, mesh, names) -> dict:
    """Each query once: its digest, wall ms, kernel launches, collective
    counts and (the exchange plans) exchange overflow per leg."""
    import torch
    from repro_torch.db import distributed as dist
    from repro_torch.kernels import ops
    out = {}
    for name in names:
        fn = mesh_queries(db, mesh)[name]
        before = ops.launches()
        counts = dict(dist.COLLECTIVE_COUNTS)
        res, ms = timed(fn)
        rep = None
        if isinstance(res, tuple):
            res, rep = res
        out[name] = dict(digest=digest(res), ms=ms, launches={
            k: v - before[k] for k, v in ops.launches().items()},
            collectives={k: v - counts.get(k, 0)
                         for k, v in dist.COLLECTIVE_COUNTS.items()
                         if v > counts.get(k, 0)},
            overflow=None if rep is None
            else rep.host_values()["exchange_overflow"])
        del res
        torch.cuda.empty_cache()
    return out


def per_owner(r: dict) -> bool:
    """Did the query run a hash-partitioned pass (partitioned_merge)?
    Its accumulate runs every canonical chunk on every owner, over the
    owner's groups: launches = data ranks x phase 3's (the forced
    co-partitioned Q3; ``compile_plan`` does not choose it by default)."""
    return any(k in r["collectives"] for k in ("merge_psum", "merge_gather"))


def mesh_rank(shape, names, device, table_dir, stale_dir, scale, queries,
              extras) -> dict:
    """One gloo rank of phase 8 (b) or (c), sharing cuda:0: open the SF1
    tables the parent saved, materialise them on the card, run
    ``queries``; with ``extras`` also the exchange reports, the stale-stats
    retry, an exchange fault and the streamed runs."""
    import torch
    from repro_torch.db import distributed as dist
    from repro_torch.db import plans, tpch
    from repro_torch.db.table import HostTable
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.testing import faults
    build.library()                     # built by the parent
    mesh = make_mesh(shape, names, backend="gloo", device=device)
    opened = {t: HostTable.open(str(pathlib.Path(table_dir) / t))
              for t in tpch.TABLES}
    db = tpch.TPCH(**{k: v.to_table(mesh.device) for k, v in opened.items()},
                   scale=scale)
    dist.reset_collective_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(rank=mesh.rank, coords=mesh.coords,
               queries=run_mesh_queries(db, mesh, queries))
    if extras:
        # stale stats (a half-size snapshot) undersize the buckets of a
        # ShuffleJoin (orders x customer, COUNT per market segment): the
        # retry escalates the floor and converges
        stale = {t: HostTable.open(str(pathlib.Path(stale_dir) / t))
                 for t in ("orders", "customer")}
        root = plans.GroupAgg(
            plans.FKJoin(plans.Scan("orders"), plans.Scan("customer"),
                         "o_custkey", "c_custkey", ("c_mktsegment",)),
            ("c_mktsegment",), "", "COUNT", 8)
        opts = dict(join_gather_budget=4, stats_tables=stale)
        got, rep = plans.run_plan(root, db.tables(), mesh, **opts)
        fin = rep.final_params
        first = plans.compile_plan(
            root, mesh, shuffle_slack=fin["shuffle_slack"],
            shuffle_bucket_floor=fin["shuffle_bucket_floor"],
            **opts)(db.tables())
        out["stale_retry"] = dict(
            attempts=rep.waves["attempts"], issues=rep.issues(),
            final_params=fin, bit_equal_first=bit_equal(first, got))
        del got, first
        # one exchange fault, injected on every rank, propagates
        try:
            with faults.inject(faults.FaultPlan(exchange_calls={0})):
                mesh_queries(db, mesh)["q20/shuffle_join"]()
            out["exchange_fault"] = "not raised"
        except faults.TransferFault as e:
            out["exchange_fault"] = f"raised: {e}"
        # streamed from the memory-mapped lineitem
        host = tpch.TPCH(**dict(db.tables(), lineitem=opened["lineitem"]),
                         scale=scale)
        from repro_torch.kernels import ops
        out["streamed"] = {}
        for name, fn in (
                ("q1/aggregate", lambda: tpch.q1(host, "aggregate", mesh=mesh,
                                                 plan_opts=STREAM_OPTS)),
                ("q6/aggregate_exact", lambda: tpch.q6(
                    host, "aggregate", num_freq=4096, mesh=mesh,
                    plan_opts=STREAM_OPTS))):
            before = ops.launches()
            plans.reset_stream_stats()
            res, ms = timed(fn)
            out["streamed"][name] = dict(
                digest=digest(res), ms=ms, waves=plans.stream_stats()["waves"],
                launches={k: v - before[k] for k, v in ops.launches().items()})
            del res
    out["collectives"] = dict(dist.COLLECTIVE_COUNTS)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def mesh_phase(out_dir, ref, ref_launches, serving=None) -> dict:
    """Phase 8 (module docstring): the mesh path on the card, (a) one-rank
    NCCL in this process, (b) three gloo ranks and (c) a (2, 2) gloo mesh
    sharing it; every result's digest equal to phase 3's.  ``serving(db,
    mesh)`` (phase 9) runs on (a)'s tables and mesh after (a)'s queries,
    while the NCCL group is up; its return lands under "serving"."""
    import shutil
    import torch
    import torch.distributed as tdist
    from repro_torch.db import distributed as dist
    from repro_torch.db import tpch
    from repro_torch.db.table import HostTable
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.testing.ranks import run_ranks
    card = card_line()
    report = dict(card=card)
    total = {k: 0 for k in ops.launches()}

    def compare(label, name, digests, launches, scale=1):
        phase3 = MESH_PHASE3.get(name, name)
        for d in digests:
            check(d == ref[phase3], f"mesh {label} {name}: not bit-equal "
                  f"to phase 3's {phase3}")
        if launches is not None:
            want = {k: v * scale for k, v in ref_launches[phase3].items()}
            check(launches == want, f"mesh {label} {name}: launches "
                  f"{launches}, phase 3 {ref_launches[phase3]} x {scale}")

    # (a) one rank on an NCCL group, in this process
    db = tpch.generate(**SF1, device="cuda")
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(out_dir / "nccl_store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh((1,), ("data",), backend="nccl", device="cuda:0")
        dist.reset_collective_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        a = run_mesh_queries(db, mesh, MESH_ALL)
        for k, v in ops.launches().items():
            total[k] += v
        report["nccl_1"] = dict(queries=a,
                                collectives=dict(dist.COLLECTIVE_COUNTS),
                                peak_bytes=torch.cuda.max_memory_allocated())
        if serving is not None:
            report["serving"] = serving(db, mesh)
    finally:
        tdist.destroy_process_group()
    for name, r in a.items():
        compare("(a) nccl x1", name, [r["digest"]], r["launches"])
        check(r["overflow"] is None or (r["overflow"] and not any(
            r["overflow"].values())), f"mesh (a) {name}: {r['overflow']}")
        print(f"mesh (a) NCCL 1 rank {name}: {r['ms']:.1f} ms, bit-equal to "
              f"phase 3, launches equal [{card}]")
    print(f"mesh (a) collectives {report['nccl_1']['collectives']}, peak "
          f"device memory {report['nccl_1']['peak_bytes'] / 1e9:.3f} GB")

    # the SF1 tables for the gloo ranks, and a half-size stale snapshot
    tdir, sdir = out_dir / "mesh_sf1", out_dir / "mesh_sf1_stale"
    for t in tpch.TABLES:
        HostTable.from_table(getattr(db, t)).save(str(tdir / t))
    scale = dict(db.scale)
    del db
    torch.cuda.empty_cache()
    stale_arrays, _ = tpch.generate_numpy(**dict(
        SF1, n_orders=SF1["n_orders"] // 2))
    for t in ("orders", "customer"):
        arr = stale_arrays[t]
        HostTable(arr["columns"], arr["prob"].astype("float32")).save(
            str(sdir / t))
    del stale_arrays
    # Three or four ranks share the card's 80 GB (Q18 exact peaks at
    # ~16 GB a rank): this process gives back what it cached, and the
    # ranks' allocators (the setting is inherited) strand little.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh: this process holds {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB of device memory ({torch.cuda.memory_reserved() / 1e9:.3f} "
          "GB reserved) before the gloo ranks start")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for label, shape, names, queries, extras in (
                ("(b) gloo x3", (3,), ("data",), MESH_ALL, True),
                ("(c) gloo 2x2", (2, 2), ("data", "model"), MESH_MODEL,
                 False)):
            world = int(shape[0] * (shape[1] if len(shape) > 1 else 1))
            store = out_dir / f"mesh_ranks_{world}_{len(shape)}"
            shutil.rmtree(store, ignore_errors=True)
            t0 = time.perf_counter()
            ranks = run_ranks(mesh_rank, world, backend="gloo",
                              device="cuda:0", store_dir=store,
                              args=(shape, names, "cuda:0", str(tdir),
                                    str(sdir), scale, queries, extras),
                              timeout=900)
            wall = time.perf_counter() - t0
            for name in queries:
                summed = {k: sum(r["queries"][name]["launches"][k]
                                 for r in ranks) for k in total}
                # every model rank runs its data block's chunks (its
                # frequency window of each exact-CF slab)
                model = shape[1] if len(shape) > 1 else 1
                compare(label, name,
                        [r["queries"][name]["digest"] for r in ranks],
                        summed, model * (shape[0] if per_owner(
                            ranks[0]["queries"][name]) else 1))
                for r in ranks:
                    over = r["queries"][name]["overflow"]
                    check(over is None or (over and not any(over.values())),
                          f"mesh {label} {name}: exchange overflow {over}")
                for k in total:
                    total[k] += summed[k]
                print(f"mesh {label} {name}: rank ms "
                      + ", ".join(f"{r['queries'][name]['ms']:.1f}"
                                  for r in ranks)
                      + f"; bit-equal to phase 3 on every rank [{card}]")
            for r in ranks:
                print(f"mesh {label} rank {r['rank']} {r['coords']}: "
                      f"collectives {r['collectives']}, peak device memory "
                      f"{r['peak_bytes'] / 1e9:.3f} GB")
            if extras:
                for r in ranks:
                    st = r["stale_retry"]
                    check(st["attempts"] == 2 and st["issues"] == {}
                          and st["bit_equal_first"],
                          f"mesh {label} stale-stats retry: {st}")
                    check(r["exchange_fault"].startswith(
                        "raised: injected exchange fault"),
                        f"mesh {label} exchange fault: {r['exchange_fault']}")
                    for name, s in r["streamed"].items():
                        compare(f"{label} streamed", name, [s["digest"]], None)
                for name in ranks[0]["streamed"]:
                    summed = {k: sum(r["streamed"][name]["launches"][k]
                                     for r in ranks) for k in total}
                    compare(f"{label} streamed", name, [], summed)
                    for k in total:
                        total[k] += summed[k]
                st = ranks[0]["stale_retry"]
                print(f"mesh {label}: exchange overflow 0 on every leg; "
                      f"stale stats retry {st['attempts']} attempts, "
                      f"final_params {st['final_params']}, bit-equal to a "
                      "first run at final_params; an exchange fault "
                      "propagated from every rank; streamed Q1 / Q6 exact "
                      "bit-equal to phase 3, launches equal")
            print(f"mesh {label}: {world} ranks, {wall:.1f} s with the "
                  "spawn, imports and table loads")
            report[label] = dict(ranks=ranks, wall_s=wall)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
        shutil.rmtree(sdir, ignore_errors=True)
    for k in MESH_KERNELS:
        check(total[k] > 0, f"{k} not launched on the mesh path")
    report["launches"] = total
    print(f"mesh-path launches (all ranks): {total}; ranks that share one "
          "card say nothing about scaling")
    return report


# ---------------------------------------------------------------- serving
#: the phase-3 query each phase-9 plan's result is held to (through
#: :func:`as_query`, which puts a plan's result in that query's form)
SERVING_PHASE3 = {"q1": "q1/aggregate", "q3": "q3/aggregate",
                  "q6": "q6/aggregate", "q6_exact": "q6/aggregate_exact",
                  "q18": "q18/group_confidence",
                  "q18_exact": "q18/aggregate_exact",
                  "q20": "q20/aggregate"}
#: the kernels the serving path runs through its plans
SERVING_KERNELS = ("logcf", "group_logcf", "cumulant_sums",
                   "group_cumulant_sums")
SWEEP_POINTS = 64


def serving_library() -> dict:
    """Phase 9's plan library, fresh plan objects on every call: name ->
    (plan, submit options), with phase 3's group capacities
    (``serving_plans()``'s own defaults overflow at SF1)."""
    from repro_torch.db import tpch
    from repro_torch.db.plans import GroupAgg, Scan
    return {
        "q1": (tpch.q1_plan(), {}),
        "q3": (tpch.q3_plan(max_groups=Q3_GROUPS), {}),
        "q6": (tpch.q6_plan(), {}),
        "q6_exact": (tpch.q6_plan(num_freq=4096), {}),
        "q18": (tpch.q18_plan(max_groups=Q18_NORMAL_GROUPS), {}),
        "q18_exact": (GroupAgg(Scan("lineitem"), ("l_orderkey",),
                               "l_quantity", "SUM", Q18_GROUPS, "exact",
                               num_freq=256), Q18_EXACT_OPTS),
        "q20": (tpch.q20_plan(max_groups=Q20_GROUPS), {}),
    }


def as_query(name: str, out):
    """A phase-9 plan result in the form the phase-3 query
    :data:`SERVING_PHASE3` names returns it (``tpch.q*``'s own
    post-processing, inline), so the two digests compare."""
    import torch
    if name == "q1":
        return dict(valid=out["valid"], qty=out["sum"], price=out["price"],
                    count=out["count"], cumulants_qty=out["cumulants_qty"])
    if name == "q3":
        return dict(valid=out["valid"], revenue=out["sum"],
                    cumulants=out["cumulants"])
    if name in ("q6", "q6_exact"):
        mu, var = out["sum"]
        r = dict(normal=(mu[0], var[0]), cumulants=out["cumulants"][0])
        if name == "q6_exact":
            r["exact_coeffs"] = out["exact"][0]
        return r
    if name == "q18":
        return dict(valid=out.valid, confidence=out.prob)
    if name == "q18_exact":
        coeffs = out["exact"]
        gt = torch.arange(coeffs.shape[-1], device=coeffs.device) > 150
        return dict(valid=out["valid"], sum_dist=coeffs,
                    p_qualifies=torch.sum(coeffs * gt[None, :], dim=-1))
    return dict(valid=out.valid, s_name=out["s_name"], prob=out.prob)


def q6_variant(lim: int):
    """Q6 with the quantity limit ``lim`` (a distinct plan per value)."""
    from repro_torch.db import tpch
    from repro_torch.db.plans import GroupAgg, Map, Scan, Select
    sel = Select(Scan("lineitem"), lambda t, lim=lim: (
        (t["l_shipdate"] >= tpch.DAY0_1995 - 400)
        & (t["l_shipdate"] < tpch.DAY0_1995)
        & (t["l_discount"] >= 5) & (t["l_discount"] <= 7)
        & (t["l_quantity"] < lim)))
    val = Map(sel, "q6_value", lambda t: t["l_quantity"] * t["l_discount"])
    return GroupAgg(val, (), "q6_value", "SUM", 1, "normal",
                    extra=(("cumulants", "q6_value", "SUM", "cumulants"),))


def index_tree(x, i: int):
    """Point ``i`` of a swept result (every leaf's leading axis)."""
    from repro_torch.db.table import Table
    if isinstance(x, Table):
        return Table({k: v[i] for k, v in x.columns.items()}, x.prob[i],
                     x.valid[i], x.part)
    if isinstance(x, dict):
        return {k: index_tree(v, i) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(index_tree(v, i) for v in x)
    return x[i]


def table_bytes(t) -> int:
    return sum(x.numel() * x.element_size()
               for x in list(t.columns.values()) + [t.prob, t.valid])


def serving_phase(db, mesh, ref) -> dict:
    """Phase 9 (module docstring): the serving layer at SF1 on the card.
    ``db`` holds the SF1 tables on the card, ``mesh`` is phase 8 (a)'s
    one-rank NCCL mesh, ``ref`` phase 3's digests."""
    import statistics
    import weakref
    import torch
    from repro_torch.db import physical as phys
    from repro_torch.db import tpch
    from repro_torch.db.plans import RetryPolicy, compile_plan
    from repro_torch.db.serving import QueryService
    from repro_torch.db.table import HostTable
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    card = card_line()
    t_phase = time.perf_counter()
    report = dict(card=card)
    lowered = []
    real_lower = phys.lower_plan

    def counted(*a, **k):
        lowered.append(1)
        return real_lower(*a, **k)

    def submit(svc, plan, params=None, **opts):
        """One submit timed to the device's end: (result, info, ms,
        lowerings, launches)."""
        before, n = ops.launches(), len(lowered)
        (out, info), ms = timed(lambda: svc.submit(plan, params, **opts))
        return out, info, ms, len(lowered) - n, {
            k: v - before[k] for k, v in ops.launches().items()}

    phys.lower_plan = counted
    ops.reset_launches()
    try:
        tables = db.tables()
        # -- rounds: one cold, two warm, fresh plan objects every round
        svc = QueryService(tables, capacity=16)
        cold, rows = {}, {}
        for r in range(3):
            for name, (plan, opts) in serving_library().items():
                out, info, ms, n_low, launched = submit(svc, plan, **opts)
                check_finite(f"serving {name}", out)
                if r == 0:
                    check(not info["hit"] and n_low == 1,
                          f"serving {name} cold: {info}, {n_low} lowerings")
                    check(digest(as_query(name, out))
                          == ref[SERVING_PHASE3[name]],
                          f"serving {name}: not bit-equal to phase 3's "
                          f"{SERVING_PHASE3[name]}")
                    cold[name] = out
                    rows[name] = dict(cold_ms=ms, warm_ms=[],
                                      launches=launched)
                    continue
                check(info["hit"] and n_low == 0,
                      f"serving {name} warm: {info}, {n_low} lowerings")
                check(bit_equal(cold[name], out),
                      f"serving {name} warm: not bit-equal to cold")
                check(launched == rows[name]["launches"],
                      f"serving {name} warm launches {launched}, cold "
                      f"{rows[name]['launches']}")
                rows[name]["warm_ms"].append(ms)
                del out
        for name, (plan, opts) in serving_library().items():
            fn = compile_plan(plan, **opts)
            _, rows[name]["bind_ms"] = timed(lambda: fn.bind(tables))
            row = rows[name]
            row["warm_median_ms"] = statistics.median(row["warm_ms"])
            print(f"serving {name}: cold {row['cold_ms']:.1f} ms, warm "
                  f"{row['warm_median_ms']:.1f} ms (median of 2), lowering "
                  f"and placement a hit skips {row['bind_ms']:.1f} ms; "
                  f"launches {row['launches']} cold and warm [{card}]")
        warm_s = sum(sum(r["warm_ms"]) for r in rows.values()) / 1e3
        n_warm = sum(len(r["warm_ms"]) for r in rows.values())
        report.update(plans=rows, warm_qps=n_warm / warm_s,
                      cache=svc.cache.info(), stats=svc.stats.as_dict())
        print(f"serving warm rounds: {n_warm} submits, 100% hits, 0 "
              f"lowerings, {n_warm / warm_s:.2f} queries/s; every warm "
              f"result bit-equal to cold, every cold to phase 3 [{card}]")

        # -- sweep: 64 points, sequential submits, a resweep
        n = SWEEP_POINTS
        dev = db.lineitem.device
        batch = dict(disc_lo=torch.full((n,), 5, device=dev),
                     disc_hi=torch.full((n,), 7, device=dev),
                     qty_lim=torch.arange(1, n + 1, device=dev))
        fam = tpch.q6_family()
        (swept, info), sweep_ms = timed(lambda: svc.sweep(fam, batch))
        check(not info["hit"] and info["points"] == n, f"sweep: {info}")
        seq_ms = 0.0
        for i in range(n):
            out, sinfo, ms, n_low, _ = submit(
                svc, tpch.q6_family(), {k: v[i] for k, v in batch.items()})
            seq_ms += ms
            check(sinfo["hit"] and n_low == 0, f"sweep point {i}: {sinfo}")
            check(bit_equal(out, index_tree(swept, i)),
                  f"sweep point {i} not bit-equal to a sequential submit")
        half = {k: v[:n // 2] for k, v in batch.items()}
        (_, rinfo), _ = timed(lambda: svc.sweep(tpch.q6_family(), half))
        check(rinfo["hit"] and rinfo["points"] == n // 2,
              f"resweep: {rinfo}")
        report["sweep"] = dict(points=n, sweep_ms=sweep_ms,
                               sequential_ms=seq_ms,
                               result=to_host(swept))  # phase 15's ref
        print(f"serving q6 sweep: {n} points {sweep_ms / n:.2f} ms a point "
              f"against {seq_ms / n:.2f} ms a point as sequential submits; "
              f"every point bit-equal; a {n // 2}-point resweep hits "
              f"[{card}]")
        del swept, cold, svc
        gc.collect()

        # -- eviction: capacity 2 over 4 Q6 variants, lineitem on the host
        host = dict(tables, lineitem=HostTable.from_table(db.lineitem))
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        small = QueryService(host, capacity=2)
        refs, ev_ms = [], []
        for lim in (21, 22, 23, 24):
            root = q6_variant(lim)
            ev_ms.append(submit(small, root)[2])
            entry, hit = small.cache.entry(root)
            check(hit, f"eviction: Q6 < {lim} not cached")
            refs.append(weakref.ref(entry))
            del entry
        gc.collect()
        info = small.cache.info()
        alive = torch.cuda.memory_allocated() - m0
        dead = [r() is None for r in refs]
        one_copy = table_bytes(db.lineitem)
        check(info["evictions"] == 2 and dead == [True, True, False, False],
              f"eviction: {info}, dead {dead}")
        # the caching allocator rounds blocks up, so "one copy" is a
        # range: two entries holding a copy each would be 2x
        check(one_copy <= alive < 1.5 * one_copy,
              f"eviction: {alive} B held for one {one_copy} B lineitem copy")
        del small
        gc.collect()
        freed = torch.cuda.memory_allocated() - m0
        check(abs(freed) <= 1 << 20,
              f"eviction: {freed} B still allocated after the service")
        report["eviction"] = dict(info=info, alive_bytes=alive,
                                  lineitem_copy_bytes=one_copy,
                                  after_bytes=freed, submit_ms=ev_ms)
        print(f"serving eviction: capacity 2, 4 plans, {info['evictions']} "
              f"evicted and dead; the entries shared one lineitem copy "
              f"({alive / 1e9:.3f} GB held, a copy is {one_copy / 1e9:.3f}"
              f" GB, {alive - one_copy} B of allocator rounding; cold "
              "submits " + ", ".join(f"{m:.1f}" for m in ev_ms)
              + f" ms, the first one placing it); {freed} B left after "
              f"the service [{card}]")

        # -- streamed: lineitem on the host, phase 4's options, twice
        plan, _ = serving_library()["q6_exact"]
        resident_ref = compile_plan(plan)(tables)
        streamed = QueryService(host, capacity=16, **STREAM_OPTS)
        s_rows = []
        for i in range(2):
            out, sinfo, ms, n_low, launched = submit(
                streamed, serving_library()["q6_exact"][0])
            check(sinfo["hit"] == (i == 1) and n_low == (i == 0),
                  f"streamed submit {i}: {sinfo}, {n_low} lowerings")
            check(bit_equal(resident_ref, out),
                  f"streamed submit {i} not bit-equal to resident")
            check(launched == rows["q6_exact"]["launches"],
                  f"streamed submit {i} launches {launched}")
            s_rows.append(ms)
        report["streamed"] = dict(ms=s_rows)
        print(f"serving streamed q6_exact: cold {s_rows[0]:.1f} ms, hit "
              f"{s_rows[1]:.1f} ms, bit-equal to resident [{card}]")
        del streamed, host, resident_ref

        # -- mesh: phase 8 (a)'s one-rank NCCL mesh
        on_mesh = QueryService(tables, mesh, capacity=16)
        m_rows = {}
        for name in ("q6", "q1"):
            ms_ = []
            for i in range(2):
                out, minfo, ms, n_low, _ = submit(
                    on_mesh, serving_library()[name][0])
                check(minfo["hit"] == (i == 1) and n_low == (i == 0),
                      f"mesh {name} submit {i}: {minfo}")
                check(digest(as_query(name, out))
                      == ref[SERVING_PHASE3[name]],
                      f"mesh {name} submit {i}: not bit-equal to phase 3")
                ms_.append(ms)
            m_rows[name] = ms_
            print(f"serving mesh (NCCL x1) {name}: cold {ms_[0]:.1f} ms, "
                  f"hit {ms_[1]:.1f} ms, both bit-equal to phase 3 [{card}]")
        report["mesh"] = m_rows
        del on_mesh

        # -- healed replay: q18_topk with too small a kappa
        healer = QueryService(tables, capacity=16,
                              policy=RetryPolicy(max_attempts=3))
        root = tpch.q18_topk_plan(Q18_TOPK_GROUPS, 2)
        out1, h1, ms1, _, _ = submit(healer, root)
        check(h1["attempts"] == 2 and h1["report"].issues() == {},
              f"healed replay first submit: {h1['attempts']} attempts, "
              f"{h1['report'].issues()}")
        misses = healer.cache.misses
        out2, h2, ms2, n_low, _ = submit(healer, tpch.q18_topk_plan(
            Q18_TOPK_GROUPS, 2))
        check(h2["attempts"] == 1 and h2["hit"] and n_low == 0
              and healer.cache.misses == misses,
              f"healed replay resubmit: {h2}")
        check(bit_equal(out1, out2), "healed replay not bit-equal")
        report["healed"] = dict(first_ms=ms1, replay_ms=ms2,
                                final_params=h1["report"].final_params)
        print(f"serving healed replay (q18_topk, kappa 2): "
              f"{h1['attempts']} attempts in {ms1:.1f} ms, then 1 attempt, "
              f"a hit, {ms2:.1f} ms, bit-equal [{card}]")
        del healer, out1, out2

        # -- the entry point at its default scale
        t0 = time.perf_counter()
        check(serve.main(["--db"]) == 0, "launch.serve --db failed")
        report["serve_main_s"] = time.perf_counter() - t0
    finally:
        phys.lower_plan = real_lower
    torch.cuda.synchronize()
    launches = ops.launches()
    for k in SERVING_KERNELS:
        check(launches[k] > 0, f"{k} not launched on the serving path")
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    print(f"serving-path launches: {launches}; phase 9 took "
          f"{report['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return report


# --------------------------------- phase 15: the batched (vmap) sweep
#: phase 15's launches: 64 points in launches of this many
VMAP_POINTS_PER_LAUNCH = 16
#: points of the exact-CF family's sweep (every 4th of phase 9's)
VMAP_EXACT_STRIDE = 4
#: vmap against scan: each leaf within this share of its largest
#: magnitude (float32; the one-group passes of the scan sweep against the
#: grouped passes of the batched one, other kernels and fold orders)
VMAP_RTOL = 1e-4
#: cumulant terms: within this share of each order's largest magnitude
#: (an order's terms change sign, so its sum cancels)
VMAP_CUMULANT_RTOL = 1e-3
VMAP_KERNELS = ("group_cumulant_sums", "group_logcf")
#: phase 9's scan sweep, ms a point, as PERF.md section 5 records it
SCAN_MS_A_POINT_RECORDED = 143.81


def to_host(x):
    """A result tree with every tensor on the host."""
    from repro_torch.db.table import Table
    if isinstance(x, Table):
        return Table({k: v.cpu() for k, v in x.columns.items()},
                     x.prob.cpu(), x.valid.cpu(), x.part)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [to_host(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x.cpu()


def q6_exact_family():
    """Phase 9's Q6 family with the exact SUM rider of phase 3's
    ``q6/aggregate_exact`` (4,096 frequencies)."""
    from repro_torch.db import tpch
    from repro_torch.db.plans import GroupAgg
    fam = tpch.q6_family()
    return GroupAgg(fam.child, (), "q6_value", "SUM", 1, "normal",
                    extra=fam.extra + (("exact", "q6_value", "SUM",
                                        "exact"),), num_freq=4096)


def sweep_errors(got, want, what: str, phase: str = "phase 15") -> dict:
    """Each float leaf's largest |vmap - scan| over its scale (the leaf's
    largest magnitude; a cumulant order's own), held to ``VMAP_RTOL`` /
    ``VMAP_CUMULANT_RTOL``; other leaves equal."""
    import torch
    what = f"{phase} {what}"
    lg, lw = dict(leaves(to_host(got))), dict(leaves(want))
    check(lg.keys() == lw.keys(), f"{what}: leaves {sorted(lg)} "
          f"against {sorted(lw)}")
    errs = {}
    for path, w in lw.items():
        g = lg[path]
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}{path}: {g.shape} {g.dtype} against "
              f"{w.shape} {w.dtype}")
        if not w.is_floating_point():
            check(torch.equal(g, w), f"{what}{path} differs")
            continue
        g, w = g.double(), w.double()
        size = torch.where(torch.isfinite(w), w.abs(), 0.0)
        if "cumulants" in path:
            scale = size.reshape(-1, w.shape[-1]).amax(0)
            bound = VMAP_CUMULANT_RTOL
        else:
            scale = size.max()
            bound = VMAP_RTOL
        diff = (g - w).abs()
        diff[torch.isnan(g) & torch.isnan(w)] = 0.0
        err = float((diff / scale.clamp_min(1e-30)).max())
        check(err <= bound, f"{what}{path}: vmap off the scan "
              f"sweep by {err:.3e} of its scale (bound {bound:.0e})")
        errs[path] = err
    return errs


def vmap_phase(db, scan: dict, mesh=None) -> dict:
    """Phase 15 (module docstring): ``QueryService(sweep_mode="vmap")`` at
    SF1 on phase 9's tables.  ``scan`` is phase 9's sweep report (its
    64-point result on the host under "result"); ``mesh``, phase 8 (a)'s
    one-rank mesh, where the first launch's points run again."""
    import torch
    from repro_torch.db import tpch
    from repro_torch.db.serving import QueryService
    from repro_torch.kernels import ops
    card = card_line()
    t_phase = time.perf_counter()
    tables = db.tables()
    dev = db.lineitem.device
    n = SWEEP_POINTS
    batch = dict(disc_lo=torch.full((n,), 5, device=dev),
                 disc_hi=torch.full((n,), 7, device=dev),
                 qty_lim=torch.arange(1, n + 1, device=dev))
    exact_batch = {k: v[::VMAP_EXACT_STRIDE] for k, v in batch.items()}
    m = n // VMAP_EXACT_STRIDE
    # the exact family's scan reference, before the counters reset
    (exact_scan, _), exact_scan_ms = timed(lambda: QueryService(
        tables, capacity=2).sweep(q6_exact_family(), exact_batch))
    exact_scan = to_host(exact_scan)

    svc = QueryService(tables, capacity=16, sweep_mode="vmap")
    svc.batch_row_budget = int(VMAP_POINTS_PER_LAUNCH
                               * svc._per_point_rows(tpch.q6_family()))
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (swept, info), cold_ms = timed(
        lambda: svc.sweep(tpch.q6_family(), batch))
    peak = torch.cuda.max_memory_allocated() - base
    (again, hit), warm_ms = timed(
        lambda: svc.sweep(tpch.q6_family(), batch))
    q6_launches = ops.launches()
    (exact, exact_info), exact_ms = timed(
        lambda: svc.sweep(q6_exact_family(), exact_batch))
    torch.cuda.synchronize()
    launches = ops.launches()
    mesh_ms = None
    if mesh is not None:            # outside the counted window
        first = slice(0, VMAP_POINTS_PER_LAUNCH)
        (on_mesh, _), mesh_ms = timed(lambda: QueryService(
            tables, mesh, sweep_mode="vmap").sweep(
                tpch.q6_family(), {k: v[first] for k, v in batch.items()}))
        check(bit_equal(on_mesh, index_tree(swept, first)),
              "phase 15: the vmap sweep on the mesh is not bit-equal to "
              "one device's")
        del on_mesh
    check(not info["hit"] and info["points"] == n
          and info["launches"] == n // VMAP_POINTS_PER_LAUNCH,
          f"phase 15 sweep: {info}")
    check(hit["hit"] and hit["launches"] == info["launches"],
          f"phase 15 resweep: {hit}")
    check_finite("phase 15 q6", swept)
    check_finite("phase 15 q6 exact", exact)
    errs = sweep_errors(swept, scan["result"], "q6")
    errs_again = sweep_errors(again, scan["result"], "q6 (hit)")
    exact_errs = sweep_errors(exact, exact_scan, "q6 exact")
    for k in VMAP_KERNELS:
        check(launches[k] > 0, f"phase 15: {k} not launched")
    scan_ms = scan["sweep_ms"] / n
    report = dict(
        card=card, points=n, launches_a_sweep=info["launches"],
        points_a_launch=info["chunk"],
        batch_row_budget=svc.batch_row_budget, cold_ms=cold_ms,
        warm_ms=warm_ms, ms_a_point=cold_ms / n,
        warm_ms_a_point=warm_ms / n, scan_ms_a_point=scan_ms,
        scan_ms_a_point_recorded=SCAN_MS_A_POINT_RECORDED,
        peak_bytes=peak,
        q6_launches=q6_launches, launches=launches, errors=errs,
        errors_hit=errs_again,
        exact=dict(points=m, ms=exact_ms, scan_ms=exact_scan_ms,
                   launches=exact_info["launches"], errors=exact_errs),
        mesh_ms=mesh_ms, seconds=time.perf_counter() - t_phase,
        result=to_host(swept), batch=batch)     # phase 16 (b)'s reference
    grouped = {k: launches[k] for k in VMAP_KERNELS}
    print(f"phase 15 vmap sweep, q6 at SF1: {n} points in "
          f"{info['launches']} launches of {info['chunk']}: "
          f"{cold_ms / n:.2f} ms a point cold, {warm_ms / n:.2f} warm "
          f"(a hit), against the scan sweep's {scan_ms:.2f} ms a point in "
          f"phase 9 of this run and {SCAN_MS_A_POINT_RECORDED} ms in "
          f"PERF.md section 5; peak {peak / 1e9:.2f} GB above the "
          f"tables; largest error / scale {max(errs.values()):.3e} "
          f"(bounds {VMAP_RTOL:.0e}, cumulant orders "
          f"{VMAP_CUMULANT_RTOL:.0e}) [{card}]")
    print(f"phase 15 vmap sweep, q6 exact (4096 frequencies): {m} points "
          f"{exact_ms / m:.2f} ms a point against the scan sweep's "
          f"{exact_scan_ms / m:.2f}; largest error / scale "
          f"{max(exact_errs.values()):.3e} [{card}]")
    if mesh is not None:
        print(f"phase 15 vmap sweep on the one-rank {mesh.backend} mesh: "
              f"{VMAP_POINTS_PER_LAUNCH} points in {mesh_ms:.1f} ms, "
              f"bit-equal to one device's first launch [{card}]")
    print(f"phase 15 grouped-kernel launches: {grouped} (q6 sweeps alone: "
          f"{ {k: q6_launches[k] for k in VMAP_KERNELS} }); all "
          f"launches {launches}; phase 15 took {report['seconds']:.1f} s")
    del swept, again, exact
    gc.collect()
    torch.cuda.empty_cache()
    return report


def serving_phases(db, mesh, ref) -> dict:
    """Phases 9, 15 and 16 (a)-(b) on phase 8 (a)'s tables (phase 15
    under "vmap", phase 16's under "sweep_report")."""
    report = serving_phase(db, mesh, ref)
    scan = dict(report["sweep"])
    del report["sweep"]["result"]       # tensors: kept out of the JSON
    report["vmap"] = vmap_phase(db, scan, mesh)
    q6 = dict(result=report["vmap"].pop("result"),
              batch=report["vmap"].pop("batch"),
              batch_row_budget=report["vmap"]["batch_row_budget"])
    report["sweep_report"] = sweep_report_phase(db, q6)
    return report


# ------------------------ phase 16: every sweep the reference's service takes
#: (a) TPC-H Q3's substitution parameters in the spec's own ranges: four
#: of the five market segments, and four dates in 1995-03-01..31 (days
#: after ``tpch.DAY0_1995``, 1995-01-01): 16 points
Q3_SEGMENTS = (0, 1, 2, 3)
Q3_DATE_DAYS = (59, 69, 79, 89)
#: (b) phase 15's Q6 points whose scan sweep with a report is run (every
#: 4th, as phase 15's exact family)
REPORT_SCAN_STRIDE = 4
#: (c) SF0.1 on two gloo ranks sharing the card, 8 points
SF01 = dict(n_orders=150_000, lines_per_order=4, n_parts=20_000,
            n_suppliers=100, n_customers=15_000, n_nations=25, seed=0)
SF01_Q3_GROUPS = 32_768
SWEEP_MESH_POINTS = 8
#: (c) a shuffle_slack under which the probe rows of the points that
#: select more lineitem rows overflow their buckets and the others' fit
SWEEP_MESH_SLACK = 0.5
#: the co-partitioned pipeline's nodes, which (c) must run
COPART_NODES = ("CoPartitionedJoin", "PartitionedAgg")


def q3_family(max_groups: int, order_join_budget: int | None = None):
    """TPC-H Q3 (``tpch.q3_plan``'s structure) with its substitution
    parameters lifted: SEGMENT on ``customer``, DATE on ``orders`` and
    ``lineitem``; the two parameterized relations below ``lineitem``'s
    join are its build side."""
    from repro_torch.db.plans import (FKJoin, GroupAgg, Parameterized, Scan,
                                      Select)
    cust = Select(Scan("customer"), Parameterized(
        lambda t, seg: t["c_mktsegment"] == seg, ("segment",)))
    orders = Select(Scan("orders"), Parameterized(
        lambda t, day: t["o_orderdate"] < day, ("date",)))
    o = FKJoin(orders, cust, "o_custkey", "c_custkey", ("c_mktsegment",))
    li = Select(Scan("lineitem"), Parameterized(
        lambda t, day: t["l_shipdate"] > day, ("date",)))
    j = FKJoin(li, o, "l_orderkey", "o_orderkey",
               ("o_orderdate", "o_custkey"), gather_budget=order_join_budget)
    return GroupAgg(j, ("l_orderkey",), "l_extendedprice", "SUM", max_groups,
                    "normal", extra=(("cumulants", "l_extendedprice", "SUM",
                                      "cumulants"),))


def q3_batch(dev) -> dict:
    """Q3_SEGMENTS x Q3_DATE_DAYS, segment-major."""
    import torch
    from repro_torch.db import tpch
    days = torch.tensor(Q3_DATE_DAYS, device=dev) + tpch.DAY0_1995
    return dict(
        segment=torch.tensor(Q3_SEGMENTS, device=dev).repeat_interleave(
            len(Q3_DATE_DAYS)),
        date=days.repeat(len(Q3_SEGMENTS)))


def keyed_join_family():
    """A join on a key computed en route (a Map), grouped on that key:
    its exchange buckets are sized by ``shuffle_slack``, and with
    ``copartition=True`` it lowers to the co-partitioned pipeline."""
    from repro_torch.db.plans import (FKJoin, GroupAgg, Map, Parameterized,
                                      Scan, Select)
    sel = Select(Scan("lineitem"), Parameterized(
        lambda t, lim: t["l_quantity"] < lim, ("qty_lim",)))
    keyed = Map(sel, "okey", lambda t: t["l_orderkey"])
    j = FKJoin(keyed, Scan("orders"), "okey", "o_orderkey", ("o_custkey",),
               gather_budget=4)
    return GroupAgg(j, ("okey",), "l_quantity", "SUM", Q3_GROUPS)


def report_host(rep, points=None) -> dict:
    """A stacked report's fields with every value on the host (``points``:
    the indices kept)."""
    from repro_torch.db.report import FIELDS
    return {f: {k: (v.cpu() if points is None else v[points].cpu())
                for k, v in getattr(rep, f).items()}
            for f in FIELDS if f != "waves"}


def reports_equal(got: dict, want: dict, what: str) -> dict:
    """Every count equal, point by point; each tail mass within
    ``VMAP_RTOL`` of its scale.  Returns the counts' totals by field."""
    import torch
    totals = {}
    for f, w in want.items():
        g = got[f]
        check(g.keys() == w.keys(), f"{what} report {f}: labels "
              f"{sorted(g)} against {sorted(w)}")
        for k, x in w.items():
            check(g[k].shape == x.shape, f"{what} report {f}[{k}]: "
                  f"{tuple(g[k].shape)} against {tuple(x.shape)}")
            if f == "tail_mass":
                scale = float(x.abs().max().clamp_min(1e-30))
                check(float((g[k] - x).abs().max()) <= VMAP_RTOL * scale,
                      f"{what} report {f}[{k}] off the scan sweep's")
            else:
                check(torch.equal(g[k], x), f"{what} report {f}[{k}]: "
                      f"{g[k].tolist()} against {x.tolist()}")
        totals[f] = {k: float(x.sum()) for k, x in w.items()}
    return totals


def sweep_report_phase(db, q6: dict) -> dict:
    """Phase 16 (a) and (b) (module docstring) on phase 9's SF1 tables.
    ``q6`` holds phase 15's 64-point vmap result on the host, its batch
    and its ``batch_row_budget``."""
    import torch
    from repro_torch.db import tpch
    from repro_torch.db.serving import QueryService
    from repro_torch.kernels import ops
    card = card_line()
    t_phase = time.perf_counter()
    tables = db.tables()
    batch = q3_batch(db.lineitem.device)
    n = batch["date"].shape[0]
    fam = q3_family(Q3_GROUPS)

    # (a) the Q3 family: the scan sweep first (outside the counted window)
    ((scan, srep), _), scan_ms = timed(lambda: QueryService(
        tables, capacity=2).sweep(fam, batch, with_report=True))
    scan, srep = to_host(scan), report_host(srep)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    svc = QueryService(tables, capacity=2, sweep_mode="vmap")
    ops.reset_launches()
    ((swept, vrep), info), vmap_ms = timed(
        lambda: svc.sweep(fam, batch, with_report=True))
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() - base
    check(info["points"] == n and info["launches"] == 1,
          f"phase 16 (a) sweep: {info}")
    check(vrep.points == n, f"phase 16 (a): a report of {vrep.points} "
          "points")
    check(launches["group_cumulant_sums"] > 0,
          f"phase 16 (a): group_cumulant_sums not launched: {launches}")
    check_finite("phase 16 (a) q3", swept)
    errs = sweep_errors(swept, scan, "q3", phase="phase 16 (a)")
    totals = reports_equal(report_host(vrep), srep, "phase 16 (a) q3")
    groups = int(swept["valid"].sum())
    del swept, vrep, scan
    gc.collect()
    torch.cuda.empty_cache()

    # (b) phase 15's Q6 sweep again, with a report
    qsvc = QueryService(tables, capacity=2, sweep_mode="vmap",
                        batch_row_budget=q6["batch_row_budget"])
    ((q6_out, q6_rep), q6_info), q6_ms = timed(lambda: qsvc.sweep(
        tpch.q6_family(), q6["batch"], with_report=True))
    check(bit_equal(to_host(q6_out), q6["result"]),
          "phase 16 (b): the q6 vmap sweep with a report is not bit-equal "
          "to phase 15's")
    picked = slice(0, None, REPORT_SCAN_STRIDE)
    sub = {k: v[picked] for k, v in q6["batch"].items()}
    ((_, q6_srep), _), q6_scan_ms = timed(lambda: QueryService(
        tables, capacity=2).sweep(tpch.q6_family(), sub, with_report=True))
    m = sub["qty_lim"].shape[0]
    picked_idx = torch.arange(0, q6_rep.points, REPORT_SCAN_STRIDE)
    q6_totals = reports_equal(report_host(q6_rep, picked_idx),
                              report_host(q6_srep), "phase 16 (b) q6")
    del q6_out
    report = dict(
        card=card, points=n, scan_ms=scan_ms, vmap_ms=vmap_ms,
        scan_ms_a_point=scan_ms / n, ms_a_point=vmap_ms / n,
        peak_bytes=peak, groups=groups, errors=errs, report_totals=totals,
        launches=launches,
        q6=dict(points=q6_rep.points, launches=q6_info["launches"],
                ms_a_point=q6_ms / q6_rep.points, scan_points=m,
                scan_ms_a_point=q6_scan_ms / m, report_totals=q6_totals),
        seconds=time.perf_counter() - t_phase)
    print(f"phase 16 (a) Q3 family at SF1 (segments {Q3_SEGMENTS} x days "
          f"{Q3_DATE_DAYS} after 1995-01-01, {Q3_GROUPS} groups a point, "
          f"with reports): vmap {vmap_ms / n:.2f} ms a point in one launch, "
          f"scan {scan_ms / n:.2f}; peak {peak / 1e9:.2f} GB above the "
          f"tables; {groups} live groups; largest error / scale "
          f"{max(errs.values()):.3e} (bounds {VMAP_RTOL:.0e}, cumulant "
          f"orders {VMAP_CUMULANT_RTOL:.0e}); report counts equal point by "
          f"point {totals}; launches {launches} [{card}]")
    print(f"phase 16 (b) phase 15's q6 sweep with a report: {q6_rep.points}"
          f" points {q6_ms / q6_rep.points:.2f} ms a point in "
          f"{q6_info['launches']} launches, bit-equal to phase 15's; its "
          f"report at every {REPORT_SCAN_STRIDE}th point equal to the scan "
          f"sweep's ({q6_scan_ms / m:.2f} ms a point); phase 16 (a)-(b) "
          f"took {report['seconds']:.1f} s [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return report


def sweep_mesh_rank(dev) -> dict:
    """One of phase 16 (c)'s two gloo ranks sharing the card: the SF0.1
    Q3 family's vmap sweep with a report through the co-partitioned
    pipeline against the one-device vmap sweep (computed here), and the
    keyed join family's vmap and scan sweeps with reports at
    ``SWEEP_MESH_SLACK``."""
    import torch
    from repro_torch.db import tpch
    from repro_torch.db.plans import compile_plan
    from repro_torch.db.serving import QueryService
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    t_phase = time.perf_counter()
    mesh = make_mesh((2,), ("data",), backend="gloo", device=dev)
    tables = tpch.generate(**SF01, device=dev).tables()
    n = SWEEP_MESH_POINTS
    batch = {k: v[:n] for k, v in q3_batch(dev).items()}
    fam = q3_family(SF01_Q3_GROUPS, order_join_budget=4)
    opts = dict(copartition=True)
    (one, one_rep), _ = QueryService(tables, sweep_mode="vmap").sweep(
        fam, batch, with_report=True)
    explain = compile_plan(fam, mesh, **opts).explain(tables)
    ops.reset_launches()
    ((got, rep), _), ms = timed(lambda: QueryService(
        tables, mesh, sweep_mode="vmap", **opts).sweep(
            fam, batch, with_report=True))
    launches = ops.launches()
    out = dict(explain=explain, bit_equal=bit_equal(got, one), ms=ms,
               launches=launches, q3=(report_host(rep),
                                      report_host(one_rep)))
    del one, got
    lim = dict(qty_lim=torch.floor(torch.linspace(5.0, 45.0, n,
                                                  device=dev)))
    kfam = keyed_join_family()
    kopts = dict(copartition=True, shuffle_slack=SWEEP_MESH_SLACK)
    (kgot, krep), _ = QueryService(tables, mesh, sweep_mode="vmap",
                                   **kopts).sweep(kfam, lim,
                                                  with_report=True)
    (kscan, ksrep), _ = QueryService(tables, mesh, **kopts).sweep(
        kfam, lim, with_report=True)
    out.update(keyed_explain=compile_plan(kfam, mesh, **kopts).explain(
        tables), keyed=(to_host(kgot), report_host(krep), to_host(kscan),
                        report_host(ksrep)),
        seconds=time.perf_counter() - t_phase)
    return out


def sweep_mesh_phase(card: str, ranks: list) -> dict:
    """Phase 16 (c) (module docstring): the checks of what
    :func:`sweep_mesh_rank` returned on phase 14's two ranks."""
    import torch
    launches: dict = {}
    for i, r in enumerate(ranks):
        check(all(node in r["explain"] for node in COPART_NODES),
              f"phase 16 (c) rank {i}: Q3 did not lower to {COPART_NODES}:"
              f"\n{r['explain']}")
        check(r["bit_equal"], f"phase 16 (c) rank {i}: the Q3 vmap sweep "
              "through the co-partitioned pipeline is not bit-equal to one "
              "device's")
        rep, one_rep = r["q3"]
        q3_over = sum(int(v.sum()) for v in
                      rep["exchange_overflow"].values())
        check(q3_over == 0 and len(rep["exchange_overflow"]) == 2,
              f"phase 16 (c) rank {i} q3: exchange legs "
              f"{rep['exchange_overflow']}")
        reports_equal({f: rep[f] for f in ("group_overflow", "state_nan")},
                      {f: one_rep[f] for f in ("group_overflow",
                                               "state_nan")},
                      f"phase 16 (c) rank {i} q3")
        check("CoPartitionedJoin" in r["keyed_explain"],
              f"phase 16 (c) rank {i}: the keyed family did not lower to "
              f"the co-partitioned join:\n{r['keyed_explain']}")
        kgot, krep, kscan, ksrep = r["keyed"]
        keyed_totals = reports_equal(krep, ksrep,
                                     f"phase 16 (c) rank {i} keyed join")
        over = sum(v for v in krep["exchange_overflow"].values())
        check(bool((over > 0).any()) and not bool((over > 0).all()),
              f"phase 16 (c) rank {i}: overflow at points {over.tolist()}: "
              "the case needs some points over and some under")
        poisoned = torch.isnan(kgot["sum"][0]).any(1)
        check(torch.equal(poisoned, over > 0), f"phase 16 (c) rank {i}: "
              f"NaN-poisoned points {poisoned.tolist()} against the "
              f"overflowing {over.tolist()}")
        sweep_errors(kgot, kscan, f"rank {i} keyed join",
                     phase="phase 16 (c)")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    report = dict(ms=max(r["ms"] for r in ranks),
                  points=SWEEP_MESH_POINTS, overflow=over.tolist(),
                  keyed_totals=keyed_totals, launches=launches,
                  seconds=max(r["seconds"] for r in ranks))
    print(f"phase 16 (c) Q3 family at SF0.1, {SWEEP_MESH_POINTS} points, "
          f"two gloo ranks on one card through {' + '.join(COPART_NODES)}: "
          f"vmap {report['ms']:.1f} ms (slowest rank) bit-equal to one "
          f"device's vmap sweep, no exchange overflow, its pass counts "
          f"equal one device's; keyed join at shuffle_slack "
          f"{SWEEP_MESH_SLACK}: probe overflow by point {over.tolist()}, "
          f"each point's counts equal the scan sweep's, exactly those "
          f"points NaN-poisoned; launches (both ranks) {launches}; "
          f"{report['seconds']:.1f} s in phase 14's ranks [{card}]")
    return report


def profile_query(name: str, fn) -> dict:
    """Device time by kernel name for one run of a query, and the device's
    busy share of the run's wall time (torch.profiler over CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        # Device-side events only: a CPU op's entry repeats the device
        # time of the kernels it launched.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {name}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%); top kernels: "
          + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))
    return dict(wall_ms=wall_ms, device_busy_ms=busy, top_kernels=top)


# ------------------------------------------- language-model serving (10)
#: (a): ``launch.serve``'s defaults (batch, prompt length, generated
#: tokens) on yi_6b at its full published config.
LM_SERVE = dict(arch="yi_6b", batch=4, prompt_len=32, gen=16)
#: (b): batch and length of each arch's forward and decode comparison.
LM_CHECK = dict(batch=2, tokens=256)
#: (b): bound on max |decode - forward| / max |forward| of the logits in
#: bfloat16 (about 5 bfloat16 ulps of the largest logit: the two paths
#: differ in product shapes and in the decode's single-shot softmax, so
#: their bfloat16 roundings differ; a wrong mask or cache slot errs by
#: O(1)).
LM_DECODE_BOUND = 2e-2
#: (c): bound on max |card - CPU| / max |CPU| of the reduced configs'
#: float32 logits (TF32 off; the order of float32 sums differs).
LM_CARD_CPU_BOUND = 1e-4
#: the host-side steps a profiled window of decode steps covers.
LM_PROFILE_STEPS = 4


def one_period(cfg):
    """``cfg`` at its full widths cut to one period of its pattern (plus
    its tail); an MoE dropless (capacity factor n_experts / top_k, as the
    reduced configs' 4.0 is), so a 512-token forward and a 2-token decode
    step route every token alike."""
    import dataclasses
    cut = dataclasses.replace(
        cfg, n_layers=len(cfg.pattern) + len(cfg.tail_pattern))
    if cfg.n_experts:
        cut = dataclasses.replace(
            cut, capacity_factor=cfg.n_experts / cfg.top_k)
    return cut


def lm_inputs(cfg, gen, batch: int, tokens: int, device):
    import torch
    from repro_torch.models import frontends
    if cfg.embedding_inputs:
        return frontends.fake_embeddings(gen, batch, tokens, cfg.d_model,
                                         device=device)
    return torch.randint(0, cfg.vocab_size, (batch, tokens), generator=gen,
                         device=device)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def profile_window(fn, steps: int) -> dict:
    """Device time and device operations of ``steps`` calls of ``fn``
    (torch.profiler), and the device's busy share of their wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = launches = 0.0
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        busy += us / 1e3
        launches += e.count
        rows.append((us / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    return dict(wall_ms_a_step=wall_ms / steps,
                device_busy_ms_a_step=busy / steps,
                busy_share=busy / wall_ms,
                device_ops_a_step=launches / steps,
                top=[dict(ms=ms, count=n, name=k[:80])
                     for ms, n, k in rows[:12]])


def decode_window(cfg, model, cache, cl, tok, steps: int) -> dict:
    """:func:`profile_window` over ``steps`` decode steps."""
    from repro_torch.models import api
    state = [cache, cl]

    def one():
        _, state[0], state[1] = api.decode_step(cfg, model, tok, state[0],
                                                state[1])
    return profile_window(one, steps)


def lm_serve_full(card: str, dev: str = "cuda") -> dict:
    """(a) ``launch.serve.generate`` on yi_6b at its full config."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    c = LM_SERVE
    cfg = get_config(c["arch"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt_len"]),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    max_len = c["prompt_len"] + c["gen"] + 1
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = serve.generate(cfg, model, prompt, max_len, c["gen"])
        torch.cuda.synchronize()
        runs.append((toks, time.perf_counter() - t0))
    toks, secs = runs[1]
    check(toks.shape == (c["batch"], c["gen"]), f"generate: {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "generate: a token outside the vocabulary")
    check(torch.equal(runs[0][0], toks), "generate: two runs differ")
    steps = c["prompt_len"] + c["gen"]
    # a profiled window of steps at the last positions (the cache's
    # contents do not change the work)
    cache = api.init_cache(cfg, c["batch"], max_len, dtype=cfg.torch_dtype,
                           device=dev)
    window = decode_window(cfg, model, cache, steps - LM_PROFILE_STEPS,
                           toks[:, -1:], LM_PROFILE_STEPS)
    out = dict(arch=cfg.name, params=nparams, param_bytes=nbytes,
               init_s=init_s, generate_s=[r[1] for r in runs],
               ms_a_step=secs / steps * 1e3,
               tokens_per_s=c["batch"] * c["gen"] / secs,
               decode_tokens_per_s=c["batch"] * steps / secs,
               bound_ms_a_step=nbytes / HBM_BYTES_PER_S * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               profiled=window, tokens=toks[0].tolist())
    print(f"LM (a) {cfg.name} full config ({nparams / 1e9:.3f} B params, "
          f"{nbytes / 1e9:.2f} GB bf16, init {init_s:.1f} s): generate "
          f"batch {c['batch']}, prompt {c['prompt_len']}, gen {c['gen']}: "
          f"{out['ms_a_step']:.2f} ms a decode step ({steps} steps, "
          f"{secs * 1e3:.1f} ms; first run {runs[0][1] * 1e3:.1f} ms), "
          f"{out['tokens_per_s']:.1f} generated tokens/s, "
          f"{out['decode_tokens_per_s']:.1f} tokens/s through decode_step; "
          f"bound {out['bound_ms_a_step']:.2f} ms a step (weights over "
          f"3.35 TB/s); peak {out['peak_gb']:.2f} GB; profiled "
          f"{LM_PROFILE_STEPS} steps: {window['wall_ms_a_step']:.2f} ms "
          f"wall, {window['device_busy_ms_a_step']:.2f} ms device busy "
          f"({100 * window['busy_share']:.1f}%), "
          f"{window['device_ops_a_step']:.0f} device ops a step; both runs "
          f"equal [{card}]")
    return out


def lm_arch_check(arch: str, dev: str = "cuda") -> dict:
    """(b) one arch at full widths, one period deep: forward, then
    decode step by step against the forward's logits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = one_period(get_config(arch))
    b, t = LM_CHECK["batch"], LM_CHECK["tokens"]
    gen = torch.Generator(dev).manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init_params(cfg, gen, dev)
    x = lm_inputs(cfg, gen, b, t, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fwd = api.prefill(cfg, model, x)              # first call: warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd = api.prefill(cfg, model, x)
    torch.cuda.synchronize()
    row = dict(arch=arch, n_layers=cfg.n_layers,
               capacity_factor=cfg.capacity_factor if cfg.n_experts else None,
               params=sum(p.numel() for p in model.parameters()),
               init_s=init_s, forward_ms=(time.perf_counter() - t0) * 1e3)
    check(fwd.shape == (b, t, cfg.vocab_size), f"{arch}: {fwd.shape}")
    check(bool(torch.isfinite(fwd).all()), f"{arch}: forward not finite")
    if cfg.causal:
        cache = api.init_cache(cfg, b, t, dtype=cfg.torch_dtype,
                               device=dev)
        dec = torch.empty_like(fwd)
        cl = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(t):
            lg, cache, cl = api.decode_step(cfg, model, x[:, i:i + 1],
                                            cache, cl)
            dec[:, i] = lg[:, 0]
        torch.cuda.synchronize()
        row["decode_ms_a_step"] = (time.perf_counter() - t0) * 1e3 / t
        check(bool(torch.isfinite(dec).all()), f"{arch}: decode not finite")
        row["decode_vs_forward"] = rel_err(dec, fwd)
        check(row["decode_vs_forward"] <= LM_DECODE_BOUND,
              f"{arch}: decode vs forward {row['decode_vs_forward']:.3e} > "
              f"{LM_DECODE_BOUND}")
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"LM (b) {arch}: {cfg.n_layers} layers at full width "
          f"({row['params'] / 1e9:.3f} B params, init {init_s:.1f} s), "
          f"forward {b}x{t} {row['forward_ms']:.1f} ms (warm)"
          + (f", {t} decode steps {row['decode_ms_a_step']:.2f} ms a step, "
             f"max |decode - forward| / max |forward| "
             f"{row['decode_vs_forward']:.3e} (bound {LM_DECODE_BOUND})"
             if cfg.causal else ", encoder (no decode)")
          + (f", dropless capacity factor {cfg.capacity_factor:g}"
             if cfg.n_experts else "")
          + f"; peak {row['peak_gb']:.2f} GB")
    return row


def lm_card_vs_cpu(arch: str, dev: str = "cuda") -> float:
    """(c) the reduced config (float32), the same weights on both."""
    import copy
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import api
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(3)
    cpu = api.init_params(cfg, gen, "cpu")
    card = copy.deepcopy(cpu).to(dev)
    x = lm_inputs(cfg, gen, 2, 64, "cpu")
    want = api.prefill(cfg, cpu, x)
    got = api.prefill(cfg, card, x.to(dev)).cpu()
    err = rel_err(got, want)
    check(err <= LM_CARD_CPU_BOUND,
          f"{arch}: card vs CPU {err:.3e} > {LM_CARD_CPU_BOUND}")
    return err


def lm_phase(card: str, dev: str = "cuda") -> dict:
    """Phase 10: LM serving (module docstring)."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    before = ops.launches()
    report = dict(serve=lm_serve_full(card, dev))
    gc.collect()
    torch.cuda.empty_cache()
    report["archs"] = []
    for arch in ARCH_IDS:
        report["archs"].append(lm_arch_check(arch, dev))
        gc.collect()
        torch.cuda.empty_cache()
    report["card_vs_cpu"] = {a: lm_card_vs_cpu(a, dev) for a in ARCH_IDS}
    print("LM (c) reduced configs, float32, card vs CPU, max |card - CPU| "
          "/ max |CPU|: " + ", ".join(f"{a} {e:.2e}" for a, e in
                                      report["card_vs_cpu"].items())
          + f" (bound {LM_CARD_CPU_BOUND})")
    cli = {}
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        if not cfg.causal:
            continue
        argv = ["--arch", arch, "--device", dev]
        if cfg.embedding_inputs:
            try:
                serve.main(argv)
            except SystemExit as e:
                check(e.code == 2, f"serve.main {arch}: exit {e.code}")
                cli[arch] = "refused (embedding inputs)"
                continue
            raise AssertionError(f"serve.main {arch}: not refused")
        t0 = time.perf_counter()
        check(serve.main(argv) == 0, f"serve.main {arch}")
        cli[arch] = time.perf_counter() - t0
    report["cli_s"] = cli
    print("LM (d) launch.serve.main --arch A --device cuda: "
          + ", ".join(f"{a} {v:.2f} s" if isinstance(v, float)
                      else f"{a} {v}" for a, v in cli.items()))
    check(ops.launches() == before,
          "LM serving launched a kernel of the DB path")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10 took {report['seconds']:.1f} s [{card}]")
    return report


# ------------------------------------------ language-model training (11)
#: (a): yi_6b at its full published config, ``make_train_step`` (AdamW,
#: moments in the parameters' bf16, accum 1, remat on): STEPS steps of
#: BATCH x SEQ TokenStream tokens, the first a warm-up, then one profiled.
LM_TRAIN = dict(arch="yi_6b", batch=2, seq=512, steps=3)
#: (a) again at yi_6b's 4096 context, on (a)'s model and state: a warm-up
#: step, STEPS timed, one whose model part (loss + backward) and update
#: part (clip + AdamW) are timed apart, one profiled.  The keys stream
#: through four 1,024-key chunks, in the forward and the backward.
LM_TRAIN_LONG = dict(batch=2, seq=4096, steps=2)
#: tokens of one optimizer step of the train_4k shape (configs/base.py
#: SHAPES: 4,096 x 256), for the update's share reckoned at that size
TRAIN_4K_TOKENS = 4096 * 256
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 (tensor cores)
#: (b): batch and length of each arch's train step at full width.
LM_TRAIN_CHECK = dict(batch=1, tokens=256)
#: (b): a train state (params, grads, two moments: 4x the parameter
#: bytes) above this share of the card's memory takes the gradients and
#: the clip but no AdamW step (nemotron: 4 x 25.8 GB).
TRAIN_STATE_SHARE = 0.85
#: (c): each reduced config's float32 gradients, card against CPU: max
#: |card - CPU| over a leaf's scale (its max |g_CPU|, at least
#: GRAD_ZERO_FLOOR of the model's largest gradient: hubert's key-bias
#: gradient is 0 exactly, rounding noise on both), bound LM_CARD_CPU_BOUND
#: (phase 10's for logits).
GRAD_ZERO_FLOOR = 1e-3
#: (d): the restart check (the reference's test_train case).
RESTART = dict(steps=8, fail=4, ckpt_every=3, batch=4, seq=16)
#: (e): the sampler's pool (the reference example's 50-95% inclusion) and
#: the eps whose capacity must equal the plain version's.  A float32 PGF
#: of 4,096 examples places its tail only to ~1e-4 (train/data.py), so
#: the capacities at 1e-4 and 1e-6 are printed beside float64's, not held.
#: The kernel's log CF and PGF are held to the plain version's (the same
#: float32 frequency grid) within CF_BOUND.
SAMPLER_POOL = 4096
SAMPLER_EPS = 1e-2
SAMPLER_EPS_SHOWN = (1e-4, 1e-6)
CF_BOUND = 2e-5               # the kernel phase's logcf bound (sum |term|)


def attn_pairs(cfg, kind: str, seq: int) -> int:
    """(query, key) pairs one sequence's attention layer of ``kind`` needs:
    all of them bidirectional, the causal triangle, the band of a local
    window."""
    if not cfg.causal:
        return seq * seq
    w = cfg.window if kind == "attn_local" else 0
    if w and w < seq:
        return w * (w + 1) // 2 + (seq - w) * w
    return seq * (seq + 1) // 2


def train_flops(cfg, batch: int, seq: int) -> dict:
    """FLOPs of one train step.  ``needed``: 6 N T for the matrix products
    (forward 2, backward 4; N the parameters outside the embedding
    lookup) plus the attention's score and value products over the pairs
    the masks keep, 12 hd a pair and head.  ``executed``: what the port
    runs, with remat's recomputed forward (8 N T) and every score of the
    square (16 hd a pair and head)."""
    lookup = not cfg.embedding_inputs and not cfg.tie_embeddings
    n = cfg.param_count() - (cfg.vocab_size * cfg.d_model if lookup else 0)
    hh = cfg.n_heads * cfg.resolved_head_dim
    kinds = [k for k in cfg.pattern * cfg.n_periods + cfg.tail_pattern
             if k.startswith("attn")]
    needed = sum(12 * hh * batch * attn_pairs(cfg, k, seq) for k in kinds)
    executed = 16 * hh * batch * seq * seq * len(kinds)
    return dict(needed=6.0 * n * batch * seq + needed,
                executed=8.0 * n * batch * seq + executed)


def finite_params(model) -> bool:
    import torch
    return all(bool(torch.isfinite(p).all()) for p in model.parameters())


def flops_line(flops: dict, ms: float) -> str:
    """The FLOP counts of :func:`train_flops` against a step of ``ms``."""
    need, ran = flops["needed"], flops["executed"]
    return (f"model FLOPs a step {need:.3e} needed, bound "
            f"{need / BF16_OPS_PER_S * 1e3:.2f} ms at 989 TFLOP/s bf16 "
            f"({need / ms / 1e9:.1f} TFLOP/s achieved, "
            f"{100 * need / BF16_OPS_PER_S * 1e3 / ms:.1f}% of the bound); "
            f"remat and the masked-out scores add {ran - need:.3e} "
            f"({ran:.3e} executed, {ran / ms / 1e9:.1f} TFLOP/s)")


def timed_steps(step, model, state, stream, steps: int, first: int = 0):
    """ms, losses and grad norms of ``steps`` train steps on the stream's
    batches ``first``, ``first + 1``, ..."""
    import torch
    ms, losses, norms = [], [], []
    for i in range(first, first + steps):
        batch = stream.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return ms, losses, norms


def lm_train_full(card: str, dev: str = "cuda") -> dict:
    """(a) ``make_train_step`` on yi_6b at its full config, then at its
    4096 context (:func:`lm_train_long`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.train.data import TokenStream
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import make_train_step
    c = LM_TRAIN
    cfg = get_config(c["arch"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = AdamW()
    state = opt.init(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    state_gb = (nbytes + sum(m.numel() * m.element_size()
                             for m in (*state.mu.values(),
                                       *state.nu.values()))) / 1e9
    step = make_train_step(cfg, opt, accum=1, remat=True)
    stream = TokenStream(cfg.vocab_size, seq_len=c["seq"],
                         global_batch=c["batch"], seed=0, device=dev)
    ms, losses, norms = timed_steps(step, model, state, stream, c["steps"])
    check(all(map(math.isfinite, losses + norms)),
          f"yi_6b train: loss {losses} / grad norm {norms} not finite")
    check(finite_params(model), "yi_6b train: a parameter is not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = stream.batch(c["steps"])
    window = profile_window(lambda: step(model, state, batch), 1)
    tokens = c["batch"] * c["seq"]
    flops = train_flops(cfg, c["batch"], c["seq"])
    step_ms = sum(ms[1:]) / len(ms[1:])
    out = dict(arch=cfg.name, params=cfg.param_count(), param_bytes=nbytes,
               state_gb=state_gb, init_s=init_s, step_ms=ms,
               ms_a_step=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               flops_a_step=flops["needed"],
               flops_executed_a_step=flops["executed"],
               bound_ms_a_step=flops["needed"] / BF16_OPS_PER_S * 1e3,
               peak_gb=peak_gb, loss=losses, grad_norm=norms,
               profiled=window)
    print(f"LM train (a) {cfg.name} full config ({cfg.param_count() / 1e9:.3f}"
          f" B params; params + moments {state_gb:.2f} GB, init {init_s:.1f}"
          f" s): batch {c['batch']} x {c['seq']} tokens, AdamW bf16 "
          f"moments, remat: {step_ms:.1f} ms a step (steps "
          + ", ".join(f"{t:.1f}" for t in ms) + " ms; the first warms up), "
          f"{out['tokens_per_s']:.0f} tokens/s; "
          + flops_line(flops, step_ms) + f"; peak {peak_gb:.2f} GB; loss "
          + " -> ".join(f"{x:.4f}" for x in losses) + ", grad norm "
          + ", ".join(f"{x:.3f}" for x in norms) + f"; one profiled step: "
          f"{window['wall_ms_a_step']:.1f} ms wall, "
          f"{window['device_busy_ms_a_step']:.1f} ms device busy "
          f"({100 * window['busy_share']:.1f}%), "
          f"{window['device_ops_a_step']:.0f} device ops [{card}]")
    print("LM train (a) the profiled step's device time by kernel: "
          + "; ".join(f"{r['name']} {r['ms']:.1f} ms x{r['count']:.0f}"
                      for r in window["top"]))
    out["long"] = lm_train_long(cfg, opt, model, state, step, card, dev)
    return out


def lm_train_long(cfg, opt, model, state, step, card: str,
                  dev: str = "cuda") -> dict:
    """(a) at 4096 context (``LM_TRAIN_LONG``) on (a)'s model and state:
    the step's time, its model and update parts apart (the calls of
    ``make_train_step``'s accum-1 branch), and the update's share
    reckoned at train_4k's tokens a step (``TRAIN_4K_TOKENS``: that many
    tokens / these microbatches of model time, one update; the
    accumulation pass of accum > 1 left out)."""
    import torch
    from repro_torch.models import api
    from repro_torch.models.transformer import KV_CHUNK
    from repro_torch.train.data import TokenStream
    from repro_torch.train.optimizer import clip_by_global_norm
    c = LM_TRAIN_LONG
    stream = TokenStream(cfg.vocab_size, seq_len=c["seq"],
                         global_batch=c["batch"], seed=0, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, norms = timed_steps(step, model, state, stream,
                                    1 + c["steps"])
    batch = stream.batch(1 + c["steps"])
    params = dict(model.named_parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = api.loss_fn(cfg, model, batch["tokens"], batch["labels"],
                          remat=True)
    loss.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, gnorm = clip_by_global_norm({k: p.grad for k, p in params.items()},
                                   1.0)
    opt.update({k: p.grad for k, p in params.items()}, state, params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for p in params.values():
        p.grad = None
    losses.append(float(loss.detach()))
    norms.append(float(gnorm))
    check(all(map(math.isfinite, losses + norms)),
          f"yi_6b train at {c['seq']}: loss {losses} / grad norm {norms} "
          "not finite")
    check(finite_params(model), f"yi_6b train at {c['seq']}: a parameter "
          "is not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = stream.batch(2 + c["steps"])
    window = profile_window(lambda: step(model, state, batch), 1)
    tokens = c["batch"] * c["seq"]
    flops = train_flops(cfg, c["batch"], c["seq"])
    step_ms = sum(ms[1:]) / len(ms[1:])
    model_ms, update_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    micros = TRAIN_4K_TOKENS // tokens
    share_4k = update_ms / (micros * model_ms + update_ms)
    out = dict(batch=c["batch"], seq=c["seq"], step_ms=ms, ms_a_step=step_ms,
               tokens_per_s=tokens / step_ms * 1e3,
               flops_a_step=flops["needed"],
               flops_executed_a_step=flops["executed"],
               bound_ms_a_step=flops["needed"] / BF16_OPS_PER_S * 1e3,
               model_ms=model_ms, update_ms=update_ms,
               update_share=update_ms / (model_ms + update_ms),
               update_share_train_4k=share_4k, peak_gb=peak_gb,
               loss=losses, grad_norm=norms, profiled=window)
    print(f"LM train (a) {cfg.name} at its {c['seq']} context: batch "
          f"{c['batch']} x {c['seq']} tokens ({-(-c['seq'] // KV_CHUNK)} key "
          "chunks),"
          f" accum 1: {step_ms:.1f} ms a step (steps "
          + ", ".join(f"{t:.1f}" for t in ms) + " ms; the first warms up), "
          f"{out['tokens_per_s']:.0f} tokens/s; " + flops_line(flops, step_ms)
          + f"; one step in parts: loss + backward {model_ms:.1f} ms, clip "
          f"+ AdamW {update_ms:.1f} ms ({100 * out['update_share']:.1f}%; "
          f"at train_4k's {TRAIN_4K_TOKENS} tokens a step, {micros} such "
          f"microbatches and one update, reckoned {100 * share_4k:.2f}%); "
          f"peak {peak_gb:.2f} GB; loss "
          + " -> ".join(f"{x:.4f}" for x in losses) + "; one profiled step: "
          f"{window['wall_ms_a_step']:.1f} ms wall, "
          f"{window['device_busy_ms_a_step']:.1f} ms device busy "
          f"({100 * window['busy_share']:.1f}%), "
          f"{window['device_ops_a_step']:.0f} device ops [{card}]")
    print(f"LM train (a) {c['seq']} context, the profiled step's device time"
          " by kernel: "
          + "; ".join(f"{r['name']} {r['ms']:.1f} ms x{r['count']:.0f}"
                      for r in window["top"]))
    return out


def lm_train_arch(arch: str, dev: str = "cuda") -> dict:
    """(b) one train step of an arch at full widths, one period deep (the
    bf16 attention backward through ``_BmmF32``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.train.optimizer import AdamW, clip_by_global_norm
    from repro_torch.train.trainer import make_train_step
    cfg = one_period(get_config(arch))
    b, t = LM_TRAIN_CHECK["batch"], LM_TRAIN_CHECK["tokens"]
    gen = torch.Generator(dev).manual_seed(4)
    torch.cuda.reset_peak_memory_stats()
    model = api.init_params(cfg, gen, dev)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    full = 4 * nbytes <= TRAIN_STATE_SHARE * \
        torch.cuda.get_device_properties(0).total_memory
    x = lm_inputs(cfg, gen, b, t, dev)
    y = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if full:
        opt = AdamW()
        state = opt.init(model)
        m = make_train_step(cfg, opt)(model, state,
                                      dict(tokens=x, labels=y))
        loss, gnorm = m["loss"], m["grad_norm"]
    else:
        loss, _ = api.loss_fn(cfg, model, x, y, remat=True)
        loss.backward()
        _, gnorm = clip_by_global_norm(
            {k: p.grad for k, p in model.named_parameters()}, 1.0)
    torch.cuda.synchronize()
    row = dict(arch=arch, n_layers=cfg.n_layers, params=cfg.param_count(),
               state_gb=4 * nbytes / 1e9, adamw=full,
               step_ms=(time.perf_counter() - t0) * 1e3,
               loss=float(loss.detach()), grad_norm=float(gnorm),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]),
          f"{arch} train step: loss {row['loss']}, grad norm "
          f"{row['grad_norm']}")
    check(finite_params(model), f"{arch} train step: a parameter is not "
          "finite")
    print(f"LM train (b) {arch}: {cfg.n_layers} layers at full width "
          f"({row['params'] / 1e9:.3f} B params), {b}x{t} tokens: "
          + (f"train step {row['step_ms']:.1f} ms (first call)" if full
             else f"loss + gradients + clip {row['step_ms']:.1f} ms (first "
                  f"call; no AdamW: its state, 4 x {nbytes / 1e9:.1f} GB, "
                  "exceeds the card)")
          + f", loss {row['loss']:.4f}, grad norm {row['grad_norm']:.3f}, "
          f"peak {row['peak_gb']:.2f} GB")
    return row


def lm_grads_card_vs_cpu(arch: str, dev: str = "cuda") -> float:
    """(c) the reduced config's float32 gradients, the same weights and
    batch on the CPU and the card: the largest leaf error over its scale."""
    import copy
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import api
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(5)
    cpu = api.init_params(cfg, gen, "cpu")
    card = copy.deepcopy(cpu).to(dev)
    x = lm_inputs(cfg, gen, 2, 64, "cpu")
    y = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    grads = []
    for model, d in ((cpu, "cpu"), (card, dev)):
        loss, _ = api.loss_fn(cfg, model, x.to(d), y.to(d), remat=True)
        loss.backward()
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    want, got = grads
    top = max(float(g.abs().max()) for g in want.values())
    err = 0.0
    for k, w in want.items():
        scale = max(float(w.abs().max()), GRAD_ZERO_FLOOR * top)
        err = max(err, float((got[k] - w).abs().max()) / scale)
    check(err <= LM_CARD_CPU_BOUND,
          f"{arch}: gradients card vs CPU {err:.3e} > {LM_CARD_CPU_BOUND}")
    return err


def lm_restart(out_dir, dev: str = "cuda") -> dict:
    """(d) reduced yi_6b through ``run_with_failures`` against an
    uninterrupted run: the final parameters and moments bit-equal."""
    import shutil
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.train.data import TokenStream
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import Trainer, run_with_failures
    r = RESTART
    cfg = get_reduced("yi_6b")
    stream = TokenStream(cfg.vocab_size, seq_len=r["seq"],
                         global_batch=r["batch"], device=dev)
    opt = AdamW(lr=1e-3, warmup=5)
    root = pathlib.Path(out_dir) / "train_restart"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    m1, s1, h1 = Trainer(cfg, opt, stream, str(root / "a"),
                         ckpt_every=r["ckpt_every"], device=dev).run(r["steps"])
    m2, s2, h2, attempts = run_with_failures(
        Trainer(cfg, opt, stream, str(root / "b"),
                ckpt_every=r["ckpt_every"], device=dev), r["steps"],
        {r["fail"]})
    secs = time.perf_counter() - t0
    check(attempts == 2, f"restart: {attempts} attempts")
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        check(torch.equal(a, b), f"restart: parameter {n} not bit-equal")
    for n in s1.mu:
        check(torch.equal(s1.mu[n], s2.mu[n])
              and torch.equal(s1.nu[n], s2.nu[n]),
              f"restart: moments of {n} not bit-equal")
    check(int(s1.step) == int(s2.step) == r["steps"], "restart: step count")
    check(h2 == h1[-len(h2):], "restart: the resumed losses differ")
    shutil.rmtree(root, ignore_errors=True)
    print(f"LM train (d) restart: reduced yi_6b, {r['steps']} steps, a "
          f"failure after step {r['fail']}, checkpoints every "
          f"{r['ckpt_every']}: 2 attempts, parameters and moments bit-equal "
          f"to the uninterrupted run ({secs:.1f} s both)")
    return dict(attempts=attempts, seconds=secs, losses=h1)


def psum_rank(g, e, device) -> tuple:
    """(f) one of two gloo ranks sharing the card: ``compressed_psum`` of
    its row over the ``pod`` axis."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import compressed_psum
    mesh = make_mesh((tdist.get_world_size(),), ("pod",), backend="gloo",
                     device=device)
    r = tdist.get_rank()
    return compressed_psum(g[r].to(mesh.device), e[r].to(mesh.device),
                           mesh.axis("pod"))


def lm_compressed_psum(out_dir, dev: str = "cuda") -> dict:
    """(f) ``compressed_psum`` over two gloo ranks sharing the card."""
    import shutil
    import torch
    from repro_torch.testing.ranks import run_ranks
    gen = torch.Generator().manual_seed(6)
    g = torch.randn(2, 1 << 16, generator=gen)
    e = torch.randn(2, 1 << 16, generator=gen) * 1e-3
    store = pathlib.Path(out_dir) / "train_psum"
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = run_ranks(psum_rank, 2, backend="gloo", device=dev,
                      store_dir=store, args=(g, e, dev))
    secs = time.perf_counter() - t0
    shutil.rmtree(store, ignore_errors=True)
    x = (g + e).to(dev)
    # the same arithmetic in one process: a shared max scale, int8
    # payloads summed exactly
    scale = (x.abs().amax(dim=1).clamp_min(1e-12)
             / torch.full((), 127.0, device=dev)).max()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    want = (q.sum(0).float() * scale / torch.full((), 2.0, device=dev)).cpu()
    mean = (g + e).mean(0)
    rel = float((ranks[0][0] - mean).abs().max() / mean.abs().max())
    check(torch.equal(ranks[0][0], ranks[1][0]),
          "compressed_psum: the two ranks differ")
    check(torch.equal(ranks[0][0], want),
          "compressed_psum: not the shared-scale int8 mean")
    check(rel < 0.05, f"compressed_psum: {rel:.3e} of the true mean")
    print(f"LM train (f) compressed_psum, 2 gloo ranks on the card, "
          f"{g.shape[1]} floats each: both ranks bit-equal to the shared-"
          f"scale int8 mean, max err {rel:.3e} of the true mean (bound "
          f"0.05), {secs:.1f} s with the spawn")
    return dict(rel=rel, seconds=secs)


def lm_sampler(dev: str = "cuda") -> dict:
    """(e) ``ProbabilisticSampler`` on SAMPLER_POOL float32 probabilities:
    one ``logcf`` launch (read by the caller around this call)."""
    import numpy as np
    from repro_torch.train.data import ProbabilisticSampler
    probs = np.random.default_rng(11).uniform(0.5, 0.95, SAMPLER_POOL)
    s = ProbabilisticSampler(probs, seed=0, device=dev)
    return dict(sampler=s, pgf=s.batch_size_pgf())


def lm_sampler_check(s, pgf, card: str) -> dict:
    """(e) against the plain version on the card: the log CF within the
    kernel phase's logcf bound, the PGF within it, the capacities."""
    import torch
    from repro_torch.core import poisson_binomial as pb
    from repro_torch.kernels import pb_cf
    from repro_torch.train.data import capacity_from
    p = s.probs()
    check(p.dtype == torch.float32 and p.is_cuda, "sampler: not float32 on "
          "the card")
    ones = torch.ones_like(p)
    nf = p.shape[0] + 1
    la, an = pb_cf.logcf(p, ones, num_freq=nf)        # a comparison launch
    la_p, an_p = pb_cf.logcf_plain(p, ones, nf)
    windows = (0, nf // 2 - 128, nf - 256)
    rel = cf_gap(la, an, la_p, an_p, p, ones, nf, windows, 256)
    # each against float64 terms: printed, not held (module docstring)
    rel64 = (cf_window_errors(la, an, p, ones, nf, windows, 256)[2],
             cf_window_errors(la_p, an_p, p, ones, nf, windows, 256)[2])
    plain = pb.logcf_finalize(la_p, an_p)
    f64 = pb.count_pgf(p.double()).coeffs           # float64: no kernel
    pgf_err = float((pgf.coeffs - plain).abs().max())
    caps = {eps: (s.capacity_for(eps), capacity_from(plain, eps),
                  capacity_from(f64, eps))
            for eps in (SAMPLER_EPS, *SAMPLER_EPS_SHOWN)}
    check(rel <= CF_BOUND, f"sampler logcf vs plain: {rel:.3e} of "
          "sum|term|")
    check(pgf_err <= CF_BOUND, f"sampler PGF vs plain: {pgf_err:.3e}")
    k, pl, _ = caps[SAMPLER_EPS]
    check(k == pl, f"sampler capacity({SAMPLER_EPS}): kernel {k}, plain {pl}")
    check(abs(float(pgf.mean()) - float(p.double().sum()))
          <= 1e-3 * float(p.double().sum()), "sampler: E[batch]")
    print(f"LM train (e) ProbabilisticSampler, {p.shape[0]} float32 "
          f"probabilities on the card: 1 logcf launch; log CF max |kernel "
          f"- plain| / sum|term| {rel:.3e}, PGF max |kernel - plain| "
          f"{pgf_err:.3e} (bound {CF_BOUND}); against float64 terms kernel "
          f"{rel64[0]:.3e}, plain {rel64[1]:.3e} (float32 grid of an odd "
          f"N; not held); E[batch] {float(pgf.mean()):.2f}; capacity "
          + "; ".join(f"eps {e:g}: kernel {c[0]}, plain {c[1]}, float64 "
                      f"{c[2]}" for e, c in caps.items())
          + f" (held at eps {SAMPLER_EPS:g}) [{card}]")
    return dict(cf_rel=rel, cf_rel_float64=rel64, pgf_err=pgf_err,
                capacities={str(e): c for e, c in caps.items()})


def train_phase(card: str, out_dir, dev: str = "cuda") -> dict:
    """Phase 11: LM training (module docstring).  The launch counters are
    reset before its path and read after it; the sampler's comparison
    launches come after the reading."""
    import shutil
    import torch
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    t_phase = time.perf_counter()
    ops.reset_launches()
    report = dict(full=lm_train_full(card, dev))
    gc.collect()
    torch.cuda.empty_cache()
    report["archs"] = []
    for arch in ARCH_IDS:
        report["archs"].append(lm_train_arch(arch, dev))
        gc.collect()
        torch.cuda.empty_cache()
    report["grads_card_vs_cpu"] = {a: lm_grads_card_vs_cpu(a, dev)
                                   for a in ARCH_IDS}
    print("LM train (c) reduced configs, float32, gradients card vs CPU, "
          "max |card - CPU| over a leaf's scale: "
          + ", ".join(f"{a} {e:.2e}" for a, e in
                      report["grads_card_vs_cpu"].items())
          + f" (bound {LM_CARD_CPU_BOUND})")
    report["restart"] = lm_restart(out_dir, dev)
    report["psum"] = lm_compressed_psum(out_dir, dev)
    cli_dir = pathlib.Path(out_dir) / "train_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    t0 = time.perf_counter()
    check(launch_train.main(
        ["--arch", "yi_6b", "--reduced", "--device", dev, "--steps", "4",
         "--ckpt-dir", str(cli_dir)]) == 0, "launch.train.main")
    shutil.rmtree(cli_dir, ignore_errors=True)
    report["cli_s"] = time.perf_counter() - t0
    print(f"LM train (g) launch.train.main --arch yi_6b --reduced --device "
          f"cuda --steps 4: {report['cli_s']:.2f} s")
    before = ops.launches()
    sampled = lm_sampler(dev)
    torch.cuda.synchronize()
    launches = ops.launches()
    check(before == {k: 0 for k in launches},
          f"LM training before the sampler launched {before}")
    check(launches == dict(before, logcf=1),
          f"the sampler's launches: {launches}")
    report["launches"] = launches
    report["sampler"] = lm_sampler_check(sampled["sampler"], sampled["pgf"],
                                         card)
    report["seconds"] = time.perf_counter() - t_phase
    print(f"training-path launches: {launches}; phase 11 took "
          f"{report['seconds']:.1f} s [{card}]")
    return report


# ------------------------------------------------------ phase 12: LM mesh
#: Phase 12: yi_6b (a) and olmoe_1b_7b (b) at their full widths cut to
#: ``layers`` layers, bf16, ``batch`` x ``seq`` tokens, ``steps`` steps
#: of ``make_train_step`` (AdamW, remat) on a ``shape`` mesh of gloo ranks
#: sharing the card; (d) saves after step ``save_after`` and restores
#: under ``restore_shape``.  One layer deep since phase 16 joined the run
#: (two before), to keep the run inside its time limit.
LM_MESH = dict(arch="yi_6b", moe="olmoe_1b_7b", layers=1, batch=4, seq=512,
               steps=3, shape=(2, 2), restore_shape=(4, 1), save_after=2,
               wide_shape=(1, 4), prompt=5, decode=3)
#: (f): the sharded decode's logits against one rank's (float32 weights;
#: tests/test_torch_fsdp.py's ATOL)
MESH_DECODE_ATOL = 5e-5
#: (a), (b): the mesh's loss and grad norm against one rank's on the card,
#: relative (bf16: the rows' sums run in another order on the mesh)
MESH_LOSS_RTOL = 1e-2
MESH_NORM_RTOL = 2e-2


def mesh_cfg(name: str):
    """``name``'s published config cut to LM_MESH's depth."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), n_layers=LM_MESH["layers"])


def mesh_stream(cfg, dev):
    from repro_torch.train.data import TokenStream
    c = LM_MESH
    return TokenStream(cfg.vocab_size, seq_len=c["seq"],
                       global_batch=c["batch"], seed=0, device=dev)


def mesh_one_rank(cfg, dev) -> dict:
    """The same model (seed 0 on the card), batches and step on one rank:
    ms a step, losses, grad norms, each MoE layer's drops after the first
    step."""
    import torch
    from repro_torch.models import api
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import make_train_step
    model = api.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = AdamW()
    state = opt.init(model)
    step = make_train_step(cfg, opt, accum=1, remat=True)
    stream = mesh_stream(cfg, dev)
    out = dict(ms=[], loss=[], grad_norm=[], drops=None)
    for i in range(LM_MESH["steps"]):
        batch = stream.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, state, batch)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if out["drops"] is None and cfg.n_experts:
            out["drops"] = [int(b.ffn.dropped) for b in model.layers]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_run(cfg, rules, dev, on_step=None) -> dict:
    """The sharded step on ``rules``' mesh from the same model: ms a step
    (every rank synchronised and at a barrier before each), losses, grad
    norms, drops after the first step, bytes received a step by
    collective kind; ``on_step(i, model, state)`` after step i."""
    import torch
    import torch.distributed as tdist
    from repro_torch import sharding
    from repro_torch.models import api
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import make_train_step
    sm = sharding.ShardedModel(
        api.init_params(cfg, torch.Generator(dev).manual_seed(0), dev), rules)
    opt = AdamW()
    state = opt.init(sm)
    step = make_train_step(cfg, opt, accum=1, remat=True)
    stream = mesh_stream(cfg, dev)
    out = dict(ms=[], loss=[], grad_norm=[], drops=None, bytes=[])
    with rules.activate():
        for i in range(LM_MESH["steps"]):
            batch = stream.batch(i)
            torch.cuda.synchronize()
            tdist.barrier()
            sharding.reset_collective_bytes()
            t0 = time.perf_counter()
            m = step(sm, state, batch)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["bytes"].append(dict(sharding.COLLECTIVE_BYTES))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            if out["drops"] is None and cfg.n_experts:
                out["drops"] = [int(b.ffn.dropped) for b in sm.work.layers]
            if on_step is not None:
                on_step(i, sm, state)
    out.update(model=sm, state=state, step=step, stream=stream)
    return out


def mesh_train_rank(out_dir, dev) -> dict:
    """One of phase 12's four gloo ranks sharing the card (module
    docstring); rank 0 also runs the one-rank references.  Returns plain
    numbers and flags."""
    import shutil
    import torch
    import torch.distributed as tdist
    from repro_torch import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import elastic
    c = LM_MESH
    rank = tdist.get_rank()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(c["shape"], ("data", "model"), backend="gloo",
                     device=dev)
    other = make_mesh(c["restore_shape"], ("data", "model"), backend="gloo",
                      device=dev)
    wide = make_mesh(c["wide_shape"], ("data", "model"), backend="gloo",
                     device=dev)
    rules = sharding.Rules(mesh, fsdp=True)
    ckdir = pathlib.Path(out_dir) / "mesh_ckpt"
    out = dict(rank=rank, coords=mesh.coords)

    # (a) yi_6b; (c) again; (d) the checkpoint of (a) after save_after
    cfg = mesh_cfg(c["arch"])
    out["one"] = mesh_one_rank(cfg, dev) if rank == 0 else None
    tdist.barrier()
    saved: dict = {}

    def save(i, sm, state):
        if i + 1 != c["save_after"]:
            return
        tree = sm.tree(state)
        saved.update({k: v.local.clone()
                      for k, v in ck.flatten(tree).items()})
        if rank == 0:
            shutil.rmtree(ckdir, ignore_errors=True)
        tdist.barrier()
        t0 = time.perf_counter()
        ck.save(str(ckdir), i + 1, tree)
        out["save_s"] = time.perf_counter() - t0
    a = mesh_run(cfg, rules, dev, on_step=save)
    final = {n: t.clone() for n, t in a["model"].params.items()}
    out["a"] = {k: a[k] for k in ("ms", "loss", "grad_norm", "bytes")}
    out["a"]["shard_bytes"] = sum(t.numel() * t.element_size()
                                  for t in final.values())
    out["a"]["first_fit"] = rules.layouts.get("first_fit")
    del a
    gc.collect()
    torch.cuda.empty_cache()
    b = mesh_run(cfg, rules, dev)
    out["rerun_equal"] = b["loss"] == out["a"]["loss"] and all(
        torch.equal(final[n], b["model"].params[n]) for n in final)
    t0 = time.perf_counter()
    placed, _ = ck.restore(str(ckdir), c["save_after"],
                           b["model"].tree(b["state"]),
                           shardings=sharding.state_shardings(
                               sharding.Rules(other, fsdp=True), cfg))
    back = elastic.reshard(placed, rules)
    out["restore_s"] = time.perf_counter() - t0
    flat = ck.flatten(back)
    out["restored_leaves"] = len(saved)
    out["restored_equal"] = flat.keys() == saved.keys() and all(
        torch.equal(flat[k].local, saved[k]) for k in saved)
    b["model"].load_(back, b["state"])
    with rules.activate():
        m = b["step"](b["model"], b["state"],
                      b["stream"].batch(c["save_after"]))
    out["resumed_equal"] = float(m["loss"]) == out["a"]["loss"][
        c["save_after"]] and all(torch.equal(final[n], b["model"].params[n])
                                 for n in final)
    del b, placed, back, flat, final, saved
    gc.collect()
    torch.cuda.empty_cache()
    tdist.barrier()
    if rank == 0:
        shutil.rmtree(ckdir, ignore_errors=True)

    # (b) olmoe_1b_7b: experts over the model axis, routing global
    cfg = mesh_cfg(c["moe"])
    out["moe_one"] = mesh_one_rank(cfg, dev) if rank == 0 else None
    tdist.barrier()
    r = mesh_run(cfg, rules, dev)
    out["b"] = {k: r[k] for k in ("ms", "loss", "grad_norm", "bytes",
                                  "drops")}
    out["b"]["shard_bytes"] = sum(t.numel() * t.element_size()
                                  for t in r["model"].params.values())
    out["b"]["finite"] = all(bool(torch.isfinite(t).all())
                             for t in r["model"].params.values())
    del r
    gc.collect()
    torch.cuda.empty_cache()

    # (e) yi_6b on (1, 4): heads (its 4 KV heads divide the axis), MLP
    # width and vocabulary split four ways
    cfg = mesh_cfg(c["arch"])
    r = mesh_run(cfg, sharding.Rules(wide, fsdp=True), dev)
    out["e"] = {k: r[k] for k in ("ms", "loss", "grad_norm", "bytes")}
    out["e"]["shard_bytes"] = sum(t.numel() * t.element_size()
                                  for t in r["model"].params.values())
    out["e"]["first_fit"] = r["model"].rules.layouts.get("first_fit")
    del r
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the sharded decode on (2, 2) against one rank's
    out["f"] = mesh_decode(rules, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = ops.launches()
    return out


def mesh_decode(rules, dev) -> dict:
    """(f) yi_6b's layers at full width with float32 weights (seed 0):
    ``decode`` steps after a ``prompt`` fed token by token, the sharded
    model (a cache of blocks: the KV heads over the model axis) against
    the same model on this rank; max |logits - one rank's| over the steps,
    and ms a sharded step."""
    import dataclasses
    import torch
    from repro_torch import sharding
    from repro_torch.models import api
    c = LM_MESH
    cfg = dataclasses.replace(mesh_cfg(c["arch"]), dtype="float32")
    n = c["prompt"] + c["decode"]

    def model():
        return api.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    one, sm = model(), sharding.ShardedModel(model(), rules)
    gen = torch.Generator(dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (c["batch"], n),
                           generator=gen, device=dev)
    cache = api.init_cache(cfg, c["batch"], n, dtype=torch.float32,
                           device=dev)
    blocks = sm.init_cache(c["batch"], n, dtype=torch.float32)
    err, ms = 0.0, []
    sharding.reset_collective_bytes()
    for t in range(n):
        tok = tokens[:, t:t + 1]
        want, cache, _ = api.decode_step(cfg, one, tok, cache, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, blocks, _ = api.decode_step(cfg, sm, tok, blocks, t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        err = max(err, float((got - want).abs().max()))
    cache_spec = blocks["0"]["k"].sharding.spec
    out = dict(err=err, ms=ms, bytes=dict(sharding.COLLECTIVE_BYTES),
               cache_spec=cache_spec)
    del one, sm, cache, blocks
    return out


def mesh_close(what: str, mesh: dict, one: dict) -> dict:
    """(a), (b): every step's loss and grad norm against one rank's."""
    err = dict(loss=max(abs(x - y) / abs(y) for x, y in
                        zip(mesh["loss"], one["loss"])),
               grad_norm=max(abs(x - y) / abs(y) for x, y in
                             zip(mesh["grad_norm"], one["grad_norm"])))
    check(all(map(math.isfinite, mesh["loss"] + mesh["grad_norm"])),
          f"{what}: loss / grad norm not finite")
    check(err["loss"] <= MESH_LOSS_RTOL,
          f"{what}: loss {mesh['loss']} against one rank's {one['loss']}")
    check(err["grad_norm"] <= MESH_NORM_RTOL,
          f"{what}: grad norm {mesh['grad_norm']} against one rank's "
          f"{one['grad_norm']}")
    return err


def mesh_line(what: str, cfg, ranks: list, key: str, one: dict,
              err: dict, card: str, shape=None) -> dict:
    ms = [max(r[key]["ms"][i] for r in ranks)
          for i in range(LM_MESH["steps"])]
    step_ms = sum(ms[1:]) / len(ms[1:])
    kinds = sorted({k for r in ranks for b in r[key]["bytes"] for k in b})
    per_step = {k: sum(b.get(k, 0) for r in ranks for b in r[key]["bytes"])
                / LM_MESH["steps"] for k in kinds}
    one_ms = sum(one["ms"][1:]) / len(one["ms"][1:])
    c = LM_MESH
    print(f"LM mesh {what} {cfg.name} at full widths, {cfg.n_layers} layers "
          f"({cfg.param_count() / 1e9:.3f} B params), bf16, "
          f"{c['batch']} x {c['seq']} tokens, {shape or c['shape']} "
          f"('data', 'model') mesh of 4 gloo ranks on one card: "
          f"{step_ms:.1f} ms a step (slowest rank; steps "
          + ", ".join(f"{t:.1f}" for t in ms) + f"; one rank {one_ms:.1f} "
          f"ms), blocks {ranks[0][key]['shard_bytes'] / 1e9:.3f} GB a rank; "
          "bytes received a step, all ranks: "
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in per_step.items())
          + "; loss " + " -> ".join(f"{x:.4f}" for x in ranks[0][key]["loss"])
          + " (one rank " + " -> ".join(f"{x:.4f}" for x in one["loss"])
          + f"), max rel err loss {err['loss']:.2e} (bound {MESH_LOSS_RTOL}),"
          f" grad norm {err['grad_norm']:.2e} (bound {MESH_NORM_RTOL}) "
          f"[{card}]")
    return dict(step_ms=ms, ms_a_step=step_ms, one_rank_ms=one["ms"],
                bytes_a_step=per_step, loss=ranks[0][key]["loss"],
                grad_norm=ranks[0][key]["grad_norm"], one=one, err=err)


def mesh_train_phase(card: str, out_dir, dev: str = "cuda") -> dict:
    """Phase 12: the LM mesh (module docstring).  The launch counters of
    each rank are reset at its start and read at its end."""
    import shutil
    from repro_torch.testing.ranks import run_ranks
    t_phase = time.perf_counter()
    store = pathlib.Path(out_dir) / "mesh_train"
    shutil.rmtree(store, ignore_errors=True)
    ranks = run_ranks(mesh_train_rank, 4, backend="gloo", device=dev,
                      store_dir=store, args=(str(out_dir), dev),
                      timeout=900)
    shutil.rmtree(store, ignore_errors=True)
    one, moe_one = ranks[0]["one"], ranks[0]["moe_one"]
    for key in ("a", "b"):
        for r in ranks[1:]:
            check(r[key]["loss"] == ranks[0][key]["loss"]
                  and r[key]["grad_norm"] == ranks[0][key]["grad_norm"],
                  f"LM mesh ({key}): the ranks report other metrics")
    report = dict(
        a=mesh_line("(a)", mesh_cfg(LM_MESH["arch"]), ranks, "a", one,
                    mesh_close("LM mesh (a)", ranks[0]["a"], one), card))
    report["a"]["first_fit"] = ranks[0]["a"]["first_fit"]
    report["b"] = mesh_line("(b)", mesh_cfg(LM_MESH["moe"]), ranks, "b",
                            moe_one, mesh_close("LM mesh (b)", ranks[0]["b"],
                                                moe_one), card)
    drops = [r["b"]["drops"] for r in ranks]
    check(all(d == moe_one["drops"] for d in drops),
          f"LM mesh (b): dropped tokens {drops} against one rank's "
          f"{moe_one['drops']}")
    check(all(r["b"]["finite"] for r in ranks),
          "LM mesh (b): a parameter is not finite")
    report["b"]["drops"] = moe_one["drops"]
    for key in ("a", "b"):
        report[key]["rank_bytes"] = [r[key]["bytes"] for r in ranks]
    report["e"] = mesh_line("(e)", mesh_cfg(LM_MESH["arch"]), ranks, "e",
                            one, mesh_close("LM mesh (e)", ranks[0]["e"],
                                            one), card,
                            shape=LM_MESH["wide_shape"])
    report["e"]["first_fit"] = ranks[0]["e"]["first_fit"]
    report["e"]["rank_bytes"] = [r["e"]["bytes"] for r in ranks]
    check(all(r["e"]["loss"] == ranks[0]["e"]["loss"] for r in ranks),
          "LM mesh (e): the ranks report other metrics")
    dec = [r["f"] for r in ranks]
    check(all(d["err"] <= MESH_DECODE_ATOL for d in dec),
          f"LM mesh (f): decode logits off one rank's by "
          f"{[d['err'] for d in dec]} (bound {MESH_DECODE_ATOL})")
    dec_ms = [max(d["ms"][i] for d in dec) for i in range(len(dec[0]["ms"]))]
    report["f"] = dict(err=[d["err"] for d in dec], ms=dec_ms,
                       bytes=[d["bytes"] for d in dec],
                       cache_spec=dec[0]["cache_spec"])
    c = LM_MESH
    print(f"LM mesh (f) {c['arch']} {c['layers']} layers at full width, "
          f"float32 weights, decode of {c['batch']} rows ({c['prompt']} "
          f"prompt tokens fed one a step, then {c['decode']} steps) on "
          f"{c['shape']}, cache spec {dec[0]['cache_spec']}: max |logits - "
          f"one rank's| {max(report['f']['err']):.3e} (bound "
          f"{MESH_DECODE_ATOL}); ms a step (slowest rank) "
          + ", ".join(f"{t:.1f}" for t in dec_ms) + "; bytes received, "
          "all steps, rank 0: " + ", ".join(
              f"{k} {v / 1e6:.3f} MB" for k, v in
              sorted(dec[0]["bytes"].items())) + f" [{card}]")
    print(f"LM mesh (b) dropped (token, choice) pairs after the first step, "
          f"by layer: {drops[0]} on every rank, one rank {moe_one['drops']}"
          f" (equal: the routing is global)")
    check(all(r["rerun_equal"] for r in ranks),
          "LM mesh (c): a rerun of (a) is not bit-equal")
    print("LM mesh (c) (a) again on the mesh: losses, grad norms and every "
          "rank's parameter blocks bit-equal")
    check(all(r["restored_equal"] for r in ranks),
          "LM mesh (d): a restored leaf differs from the saved one")
    check(all(r["resumed_equal"] for r in ranks),
          "LM mesh (d): step 3 after the restore differs")
    print(f"LM mesh (d) (a)'s state after step {LM_MESH['save_after']} saved "
          f"under {LM_MESH['shape']} (full arrays, "
          f"{ranks[0]['save_s']:.1f} s), restored under "
          f"{LM_MESH['restore_shape']} and resharded back "
          f"({max(r['restore_s'] for r in ranks):.1f} s): all "
          f"{ranks[0]['restored_leaves']} leaves bit-equal on every rank; "
          f"step {LM_MESH['save_after'] + 1} after it bit-equal to (a)'s")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    check(launches == {k: 0 for k in launches},
          f"LM mesh launched kernels: {launches}")
    peaks = [r["peak_gb"] for r in ranks]
    report.update(
        peak_gb=peaks, launches=launches,
        save_s=ranks[0]["save_s"],
        restore_s=max(r["restore_s"] for r in ranks),
        seconds=time.perf_counter() - t_phase)
    print(f"LM mesh: peak device memory a rank "
          + ", ".join(f"{p:.2f}" for p in peaks) + f" GB (rank 0 ran the "
          f"one-rank references too); launches {launches}; phase 12 took "
          f"{report['seconds']:.1f} s [{card}]")
    return report


# ------------------------------------------------- phase 13: the dry-run
#: (a) the dry-run's subset on both production meshes (every cell on both
#: meshes takes ~35 min of tracing on 6 cores), traced in a subprocess
#: started at the top of the run, beside phases 1-12
DRYRUN_CELLS = ("nemotron_4_340b/train_4k", "nemotron_4_340b/decode_32k",
                "olmoe_1b_7b/train_4k", "pgf_tpch/query")
#: (a) cells given the calibration's FLOPs, bytes and collective bytes
#: alone (1 and 2 periods, accum 2 and 4; equal to the full trace on the
#: port), not a full-depth trace: nemotron's train_4k takes ~11 min of one
#: core a mesh, and its peak is the CPU host's full trace's (PERF.md)
DRYRUN_CALIBRATED = ("nemotron_4_340b/train_4k",)
#: (b) cells run on the card at a one-rank NCCL mesh (1, 1), at full width
#: and depth, each beside the dry-run's trace of the same cell: (arch,
#: shape, the cell builder's batch / accum / n_tuples)
CARD_CELLS = (("yi_6b", "train_4k", dict(batch=2, accum=1)),
              ("yi_6b", "decode_32k", dict(batch=4)),
              ("yi_6b", "prefill_32k", dict(batch=1)),
              ("pgf_tpch", "query", dict(n_tuples=1 << 24)))
#: (b) the card's step peak (max allocated less what was allocated before)
#: against the dry-run's: within the larger of 5% and 1 GiB
PEAK_RTOL = 0.05
PEAK_ATOL = 1 << 30


def dryrun_commands(out_dir) -> dict:
    """The dry-run invocations of phase 13: (a) the subset on both
    production meshes, (b) each card cell at its settings on (1, 1), (c)
    phase 12's configuration (LM_MESH) on a fake world of 4; and phase
    14's: (d) the pgf cell at PGF_MESH's size on each of its meshes."""
    base = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    d = pathlib.Path(out_dir) / "dryrun"
    b = []
    for arch, shape, kw in CARD_CELLS:
        cmd = base + ["--arch", arch, "--shape", shape, "--mesh", "1x1",
                      "--out", str(d / "b")]
        for k, v in kw.items():
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        b.append(cmd)
    c = LM_MESH
    pgf = [base + ["--arch", "pgf_tpch", "--shape", "query", "--mesh",
                   "x".join(map(str, shape)), "--n-tuples",
                   str(PGF_MESH["n_tuples"]), "--out", str(d / "d")]
           for shape in PGF_MESH["shapes"]]
    return dict(
        a=[base + ["--cells", ",".join(DRYRUN_CELLS), "--both-meshes",
                   "--calibrate-only", ",".join(DRYRUN_CALIBRATED),
                   "--jobs", "2", "--out", str(d / "a")]],
        bc=b + [base + ["--cells", f"{c['arch']}/train_4k,"
                        f"{c['moe']}/train_4k", "--mesh",
                        "x".join(map(str, c["shape"])), "--layers",
                        str(c["layers"]), "--batch", str(c["batch"]),
                        "--seq", str(c["seq"]), "--accum", "1", "--out",
                        str(d / "c")]] + pgf)


class DryRuns:
    """Phase 13's dry-runs in the background: (a) in one process, (b) and
    (c) one after another in another; their output under
    ``out_dir/dryrun``.  :meth:`wait` joins them; :meth:`stop` ends any
    still running."""

    def __init__(self, out_dir):
        import shutil
        import threading
        self.dir = pathlib.Path(out_dir) / "dryrun"
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.procs: list = []
        self.rcs: dict = {}
        self.t0 = time.perf_counter()
        self.seconds: dict = {}

        def run(key, cmds):
            rcs = []
            with open(self.dir / f"{key}.log", "w") as log:
                for cmd in cmds:
                    # a session of its own: stop() ends its workers too
                    p = subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT, env=env,
                                         cwd=str(ROOT),
                                         start_new_session=True)
                    self.procs.append(p)
                    rcs.append(p.wait())
            self.rcs[key] = rcs
            self.seconds[key] = time.perf_counter() - self.t0
        self.threads = [threading.Thread(target=run, args=(k, v),
                                         daemon=True)
                        for k, v in dryrun_commands(out_dir).items()]
        for t in self.threads:
            t.start()

    def wait(self, timeout: float) -> None:
        end = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(0.0, end - time.perf_counter()))
        check(not any(t.is_alive() for t in self.threads),
              f"phase 13: the dry-runs did not end within {timeout} s")
        for key, rcs in self.rcs.items():
            check(all(rc == 0 for rc in rcs), f"phase 13: dry-run {key} "
                  f"exited {rcs}: " + (self.dir / f"{key}.log").read_text()
                  [-3000:])

    def stop(self) -> None:
        import signal
        for p in self.procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()

    def results(self, sub: str) -> dict:
        return {json.loads(p.read_text())["cell"] + "@" + p.stem.rsplit(
            "_", 1)[1]: json.loads(p.read_text())
            for p in sorted((self.dir / sub).glob("*.json"))}


def card_cell_args(cell, arch: str, dev):
    """The card cell's arguments: the blocks of a seeded model (whole on
    (1, 1)), zero optimizer state and cache, seeded tokens; the pgf
    cell's seeded columns (p in (0, 1), integer values 1-50, 4,096
    groups)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import api
    gen = torch.Generator(dev).manual_seed(0)
    if arch == "pgf_tpch":
        n = cell.args["probs"].shape[0]
        return dict(
            probs=torch.rand(n, generator=gen, device=dev),
            values=torch.randint(1, 51, (n,), generator=gen, device=dev,
                                 dtype=torch.int32),
            gids=torch.randint(0, 4096, (n,), generator=gen, device=dev,
                               dtype=torch.int32))
    cfg = configs.get_config(arch)
    model = api.init_params(cfg, gen, dev)
    params = {n: p.detach() for n, p in model.named_parameters()}
    del model

    def fill(path, t):
        if path[0] in ("tokens", "labels"):
            t.copy_(torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                  device=dev, dtype=t.dtype))
        else:
            t.zero_()
    args = cell.materialize(dev, fill=lambda path, t: None
                            if path[0] == "params" else fill(path, t))
    args["params"] = params
    return args


def card_cells(card: str, dry: dict) -> dict:
    """Phase 13 (b): each card cell once counted (FLOPs by the dry-run's
    own formulas, ``launch.dryrun.LiveBytes``; the step's peak by the
    allocator; the launch counters) and once timed, against the dry-run's
    trace of the same cell."""
    import torch
    import torch.distributed as tdist
    from repro_torch.kernels import ops
    from repro_torch.launch import cells as C
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.launch.mesh import make_mesh
    store = ROOT / "build" / "chip_smoke" / "phase13_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    tdist.init_process_group("nccl", store=tdist.FileStore(str(store), 1),
                             rank=0, world_size=1,
                             device_id=torch.device("cuda", 0))
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), backend="nccl",
                         device="cuda:0")
        dev = mesh.device
        for arch, shape, kw in CARD_CELLS:
            name = f"{arch}/{shape}"
            want = dry[f"{name}@1x1"]
            cell = C.build_cell(arch, shape, mesh, **kw)
            args = card_cell_args(cell, arch, dev)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            with LiveBytes() as live:
                res = cell.fn(**args)
            torch.cuda.synchronize()
            counted_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() - before
            launches = {k: v for k, v in ops.launches().items() if v}
            finite = all(bool(torch.isfinite(t).all()) for t in
                         (res.values() if isinstance(res, dict) else
                          res if isinstance(res, tuple) else [res])
                         if torch.is_tensor(t) and t.is_floating_point())
            del res
            if shape == "prefill_32k":      # ~a minute a step: once
                ms = counted_ms
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cell.fn(**args)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            del args, cell
            dry_peak = want["memory"]["temp_peak"]
            tol = max(PEAK_RTOL * dry_peak, PEAK_ATOL)
            roof = want["roofline"]
            t_dom = roof["t_" + roof["dominant"]] * 1e3
            r = dict(ms=ms, counted_ms=counted_ms, flops=live.flops,
                     dry_flops=want["flops_counted"], peak=peak,
                     dry_peak=dry_peak, live_peak=live.peak,
                     launches=launches,
                     dry_launches={k: v for k, v in want["launches"].items()
                                   if v},
                     dominant=roof["dominant"], dominant_ms=t_dom,
                     kernel_flops=want["kernel_flops"], finite=finite)
            out[name] = r
            print(f"phase 13 (b) {name} {kw} on a (1, 1) NCCL mesh: "
                  f"{ms:.1f} ms a step (counted run {counted_ms:.1f} ms) "
                  f"beside the dry-run's dominant term {roof['dominant']} "
                  f"{t_dom:.1f} ms (compute {roof['t_compute'] * 1e3:.1f}, "
                  f"memory {roof['t_memory'] * 1e3:.1f} ms); FLOPs card "
                  f"{live.flops:.6e} / dry-run {want['flops_counted']:.6e}"
                  + (f" (+ kernels {want['kernel_flops']:.4e})"
                     if want["kernel_flops"] else "")
                  + f"; step peak card {peak / 1e9:.3f} GB (live storages "
                  f"{live.peak / 1e9:.3f}) / dry-run {dry_peak / 1e9:.3f} GB"
                  f" (tolerance {tol / 1e9:.3f}); launches {launches} / "
                  f"dry-run {r['dry_launches']} [{card}]")
            check(finite, f"phase 13 (b) {name}: output not finite")
            check(live.flops == want["flops_counted"],
                  f"phase 13 (b) {name}: FLOPs {live.flops} against the "
                  f"dry-run's {want['flops_counted']}")
            check(abs(peak - dry_peak) <= tol,
                  f"phase 13 (b) {name}: peak {peak} against the dry-run's "
                  f"{dry_peak}")
            check(launches == r["dry_launches"],
                  f"phase 13 (b) {name}: launches {launches} against the "
                  f"dry-run's {r['dry_launches']}")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    return out


def dryrun_phase(card: str, runs: "DryRuns", mesh_train: dict) -> dict:
    """Phase 13 (module docstring): (a) the dry-run's lines, (b) the card
    against the dry-run, (c) phase 12's bytes against the dry-run's."""
    from repro_torch.launch.dryrun import summary
    t_phase = time.perf_counter()
    runs.wait(timeout=600)
    report = dict(seconds_background=dict(runs.seconds))
    a = runs.results("a")
    check(sorted(a) == sorted(f"{c}@{m}" for c in DRYRUN_CELLS
                              for m in ("16x16", "2x16x16")),
          f"phase 13 (a): dry-run results {sorted(a)}")
    for tag, res in a.items():
        check("error" not in res, f"phase 13 (a) {tag}: {res.get('error')}")
        print(f"phase 13 (a) dry-run {tag}: {summary(res)}")
    report["a"] = {k: dict(memory=v["memory"], roofline=v["roofline"],
                           collectives=v["collectives"]["bytes"],
                           launches=v["launches"],
                           model_flops_per_device=v.get(
                               "model_flops_per_device"))
                   for k, v in a.items()}
    report["b"] = card_cells(card, runs.results("b"))
    c = runs.results("c")
    for key, arch in (("a", LM_MESH["arch"]), ("b", LM_MESH["moe"])):
        want = c[f"{arch}/train_4k@2x2"]["collectives"]["bytes"]
        got = mesh_train[key]["rank_bytes"]
        check(all(step == want for rank in got for step in rank),
              f"phase 13 (c) {arch}: phase 12 received {got}, the dry-run "
              f"{want}")
        print(f"phase 13 (c) {arch} ({LM_MESH['layers']} layers, "
              f"{LM_MESH['shape']}, {LM_MESH['batch']} x {LM_MESH['seq']}) "
              "bytes received a step by kind, every rank and step of phase "
              "12 = the dry-run on a fake world of 4: "
              + ", ".join(f"{k} {v}" for k, v in sorted(want.items())))
        report.setdefault("c", {})[arch] = want
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13 took {report['seconds']:.1f} s here; the dry-runs "
          f"{runs.seconds} s from the start of the run [{card}]")
    return report


# ------------------------------------- phase 14: the pgf cell on meshes
#: the pgf cell run for real at 2^20 tuples (the config's 2^16 CF
#: frequencies and 4,096 groups) on a one-rank NCCL mesh and on two gloo
#: ranks sharing the card, whose model axis splits the CF's frequencies
PGF_MESH = dict(n_tuples=1 << 20, shapes=((1, 1), (1, 2)))


def pgf_run(mesh) -> dict:
    """Two runs of the pgf cell on ``mesh`` from the seeded columns
    (``card_cell_args``): the first counted (ms, the launches it made, the
    CF's coefficients on the host, finite), the second timed (ms)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import cells as C
    cell = C.build_pgf_cell(mesh, n_tuples=PGF_MESH["n_tuples"])
    args = card_cell_args(cell, "pgf_tpch", mesh.device)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = cell.fn(**args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in ops.launches().items() if v}
    finite = all(bool(torch.isfinite(t).all()) for t in res
                 if torch.is_tensor(t) and t.is_floating_point())
    coeffs = res[3].cpu()
    del res
    t0 = time.perf_counter()
    cell.fn(**args)
    torch.cuda.synchronize()
    return dict(counted_ms=ms, ms=(time.perf_counter() - t0) * 1e3,
                launches=launches, coeffs=coeffs, finite=finite)


def pgf_mesh_rank(dev) -> dict:
    """One of phase 14's two gloo ranks; phase 16 (c) runs in the same
    ranks after it (one spawn for both)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(PGF_MESH["shapes"][1], ("data", "model"),
                     backend="gloo", device=dev)
    out = pgf_run(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    out["sweep"] = sweep_mesh_rank(dev)
    return out


def pgf_mesh_phase(card: str, runs: "DryRuns", out_dir) -> dict:
    """Phase 14 (module docstring)."""
    import shutil
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.testing.ranks import run_ranks
    t_phase = time.perf_counter()
    dry = runs.results("d")
    store = ROOT / "build" / "chip_smoke" / "phase14_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    tdist.init_process_group("nccl", store=tdist.FileStore(str(store), 1),
                             rank=0, world_size=1,
                             device_id=torch.device("cuda", 0))
    try:
        one = pgf_run(make_mesh(PGF_MESH["shapes"][0], ("data", "model"),
                                backend="nccl", device="cuda:0"))
    finally:
        tdist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    rstore = pathlib.Path(out_dir) / "pgf_mesh"
    shutil.rmtree(rstore, ignore_errors=True)
    ranks = run_ranks(pgf_mesh_rank, 2, backend="gloo", device="cuda",
                      store_dir=rstore, args=("cuda",), timeout=600)
    shutil.rmtree(rstore, ignore_errors=True)
    sweeps = [r.pop("sweep") for r in ranks]
    tags = ["x".join(map(str, s)) for s in PGF_MESH["shapes"]]
    want = [{k: v for k, v in dry[f"pgf_tpch/query@{t}"]["launches"].items()
             if v} for t in tags]
    err = float((ranks[0]["coeffs"] - one["coeffs"]).abs().max())
    check(one["finite"] and all(r["finite"] for r in ranks),
          "phase 14: pgf output not finite")
    check(one["launches"] == want[0],
          f"phase 14 (1, 1): launches {one['launches']} against the "
          f"dry-run's {want[0]}")
    check(all(r["launches"] == want[1] for r in ranks),
          f"phase 14 (1, 2): launches {[r['launches'] for r in ranks]} "
          f"against the dry-run's {want[1]}")
    check("group_logcf" in want[1], "phase 14: the (1, 2) dry-run reaches "
          f"no group_logcf: {want[1]}")
    check(all(torch.equal(r["coeffs"], ranks[0]["coeffs"]) for r in ranks),
          "phase 14 (1, 2): the ranks' CFs differ")
    check(err <= CF_BOUND, f"phase 14: the (1, 2) CF off the (1, 1) CF by "
          f"{err:.3e} (bound {CF_BOUND})")
    launches = dict(one["launches"])
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    report = dict(one_ms=one["ms"], mesh_ms=max(r["ms"] for r in ranks),
                  one_counted_ms=one["counted_ms"],
                  mesh_counted_ms=max(r["counted_ms"] for r in ranks),
                  launches_one=one["launches"],
                  launches_mesh=[r["launches"] for r in ranks],
                  cf_err=err, launches=launches,
                  seconds=time.perf_counter() - t_phase
                  - max(r["seconds"] for r in sweeps))
    print(f"phase 14 pgf_tpch/query, {PGF_MESH['n_tuples']} tuples, 4096 "
          f"groups, 2^16 CF frequencies: (1, 1) NCCL {one['ms']:.1f} ms "
          f"(counted run {one['counted_ms']:.1f}), launches "
          f"{one['launches']} (= dry-run); (1, 2) two gloo ranks on one "
          f"card {report['mesh_ms']:.1f} ms (slowest rank; counted run, "
          f"the rank's first, {report['mesh_counted_ms']:.1f}), "
          f"launches a rank {ranks[0]['launches']} (= dry-run); CF max "
          f"|(1, 2) - (1, 1)| {err:.3e} (bound {CF_BOUND}); "
          f"{report['seconds']:.1f} s [{card}]")
    report["sweep_mesh"] = sweep_mesh_phase(card, sweeps)
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card on this host", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "build" / "chip_smoke"
    if "--out" in sys.argv:
        out_dir = pathlib.Path(sys.argv[sys.argv.index("--out") + 1])
    out_dir.mkdir(parents=True, exist_ok=True)
    dryruns = DryRuns(out_dir)          # phase 13's, in the background
    try:
        return run(out_dir, dryruns)
    finally:
        dryruns.stop()


def run(out_dir, dryruns) -> int:
    """Phases 1-16 (module docstring)."""
    import numpy as np
    import torch
    from repro_torch.db import tpch
    from repro_torch.kernels import build, ops
    report = {}
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    report["card"] = card
    report["device"] = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s -> {lib}")
    (out_dir / "build.log").write_text((lib.parent / "build.log").read_text())

    rng = np.random.default_rng(0)
    rows = kernel_phase(dev, rng)
    # cumulant_sums at the value path's 10^8 tuples, timed before the
    # TPC-H phase: after its query profiles the profiler lost kernel rows
    # of these calls in two runs of two (timings)
    p9 = fig9_probs(dev)
    rows["cumulant_sums"]["fit_shape"] = cumulants_at_fit_shape(
        p9, torch.ones_like(p9))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    db = tpch.generate(**SF1, device="cuda")
    torch.cuda.synchronize()
    report["generate_s"] = time.perf_counter() - t0
    print(f"SF1 tables on the card: lineitem {db.lineitem.capacity} rows, "
          f"partsupp {db.partsupp.capacity} rows, "
          f"{report['generate_s']:.1f} s")
    queries = run_queries(db, sf1=True)

    # The main path: counters at 0, every query once, counters read.
    ops.reset_launches()
    res = {}
    query_launches = {}
    for name, fn in queries.items():
        before = ops.launches()
        res[name] = fn()
        query_launches[name] = {k: v - before[k]
                                for k, v in ops.launches().items()}
        check_finite(name, res[name])
    torch.cuda.synchronize()
    launches = ops.launches()
    print(f"main-path launches: {launches}")
    for k, m in MIN_LAUNCHES.items():
        check(launches[k] >= m, f"{k} launched {launches[k]} < {m} times")
    report["launches"] = launches

    for name in ("q1/aggregate", "q3/aggregate", "q6/aggregate",
                 "q18/aggregate", "q20/aggregate", "q6/aggregate_exact",
                 "q18/aggregate_exact"):
        check(bit_equal(res[name], queries[name]()),
              f"{name}: rerun is not bit-equal")
    print("bit-equal reruns: ok")
    cross_checks(res)

    times = {}
    for name, fn in queries.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        print(f"SF1 {name}: {times[name]:.1f} ms")
    report["query_ms"] = times
    report["profiles"] = {name: profile_query(name, queries[name])
                          for name in ("q1/aggregate", "q3/aggregate",
                                       "q6/aggregate_exact",
                                       "q18/aggregate_exact")}
    # what phase 8's mesh runs and phase 9's plans must equal
    mesh_ref = {name: digest(res[name]) for name in
                sorted((set(MESH_ALL) - set(MESH_PHASE3))
                       | set(SERVING_PHASE3.values()))}
    del res, queries
    torch.cuda.empty_cache()

    report["streamed_sf1"] = streamed_phase(db, out_dir)
    torch.cuda.empty_cache()

    report["value_layer"] = value_path(db, p9)
    del db, p9
    torch.cuda.empty_cache()

    small = dict(n_orders=2000, seed=0)
    cpu = {k: f() for k, f in run_queries(tpch.generate(**small,
                                                        device="cpu"),
                                          sf1=False).items()}
    gpu = {k: f() for k, f in run_queries(tpch.generate(**small,
                                                        device="cuda"),
                                          sf1=False).items()}
    small_cmp = compare_small(cpu, gpu)
    report["small_cpu_vs_card"] = small_cmp
    print("small size (n_orders=2000) CPU plain vs card kernels: max err / "
          f"scale {small_cmp['max_rel']:.3e} (tolerance 2e-4; cumulant "
          "orders 1-4 scaled by their coefficient sums); cumulant orders "
          f"5-8: {small_cmp['cumulant_orders_above_4_rel']:.3e} (reported)")
    small_values = compare_small(value_small("cpu"), value_small("cuda"))
    report["small_values_cpu_vs_card"] = small_values
    print("small size (n_orders=2000) value layer, CPU plain vs card "
          f"kernels: max err / scale {small_values['max_rel']:.3e} "
          "(tolerance 2e-4; values, validity and group ids equal)")

    report["sf5"] = sf5_phase()
    torch.cuda.empty_cache()

    report["mesh"] = mesh_phase(
        out_dir, mesh_ref, query_launches,
        serving=lambda db, mesh: serving_phases(db, mesh, mesh_ref))
    report["serving"] = report["mesh"].pop("serving")
    report["vmap"] = report["serving"].pop("vmap")
    report["sweep_report"] = report["serving"].pop("sweep_report")
    torch.cuda.empty_cache()

    report["lm"] = lm_phase(card)
    torch.cuda.empty_cache()

    report["train"] = train_phase(card, out_dir)
    torch.cuda.empty_cache()

    report["mesh_train"] = mesh_train_phase(card, out_dir)
    torch.cuda.empty_cache()

    report["dryrun"] = dryrun_phase(card, dryruns, report["mesh_train"])
    torch.cuda.empty_cache()

    report["pgf_mesh"] = pgf_mesh_phase(card, dryruns, out_dir)
    report["sweep_mesh"] = report["pgf_mesh"].pop("sweep_mesh")

    # launches: the runs of the TPC-H path, the value-layer path, the
    # streamed path, the mesh path (every rank), the serving path, the
    # training path, the LM mesh (every rank), phase 13's card cells,
    # phase 14's pgf runs (every rank), phase 15's batched sweeps and
    # phase 16's (the SF1 Q3 family's, and every rank's of (c)).
    value_launches = report["value_layer"]["launches"]
    stream_launches = report["streamed_sf1"]["launches"]
    mesh_launches = report["mesh"]["launches"]
    serving_launches = report["serving"]["launches"]
    train_launches = report["train"]["launches"]
    lm_mesh_launches = report["mesh_train"]["launches"]
    pgf_mesh_launches = report["pgf_mesh"]["launches"]
    vmap_launches = report["vmap"]["launches"]
    sweep16_launches = {
        k: report["sweep_report"]["launches"][k]
        + report["sweep_mesh"]["launches"].get(k, 0) for k in launches}
    cell_launches = {k: sum(c["launches"].get(k, 0) for c in
                            report["dryrun"]["b"].values())
                     for k in launches}
    kernels = []
    for name in ("logcf", "group_logcf", "cumulant_sums",
                 "group_cumulant_sums", "polymul"):
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name],
                            launches=launches[name] + value_launches[name]
                            + stream_launches[name] + mesh_launches[name]
                            + serving_launches[name] + train_launches[name]
                            + lm_mesh_launches[name] + cell_launches[name]
                            + pgf_mesh_launches.get(name, 0)
                            + vmap_launches[name] + sweep16_launches[name],
                            **r))
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
