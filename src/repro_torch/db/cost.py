"""Cost model for the physical planner (:mod:`repro_torch.db.physical`).

``lower_plan`` is a two-phase optimizer: it ENUMERATES candidate physical
pipelines per logical node (GatherJoin vs ShuffleJoin vs CoPartitionedJoin
for an FKJoin; PartialAgg vs Repartition/PartitionedAgg for an
aggregation) and COSTS each candidate here, picking the cheapest.  This
module is the whole model: every number the planner compares lives in one
place and is unit-tested directly (tests/test_cost.py), instead of being
implied by ``if rows > budget`` branches scattered through the lowering.

A :class:`Cost` is three device-level quantities:

    bytes_moved   collective payload bytes per device — all-gather /
                  all_to_all / psum traffic, scaled by ``(n-1)/n`` (a
                  1-shard collective moves nothing)
    peak_rows     peak resident column elements per device added by the
                  candidate (replicated build sides, exchange buffers,
                  live aggregation state)
    flops         per-tuple UDA state-update work (the §V kernels:
                  elements touched per tuple per aggregate)

and :meth:`CostModel.total` collapses them to comparable units: bytes,
plus ``peak_weight`` bytes charged per resident byte (memory pressure is
a real cost but cheaper than moving the byte), plus ``flop_weight`` bytes
per flop (the PGF pipeline is interconnect-bound at scale — §VII — so
compute is discounted).

Budget knobs survive ONLY as cost-model overrides: ``gather_budget``
(the PR-4 ``join_gather_budget``) adds an infinite-cost penalty to
GatherJoin above the budget and to the hash-exchange strategies at or
under it, so the gather/exchange flip point is exactly the PR-4 golden
behaviour; ``copartition`` and ``agg_shuffle_budget`` gate the fused
candidates the same way (see :func:`repro_torch.db.physical.lower_plan`).
With the overrides disabled (``gather_budget=None``) the pure physical
estimates decide.
"""
from __future__ import annotations

import dataclasses

INF = float("inf")

#: orders carried by the SumCumulants UDA state (core/uda.py default).
CUMULANT_ORDERS = 8


@dataclasses.dataclass(frozen=True)
class Cost:
    """Device-level cost of one physical-plan candidate (see module doc)."""
    bytes_moved: float = 0.0
    peak_rows: float = 0.0
    flops: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        # Pipeline stages stream: traffic and work add, residency peaks.
        return Cost(self.bytes_moved + other.bytes_moved,
                    max(self.peak_rows, other.peak_rows),
                    self.flops + other.flops)

    def fmt(self) -> str:
        return (f"bytes={int(self.bytes_moved)}, "
                f"rows={int(self.peak_rows)}, flops={int(self.flops)}")


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Parameters + overrides of the planner's cost model.

    ``gather_budget`` / ``copartition`` / ``agg_shuffle_budget`` are the
    budget-knob OVERRIDES (None / "auto" = decide purely from estimates);
    the remaining fields are the physical constants the estimates use.
    """
    n_shards: int = 1
    elem_bytes: int = 8           # f64 columns (enable_x64 test config)
    peak_weight: float = 0.05     # bytes charged per resident byte
    flop_weight: float = 0.02     # bytes charged per state-update flop
    gather_budget: int | None = 1 << 20
    copartition: object = "auto"  # True force / False never / "auto" cost
    agg_shuffle_budget: int | None = None
    shuffle_slack: float = 4.0
    #: out-of-core override: max resident rows per device for one scan.
    #: A Scan whose per-shard rows exceed it lowers to StreamedScan and
    #: its table stays host-side (None = everything device-resident).
    device_row_budget: int | None = None
    #: model-axis size: exact-CF frequency windows split across it, so
    #: per-device phase flops drop by this factor (state elements do not
    #: — the slab gather reassembles full-width replicas).
    model_shards: int = 1

    def total(self, c: Cost) -> float:
        """Collapse a Cost to one comparable number (bytes-equivalent)."""
        return (c.bytes_moved + self.peak_weight * self.elem_bytes
                * c.peak_rows + self.flop_weight * c.flops)

    @property
    def xfer(self) -> float:
        """Fraction of a collective payload that crosses the interconnect
        per device: (n-1)/n — one shard moves nothing."""
        return (self.n_shards - 1) / self.n_shards


# ------------------------------------------------------------ join costs
def gather_join(m: CostModel, build_rows: int, n_right_cols: int) -> Cost:
    """Broadcast join: all-gather the build side's (key, p, valid) +
    carried columns onto every device, probe locally."""
    w = n_right_cols + 3
    return Cost(bytes_moved=build_rows * w * m.elem_bytes * m.xfer,
                peak_rows=build_rows * w)


def shuffle_join(m: CostModel, build_bucket: int, probe_bucket: int,
                 n_right_cols: int) -> Cost:
    """Hash-partitioned join WITH the response round-trip home: build
    exchange (key, p + carried cols), probe-key requests, and the
    (p, hit + carried cols) responses each cross the all_to_all once.
    Buckets are per-(sender, owner) static capacities, so per-device
    buffer rows are ``n_shards * bucket``."""
    n = m.n_shards
    wb = n_right_cols + 2                 # build: key, p, cols
    wr = n_right_cols + 2                 # response: p, hit, cols
    bytes_moved = (n * build_bucket * wb + n * probe_bucket * (1 + wr)) \
        * m.elem_bytes * m.xfer
    peak = n * build_bucket * wb + n * probe_bucket * (1 + wr)
    return Cost(bytes_moved=bytes_moved, peak_rows=peak)


def copartitioned_join(m: CostModel, build_bucket: int, probe_bucket: int,
                       n_right_keep: int, n_carry: int) -> Cost:
    """Hash-partitioned join WITHOUT the trip home: probe rows ship their
    probability, canonical-chunk id and the columns the downstream
    aggregation needs, and matched rows STAY at their ``key % n_shards``
    owner.  No response exchange; the build exchange only carries the
    columns the aggregation reads (``n_right_keep <= n_right_cols``)."""
    n = m.n_shards
    wb = n_right_keep + 2                 # build: key, p, kept cols
    wp = n_carry + 3                      # probe: key, p, chunk, carries
    bytes_moved = (n * build_bucket * wb + n * probe_bucket * wp) \
        * m.elem_bytes * m.xfer
    peak = n * build_bucket * wb + n * probe_bucket * (wp + n_right_keep)
    return Cost(bytes_moved=bytes_moved, peak_rows=peak)


# ----------------------------------------------------- aggregation costs
def agg_state_elems(specs, max_groups: int, kappa: int, num_freq: int,
                    model_shards: int = 1):
    """State footprint of one aggregation pass: ``(additive_elems,
    fold_elems, row_flops)``.

    ``additive_elems`` counts psum-able state elements (confidence +
    normal / cumulant / exact-CF states), ``fold_elems`` the gather-fold
    (MinMax) states, ``row_flops`` the per-tuple update work summed over
    the pass's UDAs — the units :class:`Cost` carries.  ``model_shards``
    divides the exact-CF per-row phase flops: the planner splits each
    frequency slab into per-model-rank windows, so a device only touches
    num_freq / model_shards frequencies per tuple (state elements stay
    full-width — the slab gather reassembles replicas).
    """
    add = max_groups                      # AtLeastOne rides every pass
    fold = 0
    flops = 1.0
    for _name, _value, agg, method in specs:
        if agg in ("MIN", "MAX"):
            fold += max_groups * (2 * kappa + 2)
            flops += kappa
        elif method == "exact":
            add += max_groups * 2 * num_freq
            flops += num_freq / max(1, model_shards)
        elif method == "cumulants":
            add += max_groups * CUMULANT_ORDERS
            flops += 2 * CUMULANT_ORDERS
        else:                             # normal / COUNT
            add += max_groups * 2
            flops += 2
    return add, fold, flops


def partial_agg(m: CostModel, local_rows: int, chunks: int, add_elems: int,
                fold_elems: int, row_flops: float) -> Cost:
    """RowBlocked aggregation: per-shard per-canonical-chunk Accumulate,
    then ONE all-gather of ALL ``chunks`` chunk states (additive and
    fold states alike ride it) and the replicated canonical fold."""
    state = add_elems + fold_elems
    return Cost(bytes_moved=chunks * state * m.elem_bytes * m.xfer,
                peak_rows=chunks * state,
                flops=local_rows * row_flops)


def partitioned_agg(m: CostModel, buffer_rows: int, chunks: int,
                    add_elems: int, fold_elems: int,
                    row_flops: float) -> Cost:
    """HashPartitioned aggregation: every group lives wholly at its owner,
    so each owner folds its canonical-chunk states LOCALLY and the merge
    is ONE psum of the folded additive state (2x payload: reduce-scatter
    + all-gather) plus one ``n_shards``-way gather-fold for MinMax states
    — chunk-count-independent traffic, vs the ``chunks * state`` gather
    of :func:`partial_agg`.  Accumulation runs over the static exchange
    buffer (``n_shards * bucket`` rows, empty slots masked) in ONE
    compound (chunk, group) pass, so the live state is ``chunks`` times
    the per-group footprint — additive and MinMax alike."""
    bytes_moved = (2 * add_elems + m.n_shards * fold_elems) \
        * m.elem_bytes * m.xfer
    return Cost(bytes_moved=bytes_moved,
                peak_rows=chunks * (add_elems + fold_elems) + buffer_rows,
                flops=buffer_rows * row_flops)


# ----------------------------------------------------- out-of-core scans
@dataclasses.dataclass(frozen=True)
class WaveSchedule:
    """Static wave plan of one :class:`~repro_torch.db.physical.StreamedScan`.

    The streamed executor ships the host table to the mesh as ``n_waves``
    uniform slabs of ``chunks_per_wave`` canonical-chunk slots
    (``wave_rows`` rows globally, ``wave_rows / n_shards`` per device);
    the host table is padded to ``padded_capacity`` rows so EVERY wave —
    ragged tail included — has the same shape, which keeps one compiled
    wave function and makes per-chunk UDA states independent of the wave
    size (the bit-identical-streaming contract).  Frozen + hashable so it
    rides on the physical node and keys the executor's jit cache.
    """
    chunk_rows: int          # csz: rows per canonical chunk slot
    local_chunks_per_wave: int
    n_waves: int
    n_shards: int

    @property
    def chunks_per_wave(self) -> int:
        return self.local_chunks_per_wave * self.n_shards

    @property
    def wave_rows(self) -> int:
        return self.chunks_per_wave * self.chunk_rows

    @property
    def padded_capacity(self) -> int:
        return self.n_waves * self.wave_rows


def wave_schedule(chunk_rows: int, chunks: int, shards: int,
                  budget: int | None,
                  override_chunks: int | None = None,
                  width: float = 1.0) -> WaveSchedule:
    """Pick the wave size for a streamed scan whose canonical chunk grid
    is ``chunks`` slots of ``chunk_rows`` rows.

    Double buffering holds 2 slabs per device, so the largest wave that
    fits the per-device row ``budget`` has ``budget // (2 * chunk_rows)``
    local chunk slots; clamped to [1, local_slots].  ``width`` is the
    pruned-slab relative row width ``(pruned_cols + 2) / (full_cols + 2)``
    — ``device_row_budget`` is calibrated against FULL rows, so a
    column-pruned slab of width 0.5 fits twice the rows in the same
    bytes and the wave widens accordingly (fewer waves, fewer
    transfers).  ``override_chunks`` (global chunk slots per wave,
    rounded up to the shard count) bypasses both — the test hook for
    pinning {1 chunk, ragged tail, whole-table} schedules."""
    csz = chunk_rows
    local_slots = -(-chunks // shards)            # chunk slots per shard
    if override_chunks is not None:
        local_cpw = max(1, -(-override_chunks // shards))
    else:
        eff = (budget or 0) if width >= 1.0 else int((budget or 0) / width)
        local_cpw = max(1, eff // (2 * csz))
    local_cpw = min(local_cpw, local_slots)
    n_waves = -(-local_slots // local_cpw)
    return WaveSchedule(chunk_rows=csz, local_chunks_per_wave=local_cpw,
                        n_waves=n_waves, n_shards=shards)


# ------------------------------------------------- batched parameter axis
def batched(c: Cost, n_points: int) -> Cost:
    """Cost of running one compiled plan vmapped over ``n_points``
    parameter points: every relational intermediate (and its traffic and
    work) materialises once PER POINT — the batch axis multiplies all
    three components.  What batching saves is the per-point TRACE +
    COMPILE, not the device work; the serving layer uses this to bound
    how many points share one launch (:func:`sweep_chunk_points`)."""
    return Cost(bytes_moved=c.bytes_moved * n_points,
                peak_rows=c.peak_rows * n_points,
                flops=c.flops * n_points)


def sweep_chunk_points(per_point_rows: float, budget_rows: int | None,
                       n_points: int) -> int:
    """Largest per-launch point count of an ``n_points`` parameter sweep
    whose batched peak rows (``per_point_rows`` each, the batch axis
    multiplies residency — see :func:`batched`) fit ``budget_rows``;
    floored at 1 so progress is always possible, and the whole sweep
    when no budget is set."""
    if not budget_rows or per_point_rows <= 0:
        return max(1, n_points)
    return max(1, min(n_points, int(budget_rows // per_point_rows)))


# ----------------------------------------------------- retry escalation
def escalated_slack(slack: float, n_shards: int) -> float:
    """The next ``shuffle_slack`` after an overflow: doubled, capped at
    ``n_shards`` — where :func:`repro_torch.db.physical.bucket_capacity` pins
    every bucket at the sender's full local rows and overflow becomes
    impossible, so the ladder terminates in O(log n_shards) doublings
    even without a demand observation."""
    return min(float(n_shards), max(2.0 * slack, 1.0))


def halved_wave_chunks(sched: WaveSchedule) -> int:
    """The next ``stream_wave_chunks`` (global chunk slots per wave)
    after a persistent transfer fault: half the wave, floored at one
    chunk slot per shard — the smallest slab the streamed executor can
    ship, so the ladder terminates."""
    return max(1, sched.local_chunks_per_wave // 2) * sched.n_shards


def streamed_scan(m: CostModel, rows: int, wave_rows: int,
                  n_cols: int) -> Cost:
    """Out-of-core scan: every row crosses host→device once per streamed
    pass (column + p + valid payload, no (n-1)/n discount — it is a
    transfer, not a collective; the executor's group-discovery pass
    re-streams, the model charges the accumulate pass), and residency is
    two double-buffered slabs per device instead of the table.
    ``n_cols`` is the PRUNED column count when the lowering computed a
    ``StreamedScan.columns`` demand set — only demanded columns ride the
    wave slabs."""
    w = n_cols + 2
    return Cost(bytes_moved=rows * w * m.elem_bytes,
                peak_rows=2 * (wave_rows // max(1, m.n_shards)) * w)


def repartition(m: CostModel, bucket: int, n_carry: int) -> Cost:
    """Hash-exchange of aggregation inputs to their group-key owner:
    (key, p, chunk) + the value/carry columns the pass reads."""
    n = m.n_shards
    w = n_carry + 3
    return Cost(bytes_moved=n * bucket * w * m.elem_bytes * m.xfer,
                peak_rows=n * bucket * w)
