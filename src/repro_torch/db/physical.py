"""Physical plan IR: explicit, cost-chosen execution strategies for the
sharded relational frontend — the port's copy of ``repro.db.physical``,
which is free of JAX but imported through a package that is not.

The port's executor (``repro_torch.db.plans``) runs every strategy
lowered here, the sharded and exchange ones over ``torch.distributed``
ranks (``repro_torch.db.distributed``).  One difference from the
reference: ``bucket_floor`` also lifts histogram-sized buckets.

``repro_torch.db.plans.compile_plan`` splits compilation into two stages:

    logical plan (plans.Node DAG)
        --lower_plan-->  physical plan (this module's PhysNode DAG)
        --plans executor-->  one jit-able tables -> result function

``lower_plan`` is itself a two-phase optimizer:

    1. ENUMERATE — per logical node, build every legal physical candidate
       (GatherJoin / ShuffleJoin / CoPartitionedJoin for an FKJoin;
       PartialAgg on RowBlocked input vs Repartition + PartitionedAgg for
       an aggregation, plus the fused CoPartitionedJoin + PartitionedAgg
       pipeline when a GROUP BY keys on the join key);
    2. COST — price each candidate with the explicit, unit-tested model
       in :mod:`repro_torch.db.cost` (bytes moved per collective, peak rows per
       device, UDA flops) and pick the cheapest.

The old budget knobs survive ONLY as cost-model overrides (an
infinite-cost penalty on the forbidden side of the flip point), so
``join_gather_budget`` reproduces the PR-4 golden flip behaviour exactly
while everything inside the allowed region is decided by the estimates.
Chosen nodes carry their modeled ``cost``; :func:`explain` prints it.

Partitioning properties
-----------------------
Every physical node carries ``part``, the placement of its output rows on
the mesh's data shards — one of three points of a small lattice:

    Replicated              every shard holds the identical full table.
                            Top of the lattice: valid input for every
                            operator, and the only property with no
                            per-device memory savings.
    RowBlocked              contiguous equal row blocks, shard s holding
                            rows [s*B, (s+1)*B) of the canonical
                            (chunk-grid padded) global row order.  The
                            O(rows/shards) workhorse; shard-major
                            concatenation IS the global row order.
    HashPartitioned(key)    row lives on shard ``key % n_shards``.  The
                            co-location property: two relations hashed on
                            their join keys join shard-locally, and a
                            GROUP BY on the hash key aggregates
                            shard-locally (every group wholly at one
                            owner).

Exchange operators move between the points:

    all-gather   RowBlocked       -> Replicated      (dist.gather_table)
    shuffle      RowBlocked       -> HashPartitioned (dist.shuffle_by_key;
                                                      ShuffleJoin's build
                                                      leg, Repartition,
                                                      CoPartitionedJoin)
    shuffle home HashPartitioned  -> RowBlocked      (responses routed back
                                                      through the same
                                                      static send buckets
                                                      — ONLY ShuffleJoin
                                                      pays this leg)

Residency and the wave-schedule lattice
---------------------------------------
Partitioning says WHERE on the mesh a row lives; residency says WHEN it
is on the mesh at all.  Orthogonal to the placement lattice, every base
scan sits at one of three points of a residency lattice, ordered by
per-device footprint:

    Resident       the whole (padded) table is on the mesh for the whole
                   query — ShardScan; footprint rows/shards.  Top of the
                   lattice: every strategy below it is legal.
    Streamed       the table lives HOST-side and visits the mesh as
                   ``n_waves`` uniform slabs of ``chunks_per_wave``
                   canonical-chunk slots — StreamedScan; footprint
                   2 slabs/device (double buffer) + the aggregation
                   state, INDEPENDENT of the table size.
    (Absent)       bottom: a table no operator reads — never planned.

``cost.wave_schedule`` picks the point and the wave size from the
``device_row_budget`` override: a scan whose per-shard rows exceed the
budget streams, with the largest wave whose TWO slabs fit the budget
(``local_chunks_per_wave = budget // (2 * chunk_rows)``, clamped to
[1, chunk slots per shard]).  Waves are aligned to the canonical chunk
grid, so each wave's slab is a run of whole chunk slots and the host
table is padded until every wave has the same shape — one compiled wave
function, and per-chunk UDA states whose values cannot depend on the
wave size.  That is the streaming exactness argument in one line: the
canonical-chunk contract already computes each chunk's state from that
chunk's rows alone and merges chunk states in ONE fixed tree
(``uda.tree_fold``), so slicing the chunk sequence into waves changes
*when* a chunk state is produced, never *what* is folded — results are
bit-identical to resident execution for ANY wave size.

Streaming restricts the strategy menu to the candidates whose per-wave
semantics are the resident ones verbatim: joins below a streamed scan
lower to GatherJoin (the resident build side is replicated once; every
wave probes it locally) and aggregations to PartialAgg (per-wave,
per-chunk Accumulate; the executor gathers each wave's chunk states and
folds ONCE after the last wave).  A build side over the budget raises —
only the probe side may stream.

Node zoo (the executor in plans.py interprets these inside shard_map):

    ShardScan(name)                  base table; RowBlocked on a mesh,
                                     Replicated single-device
    StreamedScan(name, schedule)     out-of-core base table: host-side
                                     rows, shipped as schedule.n_waves
                                     chunk-aligned slabs, double-buffered
                                     (device_put of wave k+1 overlaps the
                                     accumulate of wave k); each slab is
                                     RowBlocked on the mesh
    PhysSelect / PhysMap             elementwise on the local block;
                                     preserve the child's partitioning
    GatherJoin(l, r, ...)            broadcast FK join: build side
                                     all-gathered to Replicated (a no-op
                                     when it already is), probe local
    ShuffleJoin(l, r, ...)           hash-partitioned FK join: build rows
                                     shuffled to HashPartitioned(right_key)
                                     owners, probe keys shuffled to the
                                     same owners as requests, matched
                                     shard-locally, responses shuffled home
                                     — output stays RowBlocked and
                                     bit-identical to GatherJoin, with
                                     O(build/shards) peak build rows/device
    CoPartitionedJoin(l, r, ...)     the fused shuffle -> aggregate
                                     pipeline's join half: same build and
                                     probe exchanges, but probe rows carry
                                     their probability, canonical-chunk id
                                     and the aggregation's value columns,
                                     and matched rows STAY at their
                                     ``key % n_shards`` owner (NO
                                     shuffle-home round-trip); output is
                                     HashPartitioned(left_key)
    Repartition(child, key, ...)     hash-exchange of aggregation inputs
                                     to their group-key owner (the no-join
                                     path into PartitionedAgg)
    PartialAgg(child, keys, specs)   per-shard, per-canonical-chunk UDA
                                     Accumulate over the RowBlocked local
                                     tuples; output = partitioned partial
                                     states, merged by ONE all-gather of
                                     all chunk states + the canonical fold
    PartitionedAgg(child, ...)       UDA Accumulate over a HashPartitioned
                                     buffer: group-id assignment runs
                                     owner-locally, every canonical chunk
                                     state is computed at the owner (one
                                     compound (chunk, group) pass), each
                                     owner finishes the canonical fold
                                     LOCALLY, and the merge is ONE psum of
                                     the folded additive states (groups
                                     are owner-disjoint, so the psum adds
                                     exact zeros — bit-identical to the
                                     RowBlocked fold) + an n-way
                                     gather-fold for MinMax states
    MergeAgg(partial, kind)          the merge + replicated Finalize;
                                     kind selects the epilogue (groupagg
                                     dict / project Table / reweight
                                     Table)

Worked example — TPC-H Q3 (revenue per order, GROUP BY l_orderkey) on a
4-shard mesh with the orders build side over the gather budget::

    MergeAgg[groupagg] :: Replicated
      PartitionedAgg(keys=[l_orderkey], ...) :: HashPartitioned(l_orderkey)
        CoPartitionedJoin(l_orderkey=o_orderkey, carry=[l_extendedprice])
            :: HashPartitioned(l_orderkey)
          Select :: RowBlocked            (lineitem, shipdate filter)
            ShardScan(lineitem) :: RowBlocked
          ShuffleJoin(o_custkey=c_custkey, ...) :: RowBlocked
            ...                           (orders |x| customer)

    lineitem rows hash to shard ``l_orderkey % 4`` carrying
    (p, chunk, l_extendedprice); orders rows hash to the same owners; the
    match and the whole GROUP BY run at the owner; the only remaining
    collective is one psum of the folded (G, 2) normal state.  The
    ShuffleJoin alternative pays the same two exchanges PLUS the response
    round-trip home and an all-gather of all canonical chunk states —
    ``lower_plan`` picks the fused pipeline because
    :func:`repro_torch.db.cost.copartitioned_join` +
    :func:`repro_torch.db.cost.partitioned_agg` price strictly fewer bytes.

Worked example — streamed TPC-H Q1 (SUM(l_quantity) GROUP BY returnflag,
linestatus) on a 2-shard mesh, lineitem at 64k rows against
``device_row_budget=8192``::

    MergeAgg[groupagg] :: Replicated
      PartialAgg(keys=[l_returnflag, l_linestatus], ...) :: RowBlocked
        Select :: RowBlocked              (shipdate filter, per wave)
          StreamedScan(lineitem, rows=65536, waves=4x2chunks@8192rows)
              :: RowBlocked cost{bytes=1572864, rows=49152, flops=0}

    65536 rows / 8 canonical chunks = 8192-row chunk slots; the budget
    holds 2 slabs of 8192 rows per device, so each wave carries ONE
    chunk slot per shard (2 globally) and the schedule needs 4 waves.
    The executor runs two passes over the host table: wave pass A
    discovers the global group-code table (per-wave ``unique`` codes,
    merged incrementally — exact under hierarchical merging), then wave
    pass B re-streams the slabs, accumulates per-chunk UDA states with
    the final group ids, all-gathers each wave's chunk states, and after
    wave 4 folds all 8 canonical chunk states in the same
    ``uda.tree_fold`` tree the resident compile uses — bit-identical
    output, with peak device residency 2 slabs + the (G, 2) sum state
    instead of the 64k-row table.  While wave k's accumulate runs on
    device, wave k+1's slab is already crossing host→device (async
    dispatch double-buffering); ``explain`` prints the modeled one-way
    transfer bytes and the 2-slab peak rows/device on the StreamedScan.

Bit-reproducibility of the fused pipeline: each probe row ships its
canonical-chunk id; the owner accumulates one compound (chunk, group)
scatter pass whose received rows arrive in (sender, rank) = global row
order, so every (chunk, group) slot folds the SAME tuples in the SAME
order as the RowBlocked chunk pass; all chunks of a group live at its
owner, so the owner's local canonical ``tree_fold`` equals the global
one for its groups and the final psum adds exact zeros elsewhere.  The
contract requires the group-key cardinality to fit ``max_groups`` (the
overflow fill bucket is flagged invalid in every path but its garbage
value is only deterministic per-layout).

ShuffleJoin / CoPartitionedJoin / Repartition bucket capacities are
static (XLA shapes): each shard sends at most ``*_bucket`` rows to each
owner.  When the exchange key column is CONCRETE at lowering time (eager
compiles), the capacity is sized from the actual ``key % n_shards``
histogram of the base table — ``max`` per (sender, owner) demand, so a
skewed key distribution gets exactly the buckets it needs and overflow is
impossible; traced keys (jit) fall back to ``ceil(local_rows * slack /
n_shards)`` capped at ``local_rows``, where overflow is *accounted*
(dropped rows are counted, the count is psum-shared, and the executor
poisons the output probabilities with NaN — see ``dist.shuffle_fk_join``
for the boolean-consumer caveat; ``slack >= n_shards`` makes overflow
impossible).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import types
from typing import Callable

import numpy as np
import torch

from . import cost as C

#: reserved column carrying each exchanged row's canonical-chunk id
#: through a hash exchange ("\x00" keeps it out of the legal namespace).
CHUNK_COL = "\x00chunk"


# ---------------------------------------------------------------- properties
@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every shard holds the identical full table."""


@dataclasses.dataclass(frozen=True)
class RowBlocked:
    """Contiguous equal row blocks of the canonical global row order."""


@dataclasses.dataclass(frozen=True)
class HashPartitioned:
    """Row lives on shard ``key % n_shards`` (key = this column)."""
    key: str


# ---------------------------------------------------------------------- IR
class PhysNode:
    pass


@dataclasses.dataclass(frozen=True)
class ShardScan(PhysNode):
    name: str
    part: object
    rows: int              # global (padded) capacity of the base table


@dataclasses.dataclass(frozen=True)
class StreamedScan(PhysNode):
    """Out-of-core base table: rows live HOST-side and reach the mesh as
    ``schedule.n_waves`` canonical-chunk-aligned slabs (see the wave
    lattice in the module docstring).  ``part`` is the placement of each
    wave's slab (RowBlocked on a mesh); ``rows`` is the global chunk-grid
    capacity of the host table; ``cost`` prices the one-way host→device
    bytes and the 2-slab double-buffered residency.  ``columns`` is the
    static required-column demand set of the plan above the scan
    (:func:`required_scan_columns`): wave slabs ship ONLY these columns
    (plus prob/valid); ``None`` means the analysis could not bound the
    reads and every column streams."""
    name: str
    part: object
    rows: int
    schedule: C.WaveSchedule
    cost: object = None
    columns: tuple | None = None


@dataclasses.dataclass(frozen=True)
class PhysSelect(PhysNode):
    child: PhysNode
    pred: Callable
    part: object


@dataclasses.dataclass(frozen=True)
class PhysMap(PhysNode):
    child: PhysNode
    name: str
    fn: Callable
    part: object


@dataclasses.dataclass(frozen=True)
class GatherJoin(PhysNode):
    left: PhysNode
    right: PhysNode
    left_key: str
    right_key: str
    right_cols: tuple
    build_rows: int        # global capacity of the build side
    part: object           # = left.part
    cost: object = None    # modeled repro_torch.db.cost.Cost of the choice


@dataclasses.dataclass(frozen=True)
class ShuffleJoin(PhysNode):
    left: PhysNode
    right: PhysNode
    left_key: str
    right_key: str
    right_cols: tuple
    build_rows: int
    exchange: HashPartitioned   # intermediate placement of both sides
    build_bucket: int           # static per-(sender, owner) bucket rows
    probe_bucket: int
    part: object                # = left.part (responses shuffled home)
    cost: object = None


@dataclasses.dataclass(frozen=True)
class CoPartitionedJoin(PhysNode):
    """ShuffleJoin without the trip home: matched rows stay at their
    ``left_key % n_shards`` owner, probe rows carry (p, chunk id, carry
    columns), and only the build columns the consumer reads are fetched
    (``right_cols`` here is already pruned to the aggregation's needs)."""
    left: PhysNode
    right: PhysNode
    left_key: str
    right_key: str
    right_cols: tuple           # build columns the aggregation reads
    carry_cols: tuple           # probe columns shipped with the requests
    build_rows: int
    build_bucket: int
    probe_bucket: int
    part: HashPartitioned       # = HashPartitioned(left_key)
    cost: object = None


@dataclasses.dataclass(frozen=True)
class Repartition(PhysNode):
    """Hash-exchange aggregation inputs to their group-key owner."""
    child: PhysNode
    key: str
    carry_cols: tuple           # value/threshold columns the pass reads
    bucket: int
    part: HashPartitioned       # = HashPartitioned(key)
    cost: object = None


@dataclasses.dataclass(frozen=True)
class PartialAgg(PhysNode):
    child: PhysNode
    keys: tuple
    specs: tuple           # ((name, value_col, agg, method), ...)
    max_groups: int
    kappa: int
    num_freq: int
    part: object           # = child.part (states partial per shard)
    cost: object = None


@dataclasses.dataclass(frozen=True)
class PartitionedAgg(PhysNode):
    """PartialAgg's HashPartitioned twin: owner-local group ids, one
    compound (chunk, group) accumulate, owner-local canonical fold, ONE
    psum merge (see module docstring)."""
    child: PhysNode
    keys: tuple
    specs: tuple
    max_groups: int
    kappa: int
    num_freq: int
    part: HashPartitioned  # = child.part
    cost: object = None


@dataclasses.dataclass(frozen=True)
class MergeAgg(PhysNode):
    child: PhysNode        # PartialAgg | PartitionedAgg
    kind: str              # groupagg | project | reweight
    threshold_col: str = ""
    threshold: float | None = None
    carry_cols: tuple = ()
    part: object = Replicated()


_RESERVED_OUT_KEYS = frozenset({"valid", "keys", "confidence"})


# ------------------------------------------------------ structural identity
def structural_key(obj) -> tuple:
    """A stable, hashable fingerprint of a plan object's STRUCTURE.

    Frozen dataclasses (logical ``plans.Node``s, the PhysNode IR, cost
    models, wave schedules) fingerprint as (class, field fingerprints);
    plain Python functions — the lambdas a Select/Map carries — by their
    compiled bytecode, constants and captured closure CELL VALUES, so two
    separately constructed but textually identical plans produce EQUAL
    keys (the property identity-keyed caches miss on), while a lambda
    capturing a different constant produces a different key.  Containers
    recurse; small concrete arrays fingerprint by dtype/shape/bytes.

    Anything unrecognised, and any tensor, falls back to ``id()`` — an
    identity key can only cause a cache MISS, never a false hit, so long
    as the keyed object stays alive (the serving layer's plan cache keys
    on this fingerprint and pins each entry's plan).
    """
    if obj is None or isinstance(obj, (bool, int, float, complex, str,
                                       bytes)):
        return ("a", type(obj).__name__, obj)
    if isinstance(obj, (tuple, list)):
        return ("t", tuple(structural_key(x) for x in obj))
    if isinstance(obj, dict):
        return ("d", tuple(sorted((str(k), structural_key(v))
                                  for k, v in obj.items())))
    if isinstance(obj, (set, frozenset)):
        return ("s", tuple(sorted(map(structural_key, obj), key=repr)))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return ("dc", f"{cls.__module__}.{cls.__qualname__}",
                tuple((f.name, structural_key(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, functools.partial):
        return ("p", structural_key(obj.func), structural_key(obj.args),
                structural_key(obj.keywords))
    if isinstance(obj, types.MethodType):
        return ("m", structural_key(obj.__func__),
                structural_key(obj.__self__))
    if isinstance(obj, types.CodeType):
        return ("c", obj.co_code, obj.co_names, obj.co_varnames,
                obj.co_argcount, structural_key(obj.co_consts))
    if isinstance(obj, types.FunctionType):
        cells = ()
        if obj.__closure__:
            vals = []
            for cell in obj.__closure__:
                try:
                    vals.append(structural_key(cell.cell_contents))
                except ValueError:          # empty cell
                    vals.append(("empty",))
            cells = tuple(vals)
        return ("f", structural_key(obj.__code__), cells,
                structural_key(obj.__defaults__))
    if isinstance(obj, (torch.device, torch.dtype)):
        return ("torch", str(obj))
    if isinstance(obj, torch.Tensor):
        # Mutable and possibly on the card: keyed by identity, never by
        # content (a miss where the reference would hit on equal values).
        return ("id", "Tensor", id(obj))
    try:
        arr = np.asarray(obj)
        if arr.dtype != object and arr.size <= (1 << 16):
            return ("arr", str(arr.dtype), arr.shape, arr.tobytes())
    except Exception:
        pass
    return ("id", type(obj).__qualname__, id(obj))


# ----------------------------------------------- required-column analysis
class _SpyColumns(dict):
    """Recording stand-in for ``Table.columns``: every name looked up (or
    even probed for membership) is charged to the demand set."""

    def __init__(self, seen):
        super().__init__()
        self._seen = seen

    def __getitem__(self, name):
        self._seen.add(name)
        return np.zeros((1,), np.float64)

    def __contains__(self, name):
        self._seen.add(name)
        return True

    def get(self, name, default=None):
        self._seen.add(name)
        return np.zeros((1,), np.float64)


class _ColumnSpy:
    """One-row numpy stand-in Table fed to a Select predicate / Map column
    function to RECORD which columns it reads.  Mirrors the read-only
    Table surface predicates use (``t["col"]``, ``t.columns``,
    ``t.prob`` / ``t.valid`` / ``t.masked_prob()``); anything it cannot
    stand in for raises out to the analyser, which then gives up on
    pruning (ship every column) rather than under-approximate."""

    def __init__(self):
        self.seen: set = set()
        self.columns = _SpyColumns(self.seen)
        self.prob = np.full((1,), 0.5, np.float64)
        self.valid = np.ones((1,), bool)
        self.part = None
        self.capacity = 1

    def __getitem__(self, name):
        return self.columns[name]

    def masked_prob(self):
        return np.where(self.valid, self.prob, 0.0)


def _callable_columns(fn) -> frozenset | None:
    """The column names a predicate / column function reads, discovered
    by EXECUTING it against a recording :class:`_ColumnSpy`; ``None``
    when the callable cannot be analysed (data-dependent control flow,
    exotic Table use) — the caller must then ship every column.  Over-
    approximation (a name probed but never used) only costs bytes;
    under-approximation would be a correctness bug, hence the blanket
    except."""
    from . import plans as L
    spy = _ColumnSpy()
    try:
        if isinstance(fn, L.Parameterized):
            fn.fn(spy, *(np.float64(0.5) for _ in fn.params))
        else:
            fn(spy)
    except Exception:
        return None
    return frozenset(spy.seen)


def required_scan_columns(root, at: dict | None = None) -> dict:
    """Per-base-scan required-column demand of a logical plan: map
    ``id(Scan node) -> frozenset`` of the column names the plan above it
    reads (``None`` = analysis failed, ship everything).  Walked
    top-down with the downstream demand in hand:

    * Select adds its predicate's reads;
    * Map satisfies the demand for its defined column and adds its
      function's reads;
    * FKJoin's probe side needs the downstream demand minus the fetched
      build columns, plus the probe key; the build side needs its key
      plus the fetched columns;
    * aggregations reset the demand to their group keys + value /
      carry / threshold columns (the plan above an aggregation reads
      group-level output, not scan columns).

    prob/valid always ride the slabs and are not tracked here.  With
    ``at`` (a dict), each Select predicate and Map column function also
    records under its ``id`` the columns the plan above it reads of its
    input (a Map's own column excluded): what a batched sweep's point
    join there must carry (:mod:`repro_torch.db.sweep`)."""
    from . import plans as L
    out: dict = {}

    def note(scan, need, into=out):
        prev = into.get(id(scan), frozenset())
        into[id(scan)] = None if (need is None or prev is None) \
            else prev | need

    def walk(node, need):
        if isinstance(node, L.Scan):
            note(node, need)
        elif isinstance(node, L.Select):
            if at is not None:
                note(node.pred, need, at)
            cols = _callable_columns(node.pred)
            walk(node.child, None if (need is None or cols is None)
                 else need | cols)
        elif isinstance(node, L.Map):
            if at is not None:
                note(node.fn, None if need is None else need - {node.name},
                     at)
            cols = _callable_columns(node.fn)
            walk(node.child, None if (need is None or cols is None)
                 else (need - {node.name}) | cols)
        elif isinstance(node, L.FKJoin):
            rc = frozenset(node.right_cols)
            walk(node.left, None if need is None
                 else (need - rc) | {node.left_key})
            walk(node.right, frozenset((node.right_key,)) | rc)
        elif isinstance(node, L.Project):
            walk(node.child, frozenset(node.keys))
        elif isinstance(node, L.GroupAgg):
            specs = ((node.value,),) + tuple((e[1],) for e in node.extra)
            vals = {v for (v,) in specs if v}
            walk(node.child, frozenset(node.keys) | vals)
        elif isinstance(node, L.ReweightGreater):
            need_c = set(node.keys) | {node.value} | set(node.carry_cols)
            if node.threshold_col:
                need_c.add(node.threshold_col)
            walk(node.child, frozenset(need_c))
        else:
            # Unknown node: every column of every scan below it.
            for f in ("child", "left", "right"):
                c = getattr(node, f, None)
                if isinstance(c, L.Node):
                    walk(c, None)

    walk(root, None)
    return out


def bucket_capacity(local_rows: int, n_shards: int, slack: float) -> int:
    """Static per-(sender, owner) shuffle bucket rows: ``slack`` times the
    uniform share, capped at the sender's local rows (at which point
    overflow is impossible) and floored at 1."""
    return max(1, min(local_rows,
                      int(math.ceil(local_rows * slack / n_shards))))


def concrete_bucket_capacity(table, key: str, n_shards: int) -> int | None:
    """Skew-adaptive static bucket rows: the max per-(sender, owner)
    demand of the ACTUAL ``key % n_shards`` histogram of a base table's
    (shard-padded) key column, so heavy hitters get exactly the capacity
    they need instead of the uniform ``slack`` tax — and overflow is
    impossible, because downstream selection can only shrink the demand.
    Returns None when the column is traced (jit compiles keep the slack
    sizing and its overflow-NaN guard) or absent.

    The histogram is sized by the table's LOGICAL ``capacity``, not the
    stored array length — a virtually padded :class:`HostTable` keeps
    its stored rows and records the pad separately, and pad rows are
    invalid (they route nowhere), so only stored rows that land in a
    shard's slot range are counted."""
    col = None if table is None else table.columns.get(key)
    if col is None:
        return None
    # Eager PyTorch: every column is concrete, so the histogram always
    # applies (the JAX package falls back to slack sizing under tracing).
    host = lambda a: a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    k = host(col)
    ok = host(table.valid)
    cap = table.capacity
    if k.ndim != 1 or cap % n_shards:
        return None
    local = cap // n_shards
    stored = k.shape[0]
    # Mirror the runtime routing exactly (dist.shuffle_by_key hashes the
    # int32-CAST key): a wider key must wrap the same way here, or the
    # histogram would count a different owner than the exchange uses.
    # sender = row // local over the logical (padded) row order; rows at
    # or past `stored` are virtual pad (invalid) and never counted.
    sender = np.arange(stored) // local
    dest = k.astype(np.int32) % n_shards
    pair = (sender * n_shards + dest)[ok]
    peak = 0
    if pair.size:
        peak = int(np.bincount(pair,
                               minlength=n_shards * n_shards).max())
    return max(1, peak)


def _contains_streamed(node) -> bool:
    """Does any base scan of this physical subtree stream from host?"""
    if isinstance(node, StreamedScan):
        return True
    return any(_contains_streamed(c) for c in
               (getattr(node, "child", None), getattr(node, "left", None),
                getattr(node, "right", None)) if c is not None)


def lower_plan(root, caps: dict, *, n_shards: int = 1, sharded: bool = False,
               join_gather_budget: int = 1 << 20,
               shuffle_slack: float = 4.0,
               copartition: object = "auto",
               agg_shuffle_budget: int | None = None,
               canonical_chunks: int = 8,
               model: C.CostModel | None = None,
               tables: dict | None = None,
               device_row_budget: int | None = None,
               stream_wave_chunks: int | None = None,
               stream_prune_columns: bool = True,
               bucket_floor: int | None = None,
               model_shards: int = 1) -> PhysNode:
    """Lower a logical plan to the physical IR: enumerate physical
    candidates per node, cost them with :mod:`repro_torch.db.cost`, pick the
    cheapest.

    caps: base-table name -> global padded capacity (the compiler pads to
    the canonical chunk grid and the shard count first; golden tests may
    pass any capacities).  ``sharded`` selects mesh mode.  The budget
    knobs are cost-model overrides (see :class:`repro_torch.db.cost.CostModel`):

    * ``join_gather_budget`` — builds over it may not gather, builds at or
      under it must (``FKJoin.gather_budget`` per-node override wins);
    * ``copartition`` — "auto" lets the estimates choose between
      ShuffleJoin + PartialAgg and the fused CoPartitionedJoin +
      PartitionedAgg pipeline (when a GROUP BY keys on the probe join
      key); True forces the fused pipeline whenever it is legal and the
      join may not gather; False disables it;
    * ``agg_shuffle_budget`` — when set, a single-key aggregation over
      more input rows must Repartition + PartitionedAgg instead of
      PartialAgg (None keeps PartialAgg, the PR-4 behaviour);
    * ``device_row_budget`` — out-of-core: a Scan whose per-shard rows
      exceed it lowers to :class:`StreamedScan` with a
      :class:`repro_torch.db.cost.wave_schedule`-chosen wave size; subtrees
      containing a streamed scan restrict joins to GatherJoin (the
      resident build side is gathered once, each wave probes it) and
      aggregations to PartialAgg — the strategies whose per-wave
      semantics are the resident ones verbatim.  A BUILD side over the
      budget raises (only the probe side may stream);
      ``stream_wave_chunks`` pins the wave size (global chunk slots per
      wave) for tests.  ``stream_prune_columns`` (default on) runs
      :func:`required_scan_columns` over the plan and records each
      streamed scan's exact demand set on ``StreamedScan.columns`` —
      wave slabs then ship only those columns, and (when ``tables``
      reveals the full column count) the wave WIDENS so the same
      ``device_row_budget`` bytes hold more rows per slab.

    ``model`` overrides the knob-derived CostModel wholesale (pure
    estimates: ``CostModel(gather_budget=None)``).  ``canonical_chunks``
    is the compile's accumulation grid, which prices the chunked
    PartialAgg merge.  ``tables`` (the
    compiler's padded base tables) enables the skew-adaptive concrete-key
    bucket sizing of :func:`concrete_bucket_capacity`; goldens that pass
    only ``caps`` keep the deterministic slack sizing.  Pure: no table
    DATA is consumed beyond the optional key histograms.

    ``bucket_floor`` raises every exchange bucket to at least this many
    rows (still capped at the sender's local rows, where
    overflow is impossible) — the retry controller's concrete-capacity
    escalation: re-lowering with the observed peak demand from
    ``ExecutionReport.exchange_demand`` as the floor makes the retried
    run overflow-free in one step.
    """
    from . import plans as L

    m = model if model is not None else C.CostModel(
        n_shards=n_shards, gather_budget=join_gather_budget,
        copartition=copartition, agg_shuffle_budget=agg_shuffle_budget,
        shuffle_slack=shuffle_slack, device_row_budget=device_row_budget,
        model_shards=model_shards)

    # Required-column demand per base scan (id(Scan) -> frozenset|None);
    # only computed when something may actually stream.
    scan_cols: dict = {}
    if stream_prune_columns and m.device_row_budget is not None:
        scan_cols = required_scan_columns(root)

    def pick(cands):
        """cands: [(penalty, cost, build_fn)] -> built cheapest node."""
        best = min(cands, key=lambda c: c[0] + m.total(c[1]))
        return best[2]()

    def lineage_scan(node, key):
        """The base Scan a subtree's rows (and the exchange key column)
        descend from, or None when the key is computed/fetched en route."""
        while True:
            if isinstance(node, L.Select):
                node = node.child
            elif isinstance(node, L.Map):
                if node.name == key:
                    return None
                node = node.child
            elif isinstance(node, L.FKJoin):
                if key in node.right_cols:
                    return None
                node = node.left
            else:
                break
        return node if isinstance(node, L.Scan) else None

    hist_cache: dict = {}

    def exchange_bucket(logical, key, rows):
        """Static bucket rows for hashing `logical`'s rows on `key`:
        the concrete-key histogram when available (memoized per base
        table and key — the fused enumeration prices the same exchange
        for several candidates), slack sizing else."""
        local_rows = -(-rows // n_shards)
        scan = lineage_scan(logical, key)
        cap = None
        if scan is not None and tables is not None:
            ck = (scan.name, key)
            if ck not in hist_cache:
                hist_cache[ck] = concrete_bucket_capacity(
                    tables.get(scan.name), key, n_shards)
            cap = hist_cache[ck]
        if cap is None:
            cap = bucket_capacity(local_rows, n_shards, m.shuffle_slack)
        # The floor lifts histogram-sized buckets too: the histogram of a
        # stale stats table can undersize a bucket, and the retry
        # controller's observed demand must reach it (the JAX package
        # floors only the slack-sized ones).
        if bucket_floor is not None:
            cap = max(cap, min(bucket_floor, local_rows))
        return cap

    def join_budget(node):
        return node.gather_budget if node.gather_budget is not None \
            else m.gather_budget

    def join_candidates(node, left, lrows, right, rrows):
        """The unfused FKJoin candidates: GatherJoin always; ShuffleJoin
        when both inputs are RowBlocked on a mesh.  Budget override: over
        budget forbids gather, at/under forbids the exchange; with the
        budget disabled (None) neither side is penalized and the pure
        estimates decide."""
        if _contains_streamed(right):
            raise NotImplementedError(
                "FK-join build side exceeds device_row_budget: only the "
                "probe side of a join may stream (raise the budget or "
                "keep the build table resident)")
        streamed = _contains_streamed(left)
        budget = join_budget(node)
        over = budget is not None and rrows > budget
        exch_pen = 0.0 if (budget is None or over) else C.INF
        w = len(node.right_cols)
        gcost = C.gather_join(m, rrows, w)
        # A streamed probe must gather: each wave re-probes the resident
        # replicated build, which is the resident semantics verbatim.
        gather_pen = 0.0 if streamed \
            else (C.INF if (sharded and over) else 0.0)
        cands = [(gather_pen, gcost,
                  lambda: GatherJoin(left, right, node.left_key,
                                     node.right_key, tuple(node.right_cols),
                                     rrows, left.part, gcost))]
        if sharded and not streamed and isinstance(left.part, RowBlocked) \
                and isinstance(right.part, RowBlocked):
            bb = exchange_bucket(node.right, node.right_key, rrows)
            pb = exchange_bucket(node.left, node.left_key, lrows)
            scost = C.shuffle_join(m, bb, pb, w)
            cands.append(
                (exch_pen, scost,
                 lambda: ShuffleJoin(left, right, node.left_key,
                                     node.right_key,
                                     tuple(node.right_cols), rrows,
                                     HashPartitioned(node.right_key),
                                     bb, pb, left.part, scost)))
        return cands

    def lower_agg(child_logical, keys, specs, max_groups, kappa, num_freq,
                  extra_cols=()):
        """Enumerate + cost the aggregation pipelines over `child_logical`
        and return the chosen PartialAgg / PartitionedAgg node.

        ``extra_cols``: non-spec columns the pass reads (reweight
        threshold / carry columns) — shipped by the fused exchanges."""
        keys = tuple(keys)
        needed = {v for _n, v, _a, _mth in specs if v}
        needed |= set(extra_cols)
        add_e, fold_e, rflops = C.agg_state_elems(
            specs, max_groups, kappa, num_freq,
            model_shards=m.model_shards)
        chunks = canonical_chunks      # the compile's accumulation grid

        cands = []
        fusable = (sharded and isinstance(child_logical, L.FKJoin)
                   and keys == (child_logical.left_key,))
        if fusable:
            j = child_logical
            left, lrows = go(j.left)
            right, rrows = go(j.right)
            budget = join_budget(j)
            over = budget is not None and rrows > budget
            exchangeable = isinstance(left.part, RowBlocked) \
                and isinstance(right.part, RowBlocked) \
                and not (_contains_streamed(left)
                         or _contains_streamed(right))
            force = m.copartition is True and over and exchangeable
            for pen, jcost, build in join_candidates(j, left, lrows,
                                                     right, rrows):
                pcost = C.partial_agg(m, -(-lrows // n_shards),
                                      chunks, add_e, fold_e, rflops)
                def mk(build=build, pcost=pcost):
                    c = build()
                    return PartialAgg(c, keys, specs, max_groups, kappa,
                                      num_freq, c.part, pcost)
                cands.append((C.INF if force else pen, jcost + pcost, mk))
            if exchangeable and m.copartition is not False:
                right_keep = tuple(c for c in j.right_cols if c in needed)
                carry = tuple(sorted(needed - set(j.right_cols)
                                     - {j.left_key}))
                bb = exchange_bucket(j.right, j.right_key, rrows)
                pb = exchange_bucket(j.left, j.left_key, lrows)
                jcost = C.copartitioned_join(m, bb, pb, len(right_keep),
                                             len(carry))
                pcost = C.partitioned_agg(m, n_shards * pb, chunks,
                                          add_e, fold_e, rflops)

                def mk_fused(jcost=jcost, pcost=pcost, right_keep=right_keep,
                             carry=carry, bb=bb, pb=pb):
                    cj = CoPartitionedJoin(
                        left, right, j.left_key, j.right_key, right_keep,
                        carry, rrows, bb, pb,
                        HashPartitioned(j.left_key), jcost)
                    return PartitionedAgg(cj, keys, specs, max_groups,
                                          kappa, num_freq, cj.part, pcost)
                cands.append((0.0 if (budget is None or over) else C.INF,
                              jcost + pcost, mk_fused))
            return pick(cands)

        child, rows = go(child_logical)
        pcost = C.partial_agg(m, -(-rows // n_shards), chunks,
                              add_e, fold_e, rflops)
        repartable = (sharded and len(keys) == 1
                      and isinstance(child.part, RowBlocked)
                      and m.agg_shuffle_budget is not None
                      and not _contains_streamed(child))
        repart = repartable and rows > m.agg_shuffle_budget
        cands = [(C.INF if repart else 0.0, pcost,
                  lambda: PartialAgg(child, keys, specs, max_groups, kappa,
                                     num_freq, child.part, pcost))]
        if repartable:
            carry = tuple(sorted(needed - {keys[0]}))
            pb = exchange_bucket(child_logical, keys[0], rows)
            rcost = C.repartition(m, pb, len(carry))
            acost = C.partitioned_agg(m, n_shards * pb, chunks,
                                      add_e, fold_e, rflops)

            def mk_repart(pb=pb, carry=carry, rcost=rcost, acost=acost):
                rp = Repartition(child, keys[0], carry, pb,
                                 HashPartitioned(keys[0]), rcost)
                return PartitionedAgg(rp, keys, specs, max_groups, kappa,
                                      num_freq, rp.part, acost)
            cands.append((0.0 if repart else C.INF, rcost + acost,
                          mk_repart))
        return pick(cands)

    def go(node):
        """-> (phys_node, global output rows of the subtree)."""
        if isinstance(node, L.Scan):
            part = RowBlocked() if sharded else Replicated()
            rows = caps[node.name]
            budget = m.device_row_budget
            if budget is not None and -(-rows // n_shards) > budget:
                # chunk rows of the canonical grid: caps are shard-padded
                # (slots * csz) when they come from the compiler; golden
                # caps fall back to the chunk-grid division.
                slots = n_shards * (-(-canonical_chunks // n_shards))
                csz = rows // slots if rows % slots == 0 \
                    else -(-rows // canonical_chunks)
                t = None if tables is None else tables.get(node.name)
                total_cols = len(t.columns) if t is not None else None
                need = scan_cols.get(id(node)) if scan_cols else None
                if need is not None and t is not None:
                    need = frozenset(need) & set(t.columns)
                cols = None if need is None else tuple(sorted(need))
                ncols = len(cols) if cols is not None else (total_cols or 1)
                # Pruned rows are narrower: widen the wave so the same
                # byte budget (calibrated on full rows) still fills it.
                width = 1.0
                if cols is not None and total_cols:
                    width = (ncols + 2) / (total_cols + 2)
                sched = C.wave_schedule(csz, canonical_chunks, n_shards,
                                        budget, stream_wave_chunks,
                                        width=width)
                scost = C.streamed_scan(m, rows, sched.wave_rows, ncols)
                return StreamedScan(node.name, part, rows, sched, scost,
                                    cols), rows
            return ShardScan(node.name, part, rows), rows
        if isinstance(node, L.Select):
            c, rows = go(node.child)
            return PhysSelect(c, node.pred, c.part), rows
        if isinstance(node, L.Map):
            c, rows = go(node.child)
            return PhysMap(c, node.name, node.fn, c.part), rows
        if isinstance(node, L.FKJoin):
            left, lrows = go(node.left)
            right, rrows = go(node.right)
            return pick(join_candidates(node, left, lrows, right, rrows)), \
                lrows
        if isinstance(node, L.Project):
            pa = lower_agg(node.child, node.keys, (), node.max_groups,
                           64, 0)
            return MergeAgg(pa, "project"), node.max_groups
        if isinstance(node, L.GroupAgg):
            specs = ((L._out_key(node.agg, node.method), node.value,
                      node.agg, node.method),) + tuple(node.extra)
            names = [s[0] for s in specs]
            clashes = set(names) & _RESERVED_OUT_KEYS
            if clashes or len(set(names)) != len(names):
                raise ValueError(
                    f"GroupAgg aggregate names must be unique and avoid "
                    f"{sorted(_RESERVED_OUT_KEYS)}; got {names}")
            pa = lower_agg(node.child, node.keys, specs, node.max_groups,
                           node.kappa, node.num_freq)
            return MergeAgg(pa, "groupagg"), node.max_groups
        if isinstance(node, L.ReweightGreater):
            if not node.threshold_col and node.threshold is None:
                raise ValueError("ReweightGreater needs threshold_col "
                                 "or a constant threshold")
            extra = tuple(node.carry_cols)
            if node.threshold_col:
                extra += (node.threshold_col,)
            pa = lower_agg(node.child, node.keys,
                           (("sum", node.value, "SUM", "normal"),),
                           node.max_groups, 64, 0, extra_cols=extra)
            return MergeAgg(pa, "reweight", node.threshold_col,
                            node.threshold, tuple(node.carry_cols)), \
                node.max_groups
        raise TypeError(node)

    return go(root)[0]


def explain(node: PhysNode, indent: int = 0) -> str:
    """Human/golden-test-readable rendering of a physical plan; chosen
    nodes print their modeled cost (bytes moved, peak rows/device)."""
    pad = "  " * indent

    def tag(n):
        t = type(n.part).__name__ if not isinstance(n.part,
                                                    HashPartitioned) \
            else f"HashPartitioned({n.part.key})"
        c = getattr(n, "cost", None)
        return t if c is None else f"{t} cost{{{c.fmt()}}}"

    if isinstance(node, ShardScan):
        return f"{pad}ShardScan({node.name}, rows={node.rows}) :: {tag(node)}"
    if isinstance(node, StreamedScan):
        s = node.schedule
        cols = "*" if node.columns is None else ",".join(node.columns)
        return (f"{pad}StreamedScan({node.name}, rows={node.rows}, "
                f"waves={s.n_waves}x{s.chunks_per_wave}chunks"
                f"@{s.chunk_rows}rows, cols=[{cols}]) :: {tag(node)}")
    if isinstance(node, PhysSelect):
        return (f"{pad}Select :: {tag(node)}\n"
                + explain(node.child, indent + 1))
    if isinstance(node, PhysMap):
        return (f"{pad}Map({node.name}) :: {tag(node)}\n"
                + explain(node.child, indent + 1))
    if isinstance(node, GatherJoin):
        return (f"{pad}GatherJoin({node.left_key}={node.right_key}, "
                f"build={node.build_rows}) :: {tag(node)}\n"
                + explain(node.left, indent + 1) + "\n"
                + explain(node.right, indent + 1))
    if isinstance(node, ShuffleJoin):
        return (f"{pad}ShuffleJoin({node.left_key}={node.right_key}, "
                f"build={node.build_rows}, "
                f"exchange=HashPartitioned({node.exchange.key}), "
                f"buckets=(build={node.build_bucket}, "
                f"probe={node.probe_bucket})) :: {tag(node)}\n"
                + explain(node.left, indent + 1) + "\n"
                + explain(node.right, indent + 1))
    if isinstance(node, CoPartitionedJoin):
        return (f"{pad}CoPartitionedJoin({node.left_key}={node.right_key}, "
                f"build={node.build_rows}, "
                f"carry={list(node.carry_cols)}, "
                f"buckets=(build={node.build_bucket}, "
                f"probe={node.probe_bucket})) :: {tag(node)}\n"
                + explain(node.left, indent + 1) + "\n"
                + explain(node.right, indent + 1))
    if isinstance(node, Repartition):
        return (f"{pad}Repartition({node.key}, "
                f"carry={list(node.carry_cols)}, "
                f"bucket={node.bucket}) :: {tag(node)}\n"
                + explain(node.child, indent + 1))
    if isinstance(node, PartialAgg):
        return (f"{pad}PartialAgg(keys={list(node.keys)}, "
                f"specs={[s[0] for s in node.specs]}, "
                f"G={node.max_groups}) :: {tag(node)}\n"
                + explain(node.child, indent + 1))
    if isinstance(node, PartitionedAgg):
        return (f"{pad}PartitionedAgg(keys={list(node.keys)}, "
                f"specs={[s[0] for s in node.specs]}, "
                f"G={node.max_groups}) :: {tag(node)}\n"
                + explain(node.child, indent + 1))
    if isinstance(node, MergeAgg):
        return (f"{pad}MergeAgg[{node.kind}] :: {tag(node)}\n"
                + explain(node.child, indent + 1))
    raise TypeError(node)
