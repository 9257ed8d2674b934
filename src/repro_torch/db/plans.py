"""Probabilistic -> deterministic plan compilation (paper §VI, Table I;
port of ``repro.db.plans``): the logical plan nodes, the single-device
executor (resident and streamed) and the retry controller.

``compile_plan(root)`` lowers the logical DAG with the copied physical
planner (:func:`repro_torch.db.physical.lower_plan`) and returns a
function ``tables -> result`` that interprets the physical plan eagerly
(``compiled.bind(tables)`` lowers once and returns a runner that only
executes):
every base table is padded to the canonical chunk grid, every aggregation
pass accumulates one UDA state per canonical chunk and folds them in the
fixed :func:`repro_torch.core.uda.tree_fold` tree, so a result is the same
bits on every run.  Exact-CF aggregations whose (max_groups, num_freq)
state exceeds ``cf_budget_elems`` run as several frequency-slab passes
whose states are concatenated before the one batched-FFT Finalize.

Out-of-core: with ``device_row_budget`` a base table over the budget
stays on the host (:class:`repro_torch.db.table.HostTable`) and the
aggregation pass above it runs as waves of chunk-aligned slabs whose
per-chunk states fold in the same tree, so streamed equals resident bit
for bit.  ``with_report=True`` returns an
:class:`repro_torch.db.report.ExecutionReport` beside the result, and
:func:`run_plan` re-runs a plan with escalated parameters until its report
is clean.  ``compile_plan(root, mesh)`` runs the same plan on every rank of
a :class:`repro_torch.launch.mesh.Mesh` (one process per rank, collectives
in :mod:`repro_torch.db.distributed`) and returns the same bits as
``mesh=None`` for any data-rank count.

Node zoo (Table I rows in brackets):

    Scan(name)                               [I]   R -> R^p
    Select(child, pred)                      [II]  sigma, deterministic cond
    Map(child, name, fn)                     [--]  computed column
    FKJoin(l, r, lk, rk, cols[, budget])     [IV]  join, deterministic cond
    Project(child, keys, max_groups)         [V]   GROUP BY + AtLeastOne
    GroupAgg(child, keys, agg, value, ...)   [VI]  GROUP BY + PGF UDAs
    ReweightGreater(child, agg_of, vs, ...)  [III] p *= P(SUM > threshold)
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import torch

from ..core import uda
from ..core.config import resolve_device
from ..kernels import pb_cf
from ..launch.mesh import Mesh
from ..testing import faults
from . import cost as C
from . import distributed as dist
from . import operators as ops
from . import physical as phys
from . import sweep
from .report import ReportBuilder, nan_count
from .table import HostTable, Table


class Node:
    pass


@dataclasses.dataclass(frozen=True)
class Scan(Node):
    name: str


@dataclasses.dataclass(frozen=True)
class Select(Node):
    child: Node
    pred: Callable[[Table], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Map(Node):
    """Attach a computed column `name` = fn(table) to the child relation."""
    child: Node
    name: str
    fn: Callable[[Table], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FKJoin(Node):
    """Many-to-one equijoin; ``gather_budget`` overrides the compiler's
    ``join_gather_budget`` for this join (a mesh-lowering knob)."""
    left: Node
    right: Node
    left_key: str
    right_key: str
    right_cols: tuple
    gather_budget: int | None = None


@dataclasses.dataclass(frozen=True)
class Project(Node):
    child: Node
    keys: tuple
    max_groups: int


@dataclasses.dataclass(frozen=True)
class GroupAgg(Node):
    """Returns a dict of per-group UDA results, not a Table.

    The primary aggregate lands under "sum" / "cumulants" / "exact" (by
    method) or "minmax" (MIN / MAX: the run dict of
    :func:`repro_torch.db.operators.minmax_runs`); each `extra` entry
    (name, value_col, agg, method) rides the SAME accumulation pass under
    its own name.  Group confidence
    (AtLeastOne) is always included.  `value` == "" means COUNT.
    ``method="exact"`` needs ``num_freq`` = max aggregate value + 1 and
    yields a (max_groups, num_freq) row-stochastic coefficient matrix."""
    child: Node
    keys: tuple
    value: str            # column to aggregate ("" = COUNT)
    agg: str              # SUM | COUNT | MIN | MAX
    max_groups: int
    method: str = "normal"  # normal | cumulants | exact
    extra: tuple = ()
    kappa: int = 64       # MIN/MAX support capacity per group
    num_freq: int = 0     # exact: distribution capacity (max sum + 1)


@dataclasses.dataclass(frozen=True)
class ReweightGreater(Node):
    """sigma_{AGG(B) > C}: group child by keys, SUM(value), then keep each
    group with p = AtLeastOne * P(SUM > threshold) (Table I row III).  The
    threshold is `threshold_col` (per-group column) when set, else the
    constant `threshold`; `carry_cols` are kept on the output Table."""
    child: Node
    keys: tuple
    value: str
    threshold_col: str
    max_groups: int
    threshold: float | None = None
    carry_cols: tuple = ()


@dataclasses.dataclass(frozen=True)
class Param:
    """A named scalar hole in a logical plan, bound at run time by
    ``compiled(tables, params={name: value})``.  Legal as
    :attr:`ReweightGreater.threshold` and inside :class:`Parameterized`."""
    name: str


@dataclasses.dataclass(frozen=True)
class Parameterized:
    """A Select predicate / Map column function with lifted scalar
    parameters: ``fn(table, *values)`` receives the named params' values
    in ``params`` order."""
    fn: Callable
    params: tuple

    def __call__(self, t: Table, env: Dict[str, torch.Tensor]):
        return self.fn(t, *(env[p] for p in self.params))


def plan_params(root: Node) -> frozenset:
    """The set of parameter names a logical plan needs at run time."""
    names: set = set()

    def walk(n):
        for f in ("child", "left", "right"):
            c = getattr(n, f, None)
            if isinstance(c, Node):
                walk(c)
        for f in ("pred", "fn"):
            v = getattr(n, f, None)
            if isinstance(v, Parameterized):
                names.update(v.params)
        if isinstance(getattr(n, "threshold", None), Param):
            names.add(n.threshold.name)

    walk(root)
    return frozenset(names)


def plan_key(root: Node) -> tuple:
    """Stable structural cache key of a logical plan: two separately
    constructed but identical plans (same node structure, same predicate
    bytecode and captured constants, same static knobs) produce EQUAL
    keys -- what the serving layer's plan cache keys bindings on.
    Delegates to :func:`repro_torch.db.physical.structural_key`; unknown
    objects and tensors degrade to identity keys (a possible miss, never a
    false hit)."""
    return ("plan", phys.structural_key(root))


def mesh_fingerprint(mesh) -> tuple | None:
    """Hashable identity of this rank's :class:`~repro_torch.launch.mesh.
    Mesh` for cache keys: axis names, shape, backend, this rank's
    coordinates and its device -- what the lowering and the collectives
    depend on; None for single-device compiles."""
    if mesh is None:
        return None
    names = tuple(mesh.axis_names)
    return (names, tuple(mesh.shape[a] for a in names), mesh.backend,
            tuple(mesh.coords[a] for a in names), str(mesh.device))


class LRUCache:
    """Bounded least-recently-used mapping with hit/miss/eviction
    counters and an ``on_evict`` hook -- the cache primitive behind
    :class:`repro_torch.db.serving.PlanCache`, whose entries hold bound
    plans and the device tables they placed, so the population must stay
    bounded and an evicted entry must be dropped."""

    def __init__(self, capacity: int, on_evict: Callable | None = None):
        if capacity < 1:
            raise ValueError(f"LRUCache capacity must be >= 1, got "
                             f"{capacity}")
        self.capacity = capacity
        self.on_evict = on_evict
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def get(self, key, default=None):
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return default

    def put(self, key, value) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        self._trim()

    def _trim(self) -> None:
        while len(self._data) > self.capacity:
            _, old = self._data.popitem(last=False)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old)

    def set_capacity(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"LRUCache capacity must be >= 1, got "
                             f"{capacity}")
        self.capacity = capacity
        self._trim()

    def clear(self) -> None:
        """Evict everything (the on_evict hook runs for each entry)."""
        while self._data:
            _, old = self._data.popitem(last=False)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old)

    def values(self) -> list:
        """The cached values, least recently used first (no counters
        move)."""
        return list(self._data.values())

    def info(self) -> dict:
        return dict(size=len(self._data), capacity=self.capacity,
                    hits=self.hits, misses=self.misses,
                    evictions=self.evictions)


class Placement:
    """Device copies of base tables, made once and shared by every
    binding given this object (``compiled.bind(tables, placement)``; the
    serving layer gives one to all plans of a catalogue): a device table
    padded to the chunk grid, a HostTable materialised on the device, a
    device table pulled to the host for streaming, or a mesh rank's row
    block.  A copy is keyed by table name, window and device and serves
    only the table object it was made from.  It is held WEAKLY: the
    runners that use it keep it alive, so it dies with the last binding
    that references it (an evicted or re-bound entry frees its copies)."""

    def __init__(self):
        self._copies: dict = {}

    def copies(self) -> list:
        """The copies some live binding still holds."""
        live = [(src(), out()) for src, out in self._copies.values()]
        return [out for src, out in live
                if src is not None and out is not None]

    def __len__(self) -> int:
        return len(self.copies())

    def get(self, name: str, source, window: tuple, dev, make: Callable):
        key = (name, window, str(dev))
        held = self._copies.get(key)
        if held is not None and held[0]() is source:
            out = held[1]()
            if out is not None:
                return out
        for k in [k for k, (src, out) in self._copies.items()
                  if src() is None or out() is None]:
            del self._copies[k]
        out = make()
        self._copies[key] = (weakref.ref(source), weakref.ref(out))
        return out

    def clear(self) -> None:
        self._copies.clear()


def _agg_uda(agg: str, method: str, kappa: int, num_freq: int = 0,
             freq_lo: int = 0, freq_cnt: int | None = None,
             half: bool = False) -> uda.UDA:
    if agg in ("MIN", "MAX"):
        if method == "exact":
            raise ValueError(
                "GroupAgg method 'exact' applies to SUM/COUNT only; MIN/MAX "
                "distributions come from the MinMax UDA (kappa support)")
        return uda.MinMax(kappa=kappa, sign=1.0 if agg == "MIN" else -1.0)
    if agg not in ("SUM", "COUNT"):
        raise ValueError(agg)
    if method == "normal":
        return uda.SumNormal()
    if method == "cumulants":
        return uda.SumCumulants()
    if method == "exact":
        if num_freq <= 0:
            raise ValueError(
                "GroupAgg(method='exact') needs num_freq = max aggregate "
                "value + 1 (the static distribution capacity)")
        return uda.SumCF(num_freq, freq_lo=freq_lo, freq_cnt=freq_cnt,
                         half=half)
    raise ValueError(
        f"GroupAgg method {method!r} is not supported by the planner "
        "(expected 'normal', 'cumulants' or 'exact')")


def _out_key(agg: str, method: str) -> str:
    if agg in ("MIN", "MAX"):
        return "minmax"
    return {"cumulants": "cumulants", "exact": "exact"}.get(method, "sum")


def _freq_slabs(num_freq: int, max_groups: int, budget: int) -> tuple:
    """Split [0, num_freq) into slabs so each (max_groups, slab) exact-CF
    state stays within ``budget`` elements; slab widths stay multiples of
    128 when above it."""
    f_slab = max(1, budget // max(1, max_groups))
    if f_slab >= num_freq:
        return ((0, num_freq),)
    if f_slab > 128:
        f_slab -= f_slab % 128
    return tuple((lo, min(f_slab, num_freq - lo))
                 for lo in range(0, num_freq, f_slab))


def _pass_values(specs, t: Table) -> dict:
    """Fetch each spec's value column exactly once (the raw dtype is kept
    so integer sources stay CF-kernel-eligible)."""
    values: dict = {}
    cols: dict = {}
    for name, value, agg, _method in specs:
        if agg == "COUNT" or not value:
            values[name] = None
        else:
            if value not in cols:
                cols[value] = t[value]
            values[name] = cols[value]
    return values


def _pass_slabs(pa, cf_budget_elems: int) -> tuple:
    """(exact aggregate names, frequency-slab schedule) of one pass."""
    exact_names = [s[0] for s in pa.specs if s[3] == "exact"]
    slabs = (_freq_slabs(pa.num_freq, pa.max_groups,
                         cf_budget_elems // (2 * len(exact_names)))
             if exact_names else ((0, pa.num_freq),))
    return exact_names, slabs


def _mirrored(pa, exact_names, slabs, chunk_probs, values) -> bool:
    """Does this scalar (one-group) pass run its exact aggregates through
    the logcf kernel (or its plain version) on chunks like
    ``chunk_probs``?  That kernel computes k <= N/2 and mirrors the rest."""
    return (pa.max_groups == 1 and len(slabs) == 1 and bool(exact_names)
            and all(uda.logcf_runs(pa.num_freq, chunk_probs, values[n])
                    for n in exact_names))


def _model_freq_split(cnt: int, model_size: int, scalar: bool,
                      mirrored: bool) -> tuple | None:
    """(split columns, per-model-rank width) of one exact-CF slab of
    ``cnt`` frequencies, or None when it does not split: no model axis,
    too few columns for every rank to get one, or a scalar (one-group)
    pass whose chunks do not run the logcf kernel.  Rank r accumulates the
    window [lo + r*f_loc, lo + (r+1)*f_loc) of the split columns, cut at
    their end; each frequency column is computed on its own, so the
    windows gathered by ``SumCF.reduce_model`` are the unsplit columns bit
    for bit.  A ``mirrored`` scalar pass (:func:`_mirrored`) splits the
    kernel's N/2 + 1 columns and mirrors them after the gather; a scalar
    pass on the block loop stays whole (its one-group sum is not the same
    column by column at every width)."""
    if model_size <= 1 or (scalar and not mirrored):
        return None
    width = cnt // 2 + 1 if scalar else cnt
    f_loc = -(-width // model_size)
    return (width, f_loc) if (model_size - 1) * f_loc < width else None


def _slab_udas(pa, si: int, lo: int, cnt: int, values: dict,
               model_rank: int = 0, model_size: int = 1,
               mirrored: bool = False) -> tuple:
    """UDA dict + value dict of frequency-slab pass ``si``: pass 0 carries
    confidence and every non-exact aggregate; every pass carries the exact
    aggregates' (lo, cnt) frequency window, or with a model axis this
    model rank's part of it (:func:`_model_freq_split`; the caller
    reassembles the slab with :func:`_gather_model_slabs`)."""
    udas_i: dict = {}
    vals_i: dict = {}
    if si == 0:
        udas_i["confidence"] = uda.AtLeastOne()
        vals_i["confidence"] = None
        for name, _value, agg, method in pa.specs:
            if method != "exact":
                udas_i[name] = _agg_uda(agg, method, pa.kappa)
                vals_i[name] = values[name]
    scalar = pa.max_groups == 1
    split = _model_freq_split(cnt, model_size, scalar, mirrored)
    if split is not None:
        width, f_loc = split
        start = lo + model_rank * f_loc
        lo, cnt = start, min(f_loc, lo + width - start)
    for name, _value, agg, method in pa.specs:
        if method == "exact":
            udas_i[name] = _agg_uda(agg, method, pa.kappa, pa.num_freq, lo,
                                    cnt, half=scalar and split is not None)
            vals_i[name] = values[name]
    return udas_i, vals_i


def _gather_model_slabs(udas_i: dict, sts: dict, exact_names, cnt: int,
                        max_ax, scalar: bool, mirrored: bool) -> dict:
    """Reassemble model-split exact-CF windows into the full slab of
    ``cnt`` frequencies: each rank's window padded to the common width,
    one gather along the last axis (``SumCF.reduce_model``), the pad cut,
    and a scalar pass's N/2 + 1 columns mirrored.  No-op when
    :func:`_slab_udas` did not split."""
    split = (None if max_ax is None else
             _model_freq_split(cnt, max_ax.size, scalar, mirrored))
    if split is None:
        return sts
    width, f_loc = split
    out = dict(sts)
    for name in exact_names:
        st = sts[name]
        pad = f_loc - st.log_abs.shape[-1]
        if pad:
            st = uda.CFState(torch.nn.functional.pad(st.log_abs, (0, pad)),
                             torch.nn.functional.pad(st.angle, (0, pad)))
        st = udas_i[name].reduce_model(st, max_ax)
        st = uda.CFState(st.log_abs[..., :width].contiguous(),
                         st.angle[..., :width].contiguous())
        if scalar:
            st = uda.CFState(*pb_cf.mirror(st.log_abs, st.angle,
                                           udas_i[name].num_freq))
        out[name] = st
    return out


def _append_slab(states: dict, udas: dict, udas_i: dict, sts: dict) -> None:
    """Fold one slab pass's states in: the first slab registers the state
    (and its Finalize UDA), later slabs append their frequency window."""
    for name, st in sts.items():
        if name in states:
            prev = states[name]
            states[name] = uda.CFState(
                torch.cat([prev.log_abs, st.log_abs], -1),
                torch.cat([prev.angle, st.angle], -1))
        else:
            states[name] = st
            udas[name] = udas_i[name]


def _cf_operands(pa, exact_names, slabs, probs, values, ids,
                 num_chunks: int) -> dict:
    """The grouped CF kernel's argsort(gids) and operand prep, hoisted
    above the frequency-slab loop when a pass has more than one slab:
    prepared once per canonical chunk and reused by every slab pass.  The
    resident pass and every streamed wave call this alike, so the CF
    kernels get their operands in the same order on both paths."""
    out: dict = {}
    if len(slabs) > 1:
        for name in exact_names:
            prepared = uda.cf_chunk_operands(
                pa.num_freq, probs, values[name], ids,
                max_groups=pa.max_groups, num_chunks=num_chunks)
            if prepared is not None:
                out[name] = prepared
    return out


def _lost_group_count(code_live, big, merged, ids):
    """Live rows whose group code was dropped past ``max_groups``: a
    dropped code can never equal ``merged[ids]`` (the table holds only the
    kept distinct codes), while every kept live code does."""
    return torch.sum((code_live != big)
                     & (merged[ids] != code_live)).to(torch.int32)


def _finalize_pass(node, pa, udas: dict, states: dict, gvalid, key_columns,
                   rb=None, label: str = "", params=None,
                   n_points: int | None = None):
    """The epilogue of one aggregation pass, selected by ``node.kind``;
    ``key_columns(cols)`` returns the per-group representatives.  With a
    :class:`ReportBuilder` the pass also files its diagnostics: the NaN
    count of every folded UDA state and the per-group §V-B.2 truncation
    mass of each MIN/MAX aggregate (a batched sweep's swept pass, of
    ``n_points``, files them point by point)."""
    if rb is not None:
        for name, st in states.items():
            rb.state_nan(f"{label}.{name}", nan_count(st) if n_points is None
                         else sweep.nan_count(st, n_points))
        for name, _value, agg, _method in pa.specs:
            if agg in ("MIN", "MAX"):
                tail = udas[name].tail_mass(states[name])
                if n_points is None:
                    rb.tail(f"{label}.{name}", tail)
                else:
                    rb.tail(f"{label}.{name}",
                            sweep.split_points(tail, n_points),
                            per_point=True)
    conf = udas["confidence"].finalize(states["confidence"])
    if node.kind == "project":
        return Table(key_columns(list(pa.keys)), conf, gvalid, node.part)
    if node.kind == "reweight":
        mu, var = udas["sum"].finalize(states["sum"])
        carry = list(pa.keys) + list(node.carry_cols)
        if node.threshold_col:
            gcols = key_columns(carry + [node.threshold_col])
            thr = gcols[node.threshold_col].to(mu.dtype)
        else:
            gcols = key_columns(carry)
            thr = node.threshold
            if isinstance(thr, Param):      # lifted constant: value at run
                thr = (params or {})[thr.name]
            thr = torch.as_tensor(thr, dtype=mu.dtype, device=mu.device)
        p_gt = ops.normal_greater(mu, var, thr)
        return Table({k: gcols[k] for k in carry}, conf * p_gt, gvalid,
                     node.part)
    out = dict(valid=gvalid, keys=key_columns(list(pa.keys)),
               confidence=conf)
    for name, _value, agg, _method in pa.specs:
        u, st = udas[name], states[name]
        if agg in ("MIN", "MAX"):
            out[name] = ops.minmax_runs(u, st)
        else:
            out[name] = u.finalize(st)
    return out


# ------------------------------------------------- streamed-plan surgery
def _iter_phys(node):
    yield node
    for f in ("child", "left", "right"):
        c = getattr(node, f, None)
        if isinstance(c, phys.PhysNode):
            yield from _iter_phys(c)


def _lowest_streamed_agg(node):
    """The LOWEST MergeAgg whose subtree contains a StreamedScan: the pass
    the wave loop executes; everything above it sees only the pass's
    group-level output and runs resident."""
    if not phys._contains_streamed(node):
        return None
    for f in ("child", "left", "right"):
        c = getattr(node, f, None)
        if isinstance(c, phys.PhysNode):
            found = _lowest_streamed_agg(c)
            if found is not None:
                return found
    return node if isinstance(node, phys.MergeAgg) else None


def _swap_node(node, target, repl):
    """Rebuild the (frozen-dataclass) physical plan with ``target``
    replaced by ``repl``."""
    if node is target:
        return repl
    for f in ("child", "left", "right"):
        c = getattr(node, f, None)
        if isinstance(c, phys.PhysNode):
            new = _swap_node(c, target, repl)
            if new is not c:
                return dataclasses.replace(node, **{f: new})
    return node


#: reserved base-table name the streamed pass's result is re-injected
#: under when the plan continues above it.
_STREAMED_RESULT = "\x00streamed"

#: Process-wide streamed-transfer counters (benchmarks and tests): bytes
#: shipped in wave slabs (pruned slabs count only the pruned payload),
#: slabs shipped, the host seconds spent cutting slabs into the ping-pong
#: buffers (``slice_s``: the page-faulting copy out of [memory-mapped]
#: host arrays) and the device seconds of the host->device copies
#: (``copy_s``: CUDA events around each copy; 0 on the CPU).
_STREAM_STATS = {"slab_bytes": 0, "waves": 0, "slice_s": 0.0, "copy_s": 0.0}


def reset_stream_stats() -> None:
    """Zero the streamed-transfer counters (call before a measured run)."""
    _STREAM_STATS.update(slab_bytes=0, waves=0, slice_s=0.0, copy_s=0.0)


def stream_stats() -> dict:
    """Snapshot of the streamed-transfer counters since the last reset."""
    return dict(_STREAM_STATS)


def _slab_tensors(t: Table) -> list:
    return list(t.columns.values()) + [t.prob, t.valid]


def _target(device) -> torch.device:
    """The device host tables ship to, with its index resolved."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on_device(t, dev: torch.device) -> Table:
    """A base table as a Table on ``dev`` (a HostTable is materialised)."""
    if isinstance(t, HostTable):
        return t.to_table(dev)
    if t.device == dev:
        return t
    return Table({k: v.to(dev) for k, v in t.columns.items()},
                 t.prob.to(dev), t.valid.to(dev), t.part)


def shard_capacity(capacity: int, canonical_chunks: int, shards: int) -> int:
    """The padded capacity a mesh compile gives a base table: the
    canonical chunk grid (chunk size csz = ceil(n / chunks)), then whole
    padding chunks until every data rank owns the same number of chunk
    slots: shards * ceil(chunks / shards) * csz rows.  Padding chunks hold
    only invalid p = 0 rows and get no state."""
    csz = -(-capacity // canonical_chunks)
    local = -(-canonical_chunks // shards)
    return shards * local * csz


class _PaddedView:
    """A device table seen at its (larger) shard-padded capacity, without
    the copy: what the lowering's key histograms
    (``physical.concrete_bucket_capacity``) read.  Rows past the stored
    ones are invalid, so they are never counted."""

    def __init__(self, t: Table, capacity: int):
        self.columns = t.columns
        self.valid = t.valid
        self.capacity = capacity


def _block(t, start: int, rows: int, dev: torch.device) -> Table:
    """Rows [start, start + rows) of a base table as a Table on ``dev``,
    invalid p = 0 zeros past its stored rows."""
    if isinstance(t, HostTable):
        return _on_device(t.slab(start, rows), dev)
    stop = min(start + rows, t.capacity)
    sl = slice(min(start, stop), stop)
    cut = Table({k: v[sl] for k, v in t.columns.items()}, t.prob[sl],
                t.valid[sl], t.part)
    return _on_device(cut.pad_to(rows), dev)


def _canonical_rows(pnode, caps: dict) -> int:
    """Output rows of a relational subtree under mesh=None padding (row
    capacity follows the probe / left lineage to its scan); ``caps`` holds
    the canonical (chunk-grid only) capacities of the base tables."""
    if isinstance(pnode, (phys.ShardScan, phys.StreamedScan)):
        return caps[pnode.name]
    if isinstance(pnode, (phys.PhysSelect, phys.PhysMap, phys.Repartition)):
        return _canonical_rows(pnode.child, caps)
    if isinstance(pnode, (phys.GatherJoin, phys.ShuffleJoin,
                          phys.CoPartitionedJoin)):
        return _canonical_rows(pnode.left, caps)
    if isinstance(pnode, phys.MergeAgg):
        return pnode.child.max_groups
    raise TypeError(pnode)


def _chunk_parts(udas_d, probs, values: dict, ids, mg: int, real: int,
                 nslots: int, cf_operands=None,
                 block: int = uda.BLOCK) -> list:
    """Per-chunk-slot states of ``nslots`` equal slots of the columns: the
    first ``real`` chunks accumulated, the rest (padding chunks past the
    canonical grid) init states that launch nothing."""
    rows = real * (probs.shape[0] // nslots)
    cut: dict = {}
    vals = {k: None if v is None else cut.setdefault(id(v), v[:rows])
            for k, v in values.items()}
    parts = uda.accumulate_chunk_states(
        udas_d, probs[:rows], vals, ids[:rows], max_groups=mg,
        num_chunks=real, cf_operands=cf_operands, block=block) if real else []
    fill = {name: u.init(mg, probs.dtype, probs.device)
            for name, u in udas_d.items()}
    return parts + [fill] * (nslots - real)


def compile_plan(root: Node, mesh=None, *,
                 data_axes=("data",),
                 model_axis: str | None = "model",
                 cf_budget_elems: int = 1 << 22,
                 canonical_chunks: int = 8,
                 join_gather_budget: int = 1 << 20,
                 shuffle_slack: float = 4.0,
                 copartition: object = False,
                 agg_shuffle_budget: int | None = None,
                 cost_model=None,
                 device_row_budget: int | None = None,
                 stream_wave_chunks: int | None = None,
                 stream_double_buffer: bool = True,
                 stream_prune_columns: bool = True,
                 stream_wave_retries: int = 2,
                 stats_tables=None,
                 with_report: bool = False,
                 shuffle_bucket_floor: int | None = None,
                 device="cuda"):
    """Emit a function ``(tables, params=None) -> result`` (a Table or a
    dict of tensors), or ``-> (result, ExecutionReport)`` with
    ``with_report=True``.  ``compiled.explain(tables)`` renders the
    physical plan the call would run (``physical.explain``).

    ``compiled(tables, params)`` is ``compiled.bind(tables)(params)``:
    ``bind`` lowers the plan for those tables and places them on the
    device once (the port's counterpart of a trace), and the runner it
    returns only executes, so calls of one runner skip the lowering, the
    padding and the copies (:mod:`repro_torch.db.serving` keeps runners).

    ``canonical_chunks`` is the fixed accumulation grid of every pass;
    ``cf_budget_elems`` bounds the live exact-CF state elements of a
    ``GroupAgg(method="exact")`` node (log-abs and angle of every exact
    aggregate), above which the pass runs over frequency slabs.  A plan
    over device Tables runs where they live.

    Mesh execution: with ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`,
    one per rank) the plan lowers to the sharded physical plan and every
    rank runs it: each rank is given the same global tables, works on its
    contiguous row block of the shard-padded tables (:func:`shard_capacity`)
    over the ``data_axes`` ranks, exchanges through
    :mod:`repro_torch.db.distributed`, and returns the replicated result,
    the same bits as ``mesh=None`` for any data-rank count.  With a
    ``model_axis`` of more than one rank, each grouped exact-CF slab is
    also split into per-model-rank frequency windows and gathered back.
    ``join_gather_budget`` caps the FK-join build rows that may be
    gathered; larger build sides hash-exchange (ShuffleJoin), and a GROUP
    BY on the probe join key may take the co-partitioned pipeline
    (CoPartitionedJoin + PartitionedAgg; ``copartition`` True / "auto"
    (the costs choose) / False).  ``agg_shuffle_budget`` makes single-key
    aggregations over more rows Repartition to their group owners.  A
    PartitionedAgg owner runs the whole canonical chunk grid (its own rows
    at their global positions, every other row p = 0), so the pipeline
    does ranks x the accumulate work of one device; ``copartition``
    therefore defaults to False here (the JAX package's default is
    "auto").  ``cost_model`` replaces the
    knob-derived :class:`repro_torch.db.cost.CostModel`.  Exchange bucket
    capacities come from the concrete ``key % n_shards`` histogram of the
    global tables (every rank computes the same, with no collective), or
    of ``stats_tables`` when given (name -> Table or HostTable: stale
    stats can overflow, which NaN-poisons the join and shows in the
    report); keys computed on the way are sized at ``shuffle_slack`` times
    the uniform share.  ``shuffle_bucket_floor`` raises every bucket to at
    least that many rows (the retry controller's escalation).

    Out-of-core execution: ``device_row_budget`` caps the resident rows of
    any one base table per rank.  A Scan over the budget lowers to
    :class:`repro_torch.db.physical.StreamedScan` and its table stays on
    the host (pass a :class:`repro_torch.db.table.HostTable`; a Table is
    pulled to the host).  The aggregation pass above that scan then runs
    as WAVES: each ships one chunk-aligned slab to ``device`` (the card by
    default; a mesh's device, where each rank ships only its own run of
    chunk slots) and files its per-canonical-chunk UDA states into a
    :class:`repro_torch.core.uda.ChunkStateAccumulator`; the canonical
    fold runs once after the last wave, so the result is the same bits as
    the resident compile for any wave size.  On the card a worker thread
    cuts slab w+1 into a pinned buffer and copies it on a side stream
    while wave w runs, through two buffers, so the device holds two slabs
    plus the group-level state; ``stream_double_buffer=False`` serialises
    cut, copy and compute (the control).  ``stream_wave_chunks`` pins the
    wave size (chunk slots per wave); ``stream_prune_columns`` (default
    on) ships only the columns the plan above the scan reads and widens
    the waves to match.  Resident tables, and HostTables that do not
    stream, are materialised on ``device``.  ``stream_wave_retries`` bounds
    the in-place re-ships of a faulted slab copy before the
    :class:`~repro_torch.testing.faults.TransferFault` propagates,
    annotated with the halved wave size for :func:`run_plan`; completed
    waves are never re-streamed.  Only the tables the plan scans are
    materialised.

    ``with_report=True`` also returns an
    :class:`~repro_torch.db.report.ExecutionReport`: per-exchange overflow,
    demand and capacity, group-code-table overflow, per-MIN/MAX truncation
    mass and NaN counts of the folded states of every pass, and wave
    progress of a streamed run (the same on every rank).  Without it no
    diagnostic is computed."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    chunks = canonical_chunks
    if chunks <= 0:
        raise ValueError(f"canonical_chunks must be positive, got {chunks}")
    names = dist._data_axes(mesh, data_axes) if mesh is not None else ()
    ax = mesh.axis(names) if names else None
    shards = ax.size if ax is not None else 1
    rank = dist.data_rank(ax)
    model = dist._model_axis(mesh, model_axis) if mesh is not None else None
    max_ax = mesh.axis(model) if model else None
    model_size = max_ax.size if max_ax is not None else 1
    model_rank = mesh.coords[model] if model else 0
    local_chunks = -(-chunks // shards)
    # this rank's real chunk slots (slots past the grid only pad)
    real_local = max(0, min(local_chunks, chunks - rank * local_chunks))
    needed_params = plan_params(root)
    sweep_demand: dict = {}

    def demand(fn):
        """The columns the plan reads above the node of ``fn`` (a batched
        sweep's point join there carries only these; None: all)."""
        if not sweep_demand:
            sweep_demand["at"] = {}
            phys.required_scan_columns(root, at=sweep_demand["at"])
        return sweep_demand["at"].get(id(fn))
    if stats_tables:
        # Host-side stand-ins for the bucket sizing, padded as the
        # runtime tables are.
        stats_tables = {
            k: (st if isinstance(st, HostTable)
                else HostTable.from_table(st)).pad_to_multiple(chunks)
            .pad_to(shard_capacity(st.capacity, chunks, shards))
            for k, st in stats_tables.items()}
    def make_runner(tables: Dict[str, Table], caps: dict,
                    rb: ReportBuilder | None = None,
                    params: dict | None = None):
        """Bind the physical-plan interpreter to one dict of tables (this
        rank's blocks on a mesh) and the canonical capacities ``caps`` of
        the binding that runs it.  The streamed executor binds the SAME
        interpreter to every wave's slab (the StreamedScan resolves to the
        slab), so resident and streamed execution share one code path
        below the aggregation.  ``params`` may be a
        :class:`repro_torch.db.sweep.Points` batch (a batched sweep: the
        parameterized nodes join their input with the points)."""
        points = params if isinstance(params, sweep.Points) else None

        def sharded(t: Table) -> bool:
            return ax is not None and isinstance(t.part, phys.RowBlocked)

        def hash_partitioned(t: Table) -> bool:
            return ax is not None and isinstance(t.part,
                                                 phys.HashPartitioned)

        def rel_group_ids(t: Table, keys, mg):
            if sharded(t) or hash_partitioned(t):
                return dist.group_ids_sharded(t, list(keys), mg, ax)
            return ops.group_ids(t, list(keys), mg)

        def width(t: Table) -> int:
            """Rows of ``t`` a canonical row stands for: a swept
            relation's N points, else 1."""
            return points.n if points is not None and sweep.is_swept(t) \
                else 1

        #: the points an exchange holds to one point's buckets each
        n_points = points.n if points is not None else 1

        def probe_side(lt: Table, rt: Table) -> Table:
            """A join's probe side, joined with the points when only the
            build side is swept (pair (r, j) at row r * N + j)."""
            if width(rt) > 1 and width(lt) == 1:
                return sweep.point_join(lt, points, None)
            return lt

        def fk_join(lt: Table, rt: Table, node) -> Table:
            if width(rt) > 1:
                return sweep.fk_join(lt, rt, node.left_key, node.right_key,
                                     node.right_cols, points.n)
            return ops.fk_join(lt, rt, node.left_key, node.right_key,
                               list(node.right_cols))

        def rel_key_columns(t: Table, keys, ids, mg):
            if sharded(t) or hash_partitioned(t):
                return dist.group_key_columns_sharded(t, keys, ids, mg, ax)
            return ops.group_key_columns(t, keys, ids, mg)

        def run_agg(node: phys.MergeAgg):
            """Group ids, then per frequency slab one chunked Accumulate
            and its Merge (the canonical fold; on a mesh
            ``allgather_merge`` for a row-partitioned pass,
            ``partitioned_merge`` for a hash-partitioned one), then the
            Finalize selected by ``kind``."""
            pa = node.child
            t = run(pa.child)
            swept = width(t) > 1
            if swept:       # (group, point) groups, g * N + j
                ids, gvalid, lost = sweep.group_ids(
                    t, pa.keys, pa.max_groups, points.n,
                    ax if sharded(t) or hash_partitioned(t) else None,
                    laid_out=not hash_partitioned(t),
                    count_lost=rb is not None)
                pa = dataclasses.replace(
                    pa, max_groups=pa.max_groups * points.n)
            mg = pa.max_groups
            if not swept:
                ids, merged, gvalid = rel_group_ids(t, pa.keys, mg)
            label = rb.begin_agg(node.kind) if rb is not None else ""
            if rb is not None:
                if not swept:
                    code_live, big = ops.live_key_codes(t, list(pa.keys))
                    lost = _lost_group_count(code_live, big, merged, ids)
                if sharded(t) or hash_partitioned(t):
                    # each rank counted its own rows (a replicated input
                    # counts every row on every rank: no sum)
                    lost = dist.psum(lost, ax)
                rb.group_overflow(label, lost)
            values = _pass_values(pa.specs, t)
            probs, acc_ids = t.masked_prob(), ids
            nslots, real = chunks, chunks
            if hash_partitioned(t):
                # The owner's rows at their canonical positions: the same
                # chunked accumulate as mesh=None for its own groups.
                probs, values, acc_ids = dist.chunk_columns(
                    probs, values, ids, t[phys.CHUNK_COL], t[dist.ROW_COL],
                    t.valid,
                    chunk_size=_canonical_rows(pa.child, caps) * width(t)
                    // chunks, num_chunks=chunks, max_groups=mg)
            elif sharded(t):
                nslots, real = local_chunks, real_local
            exact_names, slabs = _pass_slabs(pa, cf_budget_elems)
            # a swept block holds BLOCK rows of every point, as a block of
            # the reference's vmapped lane does
            block = uda.BLOCK * (points.n if swept else 1)
            rows = real * (probs.shape[0] // nslots)
            mirrored = model_size > 1 and _mirrored(
                pa, exact_names, slabs, probs[:probs.shape[0] // nslots],
                values)
            cf_operands = _cf_operands(pa, exact_names, slabs, probs[:rows],
                                       values, acc_ids[:rows], real) \
                if real else {}
            udas: dict = {}
            states: dict = {}
            for si, (lo, cnt) in enumerate(slabs):
                udas_i, vals_i = _slab_udas(pa, si, lo, cnt, values,
                                            model_rank, model_size, mirrored)
                if sharded(t) or hash_partitioned(t):
                    parts = _chunk_parts(udas_i, probs, vals_i, acc_ids,
                                         mg, real, nslots,
                                         cf_operands or None, block)
                    sts = (dist.allgather_merge(udas_i, parts, ax, chunks,
                                                shards) if sharded(t)
                           else dist.partitioned_merge(udas_i, parts, ax,
                                                       shards))
                else:
                    sts = uda.accumulate_chunked(
                        udas_i, probs, vals_i, acc_ids, max_groups=mg,
                        num_chunks=chunks, cf_operands=cf_operands or None,
                        block=block)
                sts = _gather_model_slabs(udas_i, sts, exact_names, cnt,
                                          max_ax, mg == 1, mirrored)
                _append_slab(states, udas, udas_i, sts)
            for name in exact_names:            # full-range Finalize UDA
                udas[name] = _agg_uda("SUM", "exact", pa.kappa, pa.num_freq)
            key_columns = lambda cols: rel_key_columns(t, cols, ids, mg)
            fin_params = params
            if points is not None and not swept \
                    and isinstance(node.threshold, Param):
                # a swept threshold over unswept states: every point
                # compares its own threshold with the same states
                states = {k: sweep.expand_state(st, points.n)
                          for k, st in states.items()}
                gvalid = sweep.expand(gvalid, points.n)
                key_columns = lambda cols: {
                    k: sweep.expand(v, points.n)
                    for k, v in rel_key_columns(t, cols, ids, mg).items()}
                swept = True
            if swept:
                fin_params = points.per_group(gvalid.shape[0] // points.n)
            out = _finalize_pass(node, pa, udas, states, gvalid,
                                 key_columns, rb=rb, label=label,
                                 params=fin_params,
                                 n_points=points.n if swept else None)
            return sweep.mark(out, points.n) if swept else out

        def run(node: phys.PhysNode):
            if isinstance(node, (phys.ShardScan, phys.StreamedScan)):
                # A StreamedScan resolves here only in a wave, which binds
                # the scan's name to the wave's slab.
                return tables[node.name].with_part(node.part)
            if isinstance(node, phys.PhysSelect):
                pred = node.pred
                if isinstance(pred, Parameterized) and points is not None:
                    t = run(node.child)
                    mask = sweep.per_point(t, points, pred)
                    if sweep.is_swept(t):
                        return t.with_valid(t.valid & mask)
                    return sweep.point_join(t, points, demand(pred), mask)
                if isinstance(pred, Parameterized):
                    return ops.select(run(node.child),
                                      lambda t: pred(t, params))
                return ops.select(run(node.child), pred)
            if isinstance(node, phys.PhysMap):
                t = run(node.child)
                fn = node.fn
                if isinstance(fn, Parameterized) and points is not None:
                    col = sweep.per_point(t, points, fn)
                    if not sweep.is_swept(t):
                        t = sweep.point_join(t, points, demand(fn))
                    return t.with_column(node.name, col)
                col = fn(t, params) if isinstance(fn, Parameterized) \
                    else fn(t)
                return t.with_column(node.name, col)
            if isinstance(node, phys.GatherJoin):
                lt, rt = run(node.left), run(node.right)
                lt = probe_side(lt, rt)
                if sharded(rt):
                    # the small build side, gathered: key + carried cols
                    # (+ a swept side's points)
                    keep = (node.right_key,) + tuple(node.right_cols)
                    if width(rt) > 1:
                        keep += (sweep.POINT,)
                    rt = dist.gather_table(rt.select_columns(
                        dict.fromkeys(keep)), ax)
                return fk_join(lt, rt, node)
            if isinstance(node, phys.ShuffleJoin):
                lt, rt = run(node.left), run(node.right)
                lt = probe_side(lt, rt)
                lbl = rb.begin_exchange("shuffle_join") if rb else ""
                return dist.shuffle_fk_join(
                    lt, rt, node.left_key, node.right_key,
                    list(node.right_cols), ax, n_shards=shards,
                    build_bucket=node.build_bucket,
                    probe_bucket=node.probe_bucket, report=rb, label=lbl,
                    n_points=n_points)
            if isinstance(node, phys.CoPartitionedJoin):
                lt, rt = run(node.left), run(node.right)
                lt = probe_side(lt, rt)
                lbl = rb.begin_exchange("copart_join") if rb else ""
                return dist.copartitioned_fk_join(
                    lt, rt, node.left_key, node.right_key,
                    list(node.right_cols), list(node.carry_cols), ax,
                    n_shards=shards, build_bucket=node.build_bucket,
                    probe_bucket=node.probe_bucket,
                    chunk_size=_canonical_rows(node.left, caps) * width(lt)
                    // chunks, num_chunks=chunks, report=rb, label=lbl,
                    n_points=n_points)
            if isinstance(node, phys.Repartition):
                t = run(node.child)
                lbl = rb.begin_exchange("repartition") if rb else ""
                return dist.repartition_by_key(
                    t, node.key, list(node.carry_cols), ax,
                    n_shards=shards, bucket=node.bucket,
                    chunk_size=_canonical_rows(node.child, caps) * width(t)
                    // chunks, num_chunks=chunks, report=rb, label=lbl,
                    n_points=n_points)
            if isinstance(node, phys.MergeAgg):
                return run_agg(node)
            raise TypeError(node)

        return run, sharded

    def interpret(tables: Dict[str, Table], proot, caps: dict, rb=None,
                  params=None):
        """Run a physical plan on one dict of tables; a row-partitioned
        Table result is gathered and cut to its mesh=None capacity."""
        run, sharded = make_runner(tables, caps, rb, params)
        out = run(proot)
        if isinstance(out, Table):
            if sharded(out):
                out = dist.gather_table(out, ax)
                n = _canonical_rows(proot, caps)
                if isinstance(params, sweep.Points) and sweep.is_swept(out):
                    n *= params.n
                out = Table({k: v[:n] for k, v in out.columns.items()},
                            out.prob[:n], out.valid[:n], out.part)
            out = out.with_part(phys.Replicated())
        return out

    # ------------------------------------------------- streamed execution
    def _stream(ht: HostTable, sched, dev: torch.device, wave_call,
                collect) -> int:
        """The wave loop over one streamed table: ship slab w, run
        ``wave_call(w, slab)``, file the output with ``collect(w, out)``.
        On a mesh each rank ships only its own run of the wave: rank r's
        chunk slots start at row r * n_waves * lcpw * csz.

        A slab is cut into one of two host buffers (``np.copyto`` through
        the buffer's numpy view; pinned when ``dev`` is the card) and, on
        the card, copied into one of two device buffers allocated once per
        loop.  Double-buffered (the default), one worker thread ships slab
        w+1 (cut, then copy on a side stream, then an event) while the
        caller's thread runs wave w; the current stream waits on the
        copy's event before wave w+1.  Before the worker reuses buffer
        pair (w+1) % 2 it waits for wave w-1's work to complete (an event
        on the current stream): that wave was the pair's last reader, so
        at most two slabs are in flight.  ``stream_double_buffer=False``
        ships, computes and synchronises each wave in turn on the caller's
        thread.  On the CPU the host buffer is the slab.

        Fault tolerance: each slab ship passes through
        ``testing.faults.on_transfer`` first; a :class:`~repro_torch.
        testing.faults.TransferFault` re-ships the SAME wave up to
        ``stream_wave_retries`` times.  Only waves not yet filed are ever
        shipped, so no wave is re-streamed or filed twice; a fault that
        survives the retries reaches the caller (after wave w-1 is filed)
        annotated with the halved wave size for :func:`run_plan`.  Returns
        the number of re-ships."""
        lrows = sched.local_chunks_per_wave * sched.chunk_rows
        base = rank * sched.n_waves * lrows
        cuda = dev.type == "cuda"
        hbufs = (ht.alloc_slab(lrows, dev), ht.alloc_slab(lrows, dev))
        dbufs = [Table({k: torch.empty_like(v, device=dev)
                        for k, v in b.columns.items()},
                       torch.empty_like(b.prob, device=dev),
                       torch.empty_like(b.valid, device=dev), b.part)
                 for b in hbufs] if cuda else hbufs
        wave_bytes = sum(x.numel() * x.element_size()
                         for x in _slab_tensors(hbufs[0]))
        side = None
        if cuda and stream_double_buffer:
            side = torch.cuda.Stream(dev)
            # The device buffers come from the current stream's pool: the
            # side stream's first copies must follow its queued work.
            side.wait_stream(torch.cuda.current_stream(dev))
        copies: list = []
        n_retries = 0

        def ship(w, gate):
            if gate is not None:
                gate.synchronize()
            faults.on_transfer(w, lrows * shards)
            t0 = time.perf_counter()
            slab = ht.wave_slab((base + w * lrows,), lrows,
                                out=hbufs[w % 2])
            _STREAM_STATS["slice_s"] += time.perf_counter() - t0
            _STREAM_STATS["slab_bytes"] += wave_bytes
            _STREAM_STATS["waves"] += 1
            if not cuda:
                return slab, None
            stream = side or torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                start.record(stream)
                for dst, src in zip(_slab_tensors(dbufs[w % 2]),
                                    _slab_tensors(slab)):
                    dst.copy_(src, non_blocking=True)
                done.record(stream)
            copies.append((start, done))
            return dbufs[w % 2], done

        def try_ship(w, gate=None):
            nonlocal n_retries
            for attempt in range(stream_wave_retries + 1):
                try:
                    return ship(w, gate)
                except faults.TransferFault as e:
                    if attempt == stream_wave_retries:
                        e.wave_chunks = C.halved_wave_chunks(sched)
                        e.at_minimum = sched.local_chunks_per_wave == 1
                        raise
                    n_retries += 1

        def run_wave(w, shipped):
            slab, done = shipped
            if done is not None:
                torch.cuda.current_stream(dev).wait_event(done)
            out = wave_call(w, slab)
            finished = None
            if cuda:
                finished = torch.cuda.Event()
                finished.record(torch.cuda.current_stream(dev))
            return out, finished

        if not stream_double_buffer:
            for w in range(sched.n_waves):
                shipped = try_ship(w)
                if cuda:
                    shipped[1].synchronize()
                out, finished = run_wave(w, shipped)
                if cuda:
                    finished.synchronize()
                collect(w, out)
        else:
            with ThreadPoolExecutor(max_workers=1) as pool:
                nxt = pool.submit(try_ship, 0)
                finished = None
                for w in range(sched.n_waves):
                    shipped = nxt.result()
                    if w + 1 < sched.n_waves:
                        nxt = pool.submit(try_ship, w + 1, finished)
                    out, finished = run_wave(w, shipped)
                    collect(w, out)
        if copies:
            copies[-1][1].synchronize()
            _STREAM_STATS["copy_s"] += sum(
                a.elapsed_time(b) for a, b in copies) / 1e3
        return n_retries

    def _streamed_exec(proot, resident, host, dev: torch.device,
                       rb: ReportBuilder | None, params: dict, caps: dict):
        """Run a physical plan containing a StreamedScan: the lowest
        aggregation pass above the scan executes as waves; any plan suffix
        above that pass runs resident on the pass's group-level output.
        ``resident`` holds this rank's resident tables, ``host`` the
        streamed base table as a HostTable."""
        scans = [n for n in _iter_phys(proot)
                 if isinstance(n, phys.StreamedScan)]
        if len(scans) > 1:
            raise NotImplementedError(
                "one StreamedScan per plan: raise device_row_budget so at "
                f"most one table streams (got {[s.name for s in scans]})")
        sc = scans[0]
        agg = _lowest_streamed_agg(proot)
        if agg is None:
            raise NotImplementedError(
                "a StreamedScan must feed a grouped aggregation (Project /"
                " GroupAgg / ReweightGreater): the wave loop folds "
                "per-chunk UDA states, not raw relational output — raise "
                "device_row_budget so the table stays resident, or "
                "materialise it first via HostTable.to_table()")
        pa = agg.child
        sched = sc.schedule
        ht = host[sc.name].pad_to(sched.padded_capacity)
        if sc.columns is not None:
            # Required-column pruning: slabs carry only the demand set the
            # lowering recorded (plus prob/valid, always).
            ht = ht.select_columns([c for c in sc.columns
                                    if c in ht.columns])
        mg = pa.max_groups
        keys = list(pa.keys)
        kcols = list(pa.keys)
        if agg.kind == "reweight":
            kcols += [c for c in agg.carry_cols if c not in kcols]
            if agg.threshold_col and agg.threshold_col not in kcols:
                kcols.append(agg.threshold_col)
        exact_names, slabs = _pass_slabs(pa, cf_budget_elems)
        lcpw = sched.local_chunks_per_wave
        lslots = sched.n_waves * lcpw

        def spine(slab: Table) -> Table:
            return make_runner({**resident, sc.name: slab}, caps,
                               params=params)[0](pa.child)

        # Phase A: stream once for the global group-code table.  Merging
        # the per-wave (and per-rank) tables of the max_groups smallest
        # codes keeps the max_groups smallest overall: the resident table,
        # bit for bit.
        code_tabs: list = [None] * sched.n_waves

        def wave_a(w, slab):
            code_live, _ = ops.live_key_codes(spine(slab), keys)
            local = ops.merge_group_codes(code_live, mg)
            if ax is not None:
                local = ops.merge_group_codes(dist.all_gather(local, ax), mg)
            return local

        retries = _stream(ht, sched, dev, wave_a,
                          lambda w, out: code_tabs.__setitem__(w, out))
        merged = ops.merge_group_codes(torch.cat(code_tabs), mg)
        gvalid = merged != ops.BIG

        # Phase B: stream again, filing every wave's per-chunk states
        # under their global canonical chunk ids; the canonical fold runs
        # once after the last wave.
        dummy_vals = {s[0]: None for s in pa.specs}
        slab_udas = [_slab_udas(pa, si, lo, cnt, dummy_vals)[0]
                     for si, (lo, cnt) in enumerate(slabs)]
        accs = [uda.ChunkStateAccumulator(u, chunks) for u in slab_udas]
        gcols_run: dict = {}
        lost_waves: list = []

        def wave_b(w, slab):
            t = spine(slab)
            code_live, big = ops.live_key_codes(t, keys)
            ids = ops.codes_to_ids(code_live, merged)
            lost = (_lost_group_count(code_live, big, merged, ids)
                    if rb is not None else None)
            if lost is not None and ax is not None:
                lost = dist.psum(lost, ax)
            # Chunk slots past the canonical grid only pad the schedule
            # (invalid rows): they get init states, and launch no kernel.
            real = max(0, min(lcpw, chunks - rank * lslots - w * lcpw))
            probs = t.masked_prob()
            values = _pass_values(pa.specs, t)
            cf_operands = _cf_operands(
                pa, exact_names, slabs, probs[:real * sched.chunk_rows],
                values, ids[:real * sched.chunk_rows], real) if real else {}
            mirrored = model_size > 1 and _mirrored(
                pa, exact_names, slabs, probs[:sched.chunk_rows], values)
            out_states = []
            for si, (lo, cnt) in enumerate(slabs):
                udas_i, vals_i = _slab_udas(pa, si, lo, cnt, values,
                                            model_rank, model_size, mirrored)
                parts = _chunk_parts(udas_i, probs, vals_i, ids, mg, real,
                                     lcpw, cf_operands or None)
                parts = [_gather_model_slabs(udas_i, p, exact_names, cnt,
                                             max_ax, mg == 1, mirrored)
                         for p in parts]
                if ax is not None:
                    parts = dist.gather_chunk_states(udas_i, parts, ax)
                out_states.append(parts)
            gcols = ops.group_key_columns(t, kcols, ids, mg)
            if ax is not None:
                gcols = {k: dist.pmax(v, ax) for k, v in gcols.items()}
            return out_states, gcols, lost

        def collect_b(w, out):
            out_states, gcols, lost = out
            slot_ids = [s * lslots + w * lcpw + j
                        for s in range(shards) for j in range(lcpw)]
            for acc, parts in zip(accs, out_states):
                acc.add_wave(slot_ids, parts)
            if lost is not None:
                lost_waves.append(lost)
            for k, v in gcols.items():
                # Per-group key representatives: the segment-max identity
                # fills absent groups, so a max across waves is exact.
                gcols_run[k] = (v if k not in gcols_run
                                else torch.maximum(gcols_run[k], v))

        retries += _stream(ht, sched, dev, wave_b, collect_b)

        label = rb.begin_agg(agg.kind) if rb is not None else ""
        if rb is not None:
            rb.group_overflow(label, sum(lost_waves))
            rb.set_waves(completed=2 * sched.n_waves,
                         total=2 * sched.n_waves, retries=retries)
        udas: dict = {}
        states: dict = {}
        for u, acc in zip(slab_udas, accs):
            _append_slab(states, udas, u, acc.fold())
        for name in exact_names:                # full-range Finalize UDA
            udas[name] = _agg_uda("SUM", "exact", pa.kappa, pa.num_freq)
        result = _finalize_pass(
            agg, pa, udas, states, gvalid,
            lambda cols: {k: gcols_run[k] for k in cols},
            rb=rb, label=label, params=params)
        if agg is proot:
            return result
        # Plan suffix above the streamed pass: re-inject the group-level
        # Table as a scan and run the rest resident.
        outer = _swap_node(proot, agg,
                           phys.ShardScan(_STREAMED_RESULT,
                                          phys.Replicated(),
                                          result.capacity))
        return interpret({**resident, _STREAMED_RESULT: result}, outer,
                         {**caps, _STREAMED_RESULT: result.capacity}, rb,
                         params)

    def lower(tables: Dict[str, Table], place: Placement | None = None):
        """(physical plan, padded tables, canonical capacities) of one
        binding: every base table padded to the canonical chunk grid (a
        HostTable virtually; on a mesh to the shard capacity, as a view;
        a device Table by a copy, shared through ``place`` when given)
        -- the chunk boundaries define the deterministic fold tree -- and
        the chunk-grid-only capacities (the rows a relational result has
        under mesh=None)."""
        def pad(name, t):
            if ax is None:
                if (place is None or isinstance(t, HostTable)
                        or t.capacity % chunks == 0):
                    return t.pad_to_multiple(chunks)
                return place.get(name, t, ("grid", chunks), t.device,
                                 lambda: t.pad_to_multiple(chunks))
            cap = shard_capacity(t.capacity, chunks, shards)
            if isinstance(t, HostTable):
                return t.pad_to_multiple(chunks).pad_to(cap)
            return _PaddedView(t, cap)
        padded = {k: pad(k, t) for k, t in tables.items()}
        caps = {k: -(-t.capacity // chunks) * chunks
                for k, t in tables.items()}
        plan_tables = dict(padded)
        for k, st in (stats_tables or {}).items():
            if k in padded:
                plan_tables[k] = st
        proot = phys.lower_plan(
            root, {k: t.capacity for k, t in padded.items()},
            n_shards=shards, sharded=ax is not None,
            join_gather_budget=join_gather_budget,
            shuffle_slack=shuffle_slack, copartition=copartition,
            agg_shuffle_budget=agg_shuffle_budget, canonical_chunks=chunks,
            model=cost_model, tables=plan_tables,
            device_row_budget=device_row_budget,
            stream_wave_chunks=stream_wave_chunks,
            stream_prune_columns=stream_prune_columns,
            bucket_floor=shuffle_bucket_floor, model_shards=model_size)
        return proot, padded, caps

    def check_params(params: dict | None) -> dict:
        env = dict(params or {})
        missing = needed_params - env.keys()
        extra = env.keys() - needed_params
        if missing or extra:
            raise ValueError(
                f"plan parameters mismatch: missing {sorted(missing)}, "
                f"unexpected {sorted(extra)} (plan needs "
                f"{sorted(needed_params)})")
        return env

    def bind(tables: Dict[str, Table], placement: Placement | None = None):
        """Lower the plan for ``tables`` and place its resident tables on
        the device, once: returns a runner ``(params=None) -> result``
        (``(result, report)`` with ``with_report``) that only executes.
        The lowering reads the tables' sizes and, on a mesh, their key
        histograms, so a runner is valid only for these table objects.
        ``placement`` shares the copies (a table padded to the chunk
        grid, a HostTable materialised, a table pulled to the host for
        streaming, a mesh rank's block) with other bindings of the same
        catalogue; the runner holds only the tables its plan scans."""
        place = placement if placement is not None else Placement()
        proot, padded, caps = lower(tables, place)
        scanned = {n.name: n for n in _iter_phys(proot)
                   if isinstance(n, (phys.ShardScan, phys.StreamedScan))}
        streamed = any(isinstance(n, phys.StreamedScan)
                       for n in scanned.values())
        dev = mesh.device if mesh is not None else None
        host: dict = {}
        if mesh is None and not streamed and not any(
                isinstance(t, HostTable) for t in padded.values()):
            # device Tables run where they live
            resident = {name: padded[name] for name in scanned}
        else:
            dev = dev or _target(device)
            resident = {}
            for name, node in scanned.items():
                src = tables[name]
                if not isinstance(node, phys.ShardScan):
                    host[name] = src if isinstance(src, HostTable) else \
                        place.get(name, src, ("host",), "cpu",
                                  lambda src=src: HostTable.from_table(src))
                elif ax is None:
                    t = padded[name]
                    resident[name] = place.get(
                        name, src, (0, t.capacity), dev,
                        lambda t=t: _on_device(t, dev))
                else:               # this rank's block
                    rows = padded[name].capacity // shards
                    resident[name] = place.get(
                        name, src, (rank * rows, rows), dev,
                        lambda src=src, rows=rows: _block(src, rank * rows,
                                                          rows, dev))

        def runner(params: dict | None = None):
            env = check_params(params)
            rb = ReportBuilder() if with_report else None
            if streamed:
                out = _streamed_exec(proot, resident, host, dev, rb, env,
                                     caps)
                if isinstance(out, Table):
                    out = out.with_part(phys.Replicated())
            else:
                out = interpret(resident, proot, caps, rb, env)
            return (out, rb.build()) if with_report else out

        def sweep_runner(batch: dict):
            """Every point of ``batch`` (name -> length-N tensor) in one
            batched pass (:mod:`repro_torch.db.sweep`); every leaf of the
            result gains a leading N axis, and so does every value of the
            report (``with_report``: a stacked ExecutionReport, point j's
            counts at index j).  Resident plans only; on a mesh, the same
            bits as ``mesh=None``."""
            if streamed:
                raise NotImplementedError(
                    "a batched sweep runs a resident plan: drop "
                    "device_row_budget")
            check_params(batch)
            points = sweep.Points(batch)
            rb = ReportBuilder(points.n) if with_report else None
            out = sweep.unstack(interpret(resident, proot, caps, rb,
                                          points), points.n)
            return (out, rb.build()) if with_report else out

        runner.sweep = sweep_runner
        return runner

    def compiled(tables: Dict[str, Table], params: dict | None = None):
        check_params(params)
        return bind(tables)(params)

    compiled.bind = bind
    compiled.explain = lambda tables: phys.explain(lower(tables)[0])
    return compiled


# ======================================================================
# the escalating retry controller
# ======================================================================
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How :func:`run_plan` escalates when a run's
    :class:`~repro_torch.db.report.ExecutionReport` shows a problem.

    max_attempts   total compile+run attempts (first run included)
    tail_tol       largest acceptable per-group MIN/MAX §V-B.2
                   truncation mass; above it kappa doubles
    wave_retries   in-place re-ships of a faulted slab copy before the
                   streamed executor gives the fault back to the
                   controller (which then halves the wave size)
    """
    max_attempts: int = 3
    tail_tol: float = 0.0
    wave_retries: int = 2


class RetryExhausted(RuntimeError):
    """The retry ladder ran out of attempts with issues outstanding; the
    last run's report is attached for diagnosis."""

    def __init__(self, msg: str, report=None):
        super().__init__(msg)
        self.report = report


def _scale_plan(node: Node, kappa_scale: int, groups_scale: int) -> Node:
    """Rebuild the logical DAG with every GroupAgg kappa (and, on group
    overflow, every grouped node's max_groups) scaled; a scale of 1
    returns the node unchanged (the same object)."""
    reb: dict = {}
    for f in ("child", "left", "right"):
        c = getattr(node, f, None)
        if isinstance(c, Node):
            nc = _scale_plan(c, kappa_scale, groups_scale)
            if nc is not c:
                reb[f] = nc
    if isinstance(node, GroupAgg) and kappa_scale != 1:
        reb["kappa"] = node.kappa * kappa_scale
    if groups_scale != 1 and isinstance(node, (GroupAgg, Project,
                                               ReweightGreater)):
        reb["max_groups"] = node.max_groups * groups_scale
    return dataclasses.replace(node, **reb) if reb else node


def _default_compiler(root: Node, mesh=None, **opts):
    """The retry controller's default compile hook: a fresh
    ``compile_plan`` per attempt (a serving layer passes its plan cache
    here instead)."""
    return compile_plan(root, mesh, **opts)


def run_plan(root: Node, tables: Dict[str, Table], mesh=None, *,
             policy: RetryPolicy | None = None, params: dict | None = None,
             compiler=None, kappa_scale: int = 1, groups_scale: int = 1,
             **opts):
    """Run a logical plan under the self-healing retry loop: compile
    (``compile_plan(..., with_report=True)``), run, diagnose the
    :class:`~repro_torch.db.report.ExecutionReport`, and re-lower with
    escalated parameters until the run is clean (or ``policy.
    max_attempts`` is spent: :class:`RetryExhausted`).  Escalations:

    * exchange overflow (a mesh compile whose ``stats_tables`` sized a
      bucket below the real demand) -> ``shuffle_bucket_floor`` = the
      observed peak per-(sender, owner) send demand, which makes the
      retry overflow-free, and ``shuffle_slack`` doubled (capped at the
      data-rank count, where no bucket can overflow);
    * truncation tail mass above ``policy.tail_tol`` -> kappa doubled;
    * group-code-table overflow -> max_groups doubled;
    * a transfer fault surviving the in-loop wave retries -> wave size
      halved (``stream_wave_chunks``).

    NaN counts without an exchange overflow mean the NaN came in with the
    data: nothing to escalate, and the result returns with the report
    flagging it.

    Returns ``(result, report)``; ``report.final_params`` records the
    final attempt's overrides and ``report.waves["attempts"]`` the attempt
    count.  Every attempt is a fresh compile at its own parameters, so the
    converged result is the same bits as a first run launched with
    ``final_params``.  ``compiler`` replaces the per-attempt compile
    (``compiler(root, mesh, **opts) -> fn``); ``kappa_scale`` /
    ``groups_scale`` seed the ladder."""
    policy = policy or RetryPolicy()
    compiler = compiler or _default_compiler
    opts = dict(opts)
    slack = float(opts.pop("shuffle_slack", 4.0))
    floor = opts.pop("shuffle_bucket_floor", None)
    wave_chunks = opts.pop("stream_wave_chunks", None)
    n_shards = 1
    if mesh is not None:
        for a in dist._data_axes(mesh, opts.get("data_axes", ("data",))):
            n_shards *= mesh.shape[a]
    out = report = None
    attempt = 0
    for attempt in range(1, policy.max_attempts + 1):
        fn = compiler(_scale_plan(root, kappa_scale, groups_scale), mesh,
                      with_report=True, shuffle_slack=slack,
                      shuffle_bucket_floor=floor,
                      stream_wave_chunks=wave_chunks,
                      stream_wave_retries=policy.wave_retries, **opts)
        try:
            out, report = fn(tables, params)
        except faults.TransferFault as e:
            if (e.wave_chunks is None or e.at_minimum
                    or attempt == policy.max_attempts):
                raise
            wave_chunks = e.wave_chunks
            continue
        issues = report.issues(policy.tail_tol)
        if not any(k != "nan" for k in issues):
            break
        if attempt == policy.max_attempts:
            raise RetryExhausted(
                f"unresolved after {attempt} attempts: "
                f"{report.describe(policy.tail_tol)}", report)
        if "overflow" in issues:
            demand = report.host_values()["exchange_demand"]
            floor = max(floor or 0,
                        max(demand[k] for k in issues["overflow"]))
            slack = C.escalated_slack(slack, n_shards)
        if "tail" in issues:
            kappa_scale *= 2
        if "group_overflow" in issues:
            groups_scale *= 2

    report.final_params.update(
        shuffle_slack=slack, shuffle_bucket_floor=floor,
        stream_wave_chunks=wave_chunks, kappa_scale=kappa_scale,
        groups_scale=groups_scale)
    report.waves["attempts"] = attempt
    return out, report
