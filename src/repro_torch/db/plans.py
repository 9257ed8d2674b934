"""Probabilistic -> deterministic plan compilation (paper §VI, Table I;
port of ``repro.db.plans``): the logical plan nodes, the single-device
executor (resident and streamed) and the retry controller.

``compile_plan(root)`` lowers the logical DAG with the copied physical
planner (:func:`repro_torch.db.physical.lower_plan`) and returns a
function ``tables -> result`` that interprets the physical plan eagerly:
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
is clean.  Mesh compiles belong to the multi-rank slice of the port and
raise ``NotImplementedError``.

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
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import torch

from ..core import uda
from ..core.config import resolve_device
from ..testing import faults
from . import cost as C
from . import operators as ops
from . import physical as phys
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


def _agg_uda(agg: str, method: str, kappa: int, num_freq: int = 0,
             freq_lo: int = 0, freq_cnt: int | None = None) -> uda.UDA:
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
        return uda.SumCF(num_freq, freq_lo=freq_lo, freq_cnt=freq_cnt)
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


def _slab_udas(pa, si: int, lo: int, cnt: int, values: dict) -> tuple:
    """UDA dict + value dict of frequency-slab pass ``si``: pass 0 carries
    confidence and every non-exact aggregate; every pass carries the exact
    aggregates' (lo, cnt) frequency window."""
    udas_i: dict = {}
    vals_i: dict = {}
    if si == 0:
        udas_i["confidence"] = uda.AtLeastOne()
        vals_i["confidence"] = None
        for name, _value, agg, method in pa.specs:
            if method != "exact":
                udas_i[name] = _agg_uda(agg, method, pa.kappa)
                vals_i[name] = values[name]
    for name, _value, agg, method in pa.specs:
        if method == "exact":
            udas_i[name] = _agg_uda(agg, method, pa.kappa, pa.num_freq, lo,
                                    cnt)
            vals_i[name] = values[name]
    return udas_i, vals_i


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
                   rb=None, label: str = "", params=None):
    """The epilogue of one aggregation pass, selected by ``node.kind``;
    ``key_columns(cols)`` returns the per-group representatives.  With a
    :class:`ReportBuilder` the pass also files its diagnostics: the NaN
    count of every folded UDA state and the per-group §V-B.2 truncation
    mass of each MIN/MAX aggregate."""
    if rb is not None:
        for name, st in states.items():
            rb.state_nan(f"{label}.{name}", nan_count(st))
        for name, _value, agg, _method in pa.specs:
            if agg in ("MIN", "MAX"):
                rb.tail(f"{label}.{name}",
                        udas[name].tail_mass(states[name]))
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


def compile_plan(root: Node, mesh=None, *,
                 cf_budget_elems: int = 1 << 22,
                 canonical_chunks: int = 8,
                 device_row_budget: int | None = None,
                 stream_wave_chunks: int | None = None,
                 stream_double_buffer: bool = True,
                 stream_prune_columns: bool = True,
                 stream_wave_retries: int = 2,
                 with_report: bool = False,
                 device="cuda",
                 stats_tables=None,
                 shuffle_slack: float | None = None,
                 shuffle_bucket_floor: int | None = None):
    """Emit a function ``(tables, params=None) -> result`` (a Table or a
    dict of tensors), or ``-> (result, ExecutionReport)`` with
    ``with_report=True``.

    ``canonical_chunks`` is the fixed accumulation grid of every pass;
    ``cf_budget_elems`` bounds the live exact-CF state elements of a
    ``GroupAgg(method="exact")`` node (log-abs and angle of every exact
    aggregate), above which the pass runs over frequency slabs.  A plan
    over device Tables runs where they live.

    Out-of-core execution: ``device_row_budget`` caps the resident rows of
    any one base table.  A Scan over the budget lowers to
    :class:`repro_torch.db.physical.StreamedScan` and its table stays on
    the host (pass a :class:`repro_torch.db.table.HostTable`; a Table is
    pulled to the host).  The aggregation pass above that scan then runs
    as WAVES: each ships one chunk-aligned slab to ``device`` (the card by
    default) and files its per-canonical-chunk UDA states into a
    :class:`repro_torch.core.uda.ChunkStateAccumulator`; the canonical
    fold runs once after the last wave, so the result is the same bits as
    the resident compile for any wave size.  On the card a worker thread
    cuts slab w+1 into a pinned buffer and copies it on a side stream
    while wave w runs, through two buffers, so the device holds two slabs
    plus the group-level state; ``stream_double_buffer=False`` serialises
    cut, copy and compute (the control).  ``stream_wave_chunks`` pins the wave
    size (chunk slots per wave); ``stream_prune_columns`` (default on)
    ships only the columns the plan above the scan reads and widens the
    waves to match.  Resident tables, and HostTables that do not stream,
    are materialised on ``device``.  ``stream_wave_retries`` bounds the
    in-place re-ships of a faulted slab copy before the
    :class:`~repro_torch.testing.faults.TransferFault` propagates,
    annotated with the halved wave size for :func:`run_plan`; completed
    waves are never re-streamed.  Only the tables the plan scans are
    materialised.

    ``with_report=True`` also returns an
    :class:`~repro_torch.db.report.ExecutionReport`: group-code-table
    overflow, per-MIN/MAX truncation mass and NaN counts of the folded
    states of every pass, and wave progress of a streamed run.  Without
    it no diagnostic is computed.

    ``mesh``, ``stats_tables``, ``shuffle_slack`` and
    ``shuffle_bucket_floor`` belong to the multi-rank slice of the port
    and raise ``NotImplementedError``."""
    for name, value in (("mesh", mesh), ("stats_tables", stats_tables),
                        ("shuffle_slack", shuffle_slack),
                        ("shuffle_bucket_floor", shuffle_bucket_floor)):
        if value is not None:
            raise NotImplementedError(
                f"compile_plan({name}=...) waits for the multi-rank slice "
                "of the port (torch.distributed)")
    chunks = canonical_chunks
    if chunks <= 0:
        raise ValueError(f"canonical_chunks must be positive, got {chunks}")
    needed_params = plan_params(root)

    def make_runner(tables: Dict[str, Table], rb: ReportBuilder | None = None,
                    params: dict | None = None):
        """Bind the physical-plan interpreter to one dict of tables.  The
        streamed executor binds the SAME interpreter to every wave's slab
        (the StreamedScan resolves to the slab), so resident and streamed
        execution share one code path below the aggregation."""

        def run_agg(node: phys.MergeAgg):
            """Group ids, then per frequency slab one chunked Accumulate
            + canonical fold, then the Finalize selected by ``kind``."""
            pa = node.child
            t = run(pa.child)
            mg = pa.max_groups
            ids, merged, gvalid = ops.group_ids(t, list(pa.keys), mg)
            label = rb.begin_agg(node.kind) if rb is not None else ""
            if rb is not None:
                code_live, big = ops.live_key_codes(t, list(pa.keys))
                rb.group_overflow(label, _lost_group_count(
                    code_live, big, merged, ids))
            values = _pass_values(pa.specs, t)
            exact_names, slabs = _pass_slabs(pa, cf_budget_elems)
            probs = t.masked_prob()
            cf_operands = _cf_operands(pa, exact_names, slabs, probs,
                                       values, ids, chunks)
            udas: dict = {}
            states: dict = {}
            for si, (lo, cnt) in enumerate(slabs):
                udas_i, vals_i = _slab_udas(pa, si, lo, cnt, values)
                _append_slab(states, udas, udas_i, uda.accumulate_chunked(
                    udas_i, probs, vals_i, ids, max_groups=mg,
                    num_chunks=chunks, cf_operands=cf_operands or None))
            for name in exact_names:            # full-range Finalize UDA
                udas[name] = _agg_uda("SUM", "exact", pa.kappa, pa.num_freq)
            return _finalize_pass(
                node, pa, udas, states, gvalid,
                lambda cols: ops.group_key_columns(t, cols, ids, mg),
                rb=rb, label=label, params=params)

        def run(node: phys.PhysNode):
            if isinstance(node, (phys.ShardScan, phys.StreamedScan)):
                # A StreamedScan resolves here only in a wave, which binds
                # the scan's name to the wave's slab.
                return tables[node.name].with_part(node.part)
            if isinstance(node, phys.PhysSelect):
                pred = node.pred
                if isinstance(pred, Parameterized):
                    return ops.select(run(node.child),
                                      lambda t: pred(t, params))
                return ops.select(run(node.child), pred)
            if isinstance(node, phys.PhysMap):
                t = run(node.child)
                fn = node.fn
                col = fn(t, params) if isinstance(fn, Parameterized) \
                    else fn(t)
                return t.with_column(node.name, col)
            if isinstance(node, phys.GatherJoin):
                return ops.fk_join(run(node.left), run(node.right),
                                   node.left_key, node.right_key,
                                   list(node.right_cols))
            if isinstance(node, phys.MergeAgg):
                return run_agg(node)
            raise NotImplementedError(
                f"{type(node).__name__} is a mesh strategy: it waits for the "
                "multi-rank slice of the port")

        return run

    # ------------------------------------------------- streamed execution
    def _stream(ht: HostTable, sched, dev: torch.device, wave_call,
                collect) -> int:
        """The wave loop over one streamed table: ship slab w, run
        ``wave_call(w, slab)``, file the output with ``collect(w, out)``.

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
            faults.on_transfer(w, lrows)
            t0 = time.perf_counter()
            slab = ht.wave_slab((w * lrows,), lrows, out=hbufs[w % 2])
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

    def _streamed_exec(proot, padded, dev: torch.device,
                       rb: ReportBuilder | None, params: dict):
        """Run a physical plan containing a StreamedScan: the lowest
        aggregation pass above the scan executes as waves; any plan suffix
        above that pass runs resident on the pass's group-level output."""
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
        ht = padded[sc.name]
        ht = (ht if isinstance(ht, HostTable)
              else HostTable.from_table(ht)).pad_to(sched.padded_capacity)
        if sc.columns is not None:
            # Required-column pruning: slabs carry only the demand set the
            # lowering recorded (plus prob/valid, always).
            ht = ht.select_columns([c for c in sc.columns
                                    if c in ht.columns])
        resident = {n.name: _on_device(padded[n.name], dev)
                    for n in _iter_phys(proot)
                    if isinstance(n, phys.ShardScan)}
        mg = pa.max_groups
        keys = list(pa.keys)
        kcols = list(pa.keys)
        if agg.kind == "reweight":
            kcols += [c for c in agg.carry_cols if c not in kcols]
            if agg.threshold_col and agg.threshold_col not in kcols:
                kcols.append(agg.threshold_col)
        exact_names, slabs = _pass_slabs(pa, cf_budget_elems)
        lcpw = sched.local_chunks_per_wave

        def spine(slab: Table) -> Table:
            return make_runner({**resident, sc.name: slab},
                               params=params)(pa.child)

        # Phase A: stream once for the global group-code table.  Merging
        # the per-wave tables of the max_groups smallest codes keeps the
        # max_groups smallest overall: the resident table, bit for bit.
        code_tabs: list = [None] * sched.n_waves

        def wave_a(w, slab):
            code_live, _ = ops.live_key_codes(spine(slab), keys)
            return ops.merge_group_codes(code_live, mg)

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
            # Chunk slots past the canonical grid only pad the schedule
            # (invalid rows): they get no state, and launch no kernel.
            real = min(lcpw, chunks - w * lcpw)
            rows = real * sched.chunk_rows
            cut: dict = {}
            values = {k: None if v is None
                      else cut.setdefault(id(v), v[:rows])
                      for k, v in _pass_values(pa.specs, t).items()}
            probs, cids = t.masked_prob()[:rows], ids[:rows]
            cf_operands = _cf_operands(pa, exact_names, slabs, probs,
                                       values, cids, real)
            out_states = []
            for si, (lo, cnt) in enumerate(slabs):
                _, vals_i = _slab_udas(pa, si, lo, cnt, values)
                out_states.append(uda.accumulate_chunk_states(
                    slab_udas[si], probs, vals_i, cids, max_groups=mg,
                    num_chunks=real, cf_operands=cf_operands or None))
            return out_states, ops.group_key_columns(t, kcols, ids, mg), lost

        def collect_b(w, out):
            out_states, gcols, lost = out
            chunk_ids = [w * lcpw + j for j in range(lcpw)]
            for acc, parts in zip(accs, out_states):
                acc.add_wave(chunk_ids, parts)
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
        return make_runner({**resident, _STREAMED_RESULT: result}, rb,
                           params)(outer)

    def compiled(tables: Dict[str, Table], params: dict | None = None):
        env = dict(params or {})
        missing = needed_params - env.keys()
        extra = env.keys() - needed_params
        if missing or extra:
            raise ValueError(
                f"plan parameters mismatch: missing {sorted(missing)}, "
                f"unexpected {sorted(extra)} (plan needs "
                f"{sorted(needed_params)})")
        # Every base table is padded to the canonical chunk grid (a
        # HostTable virtually): the chunk boundaries define the
        # deterministic fold tree.
        padded = {k: t.pad_to_multiple(chunks) for k, t in tables.items()}
        caps = {k: t.capacity for k, t in padded.items()}
        proot = phys.lower_plan(root, caps, n_shards=1, sharded=False,
                                canonical_chunks=chunks, tables=padded,
                                device_row_budget=device_row_budget,
                                stream_wave_chunks=stream_wave_chunks,
                                stream_prune_columns=stream_prune_columns)
        rb = ReportBuilder() if with_report else None
        if any(isinstance(n, phys.StreamedScan) for n in _iter_phys(proot)):
            out = _streamed_exec(proot, padded, _target(device), rb, env)
        else:
            if any(isinstance(t, HostTable) for t in padded.values()):
                dev = _target(device)
                padded = {n.name: _on_device(padded[n.name], dev)
                          for n in _iter_phys(proot)
                          if isinstance(n, phys.ShardScan)}
            out = make_runner(padded, rb, env)(proot)
        if isinstance(out, Table):
            out = out.with_part(phys.Replicated())
        return (out, rb.build()) if with_report else out

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

    * truncation tail mass above ``policy.tail_tol`` -> kappa doubled;
    * group-code-table overflow -> max_groups doubled;
    * a transfer fault surviving the in-loop wave retries -> wave size
      halved (``stream_wave_chunks``).

    The reference's fourth escalation, exchange overflow (bucket floor
    and slack), needs an exchange: no single-device compile has one, so
    it arrives with the multi-rank slice.  NaN counts mean the NaN came in
    with the data: nothing to escalate, and the result returns with the
    report flagging it.

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
    wave_chunks = opts.pop("stream_wave_chunks", None)
    out = report = None
    attempt = 0
    for attempt in range(1, policy.max_attempts + 1):
        fn = compiler(_scale_plan(root, kappa_scale, groups_scale), mesh,
                      with_report=True, stream_wave_chunks=wave_chunks,
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
        if "tail" in issues:
            kappa_scale *= 2
        if "group_overflow" in issues:
            groups_scale *= 2

    # A single-device compile lowers no exchange, so the exchange ladder's
    # parameters stay where the reference starts them (slack 4.0, no
    # floor), as the reference's own single-device runs report.
    report.final_params.update(
        shuffle_slack=4.0, shuffle_bucket_floor=None,
        stream_wave_chunks=wave_chunks, kappa_scale=kappa_scale,
        groups_scale=groups_scale)
    report.waves["attempts"] = attempt
    return out, report
