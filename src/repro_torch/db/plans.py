"""Probabilistic -> deterministic plan compilation (paper §VI, Table I;
port of ``repro.db.plans``): the logical plan nodes and the resident
single-device executor.

``compile_plan(root)`` lowers the logical DAG with the copied physical
planner (:func:`repro_torch.db.physical.lower_plan`) and returns a
function ``tables -> result`` that interprets the physical plan eagerly:
every base table is padded to the canonical chunk grid, every aggregation
pass accumulates one UDA state per canonical chunk and folds them in the
fixed :func:`repro_torch.core.uda.tree_fold` tree, so a result is the same
bits on every run.  Exact-CF aggregations whose (max_groups, num_freq)
state exceeds ``cf_budget_elems`` run as several frequency-slab passes
whose states are concatenated before the one batched-FFT Finalize.

Mesh, streamed (``device_row_budget``) and report (``with_report``)
compiles belong to later slices of the port and raise
``NotImplementedError``.

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
from typing import Callable, Dict

import torch

from ..core import uda
from . import operators as ops
from . import physical as phys
from .table import Table


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


def _finalize_pass(node, pa, udas: dict, states: dict, gvalid, key_columns,
                   params=None):
    """The epilogue of one aggregation pass, selected by ``node.kind``;
    ``key_columns(cols)`` returns the per-group representatives."""
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


def compile_plan(root: Node, mesh=None, *,
                 cf_budget_elems: int = 1 << 22,
                 canonical_chunks: int = 8,
                 device_row_budget: int | None = None,
                 with_report: bool = False):
    """Emit a function ``(tables, params=None) -> result`` (a Table or a
    dict of tensors) that runs ``root`` on the device its tables live on.

    ``canonical_chunks`` is the fixed accumulation grid of every pass;
    ``cf_budget_elems`` bounds the live exact-CF state elements of a
    ``GroupAgg(method="exact")`` node (log-abs and angle of every exact
    aggregate), above which the pass runs over frequency slabs."""
    if mesh is not None:
        raise NotImplementedError(
            "compile_plan(mesh=...) waits for the multi-rank slice of the "
            "port (torch.distributed)")
    if device_row_budget is not None:
        raise NotImplementedError(
            "streamed execution (device_row_budget) waits for the "
            "out-of-core slice of the port")
    if with_report:
        raise NotImplementedError(
            "with_report waits for the diagnostics-and-retry slice of the "
            "port")
    chunks = canonical_chunks
    if chunks <= 0:
        raise ValueError(f"canonical_chunks must be positive, got {chunks}")
    needed_params = plan_params(root)

    def acc(udas_d, table: Table, values, ids, max_groups,
            cf_operands=None):
        """ONE canonical chunked pass over the relation's tuples."""
        return uda.accumulate_chunked(
            udas_d, table.masked_prob(), values, ids, max_groups=max_groups,
            num_chunks=chunks, cf_operands=cf_operands)

    def run_agg(node: phys.MergeAgg, tables, params):
        """Group ids, then per frequency slab one chunked Accumulate +
        canonical fold, then the Finalize selected by ``kind``."""
        pa = node.child
        t = run(pa.child, tables, params)
        mg = pa.max_groups
        ids, _, gvalid = ops.group_ids(t, list(pa.keys), mg)
        values = _pass_values(pa.specs, t)
        exact_names, slabs = _pass_slabs(pa, cf_budget_elems)
        cf_operands: dict = {}
        if len(slabs) > 1:
            # Hoist the grouped kernel's argsort(gids) + operand prep above
            # the slab loop: prepared once per canonical chunk.
            probs_m = t.masked_prob()
            for name in exact_names:
                prepared = uda.cf_chunk_operands(
                    pa.num_freq, probs_m, values[name], ids,
                    max_groups=mg, num_chunks=chunks)
                if prepared is not None:
                    cf_operands[name] = prepared
        udas: dict = {}
        states: dict = {}
        for si, (lo, cnt) in enumerate(slabs):
            udas_i, vals_i = _slab_udas(pa, si, lo, cnt, values)
            _append_slab(states, udas, udas_i,
                         acc(udas_i, t, vals_i, ids, mg,
                             cf_operands=cf_operands or None))
        for name in exact_names:            # full-range Finalize UDA
            udas[name] = _agg_uda("SUM", "exact", pa.kappa, pa.num_freq)
        return _finalize_pass(
            node, pa, udas, states, gvalid,
            lambda cols: ops.group_key_columns(t, cols, ids, mg),
            params=params)

    def run(node: phys.PhysNode, tables, params):
        if isinstance(node, phys.ShardScan):
            return tables[node.name].with_part(node.part)
        if isinstance(node, phys.PhysSelect):
            pred = node.pred
            if isinstance(pred, Parameterized):
                return ops.select(run(node.child, tables, params),
                                  lambda t: pred(t, params))
            return ops.select(run(node.child, tables, params), pred)
        if isinstance(node, phys.PhysMap):
            t = run(node.child, tables, params)
            fn = node.fn
            col = fn(t, params) if isinstance(fn, Parameterized) else fn(t)
            return t.with_column(node.name, col)
        if isinstance(node, phys.GatherJoin):
            return ops.fk_join(run(node.left, tables, params),
                               run(node.right, tables, params),
                               node.left_key, node.right_key,
                               list(node.right_cols))
        if isinstance(node, phys.MergeAgg):
            return run_agg(node, tables, params)
        raise NotImplementedError(
            f"{type(node).__name__} is a mesh strategy: it waits for the "
            "multi-rank slice of the port")

    def compiled(tables: Dict[str, Table], params: dict | None = None):
        env = dict(params or {})
        missing = needed_params - env.keys()
        extra = env.keys() - needed_params
        if missing or extra:
            raise ValueError(
                f"plan parameters mismatch: missing {sorted(missing)}, "
                f"unexpected {sorted(extra)} (plan needs "
                f"{sorted(needed_params)})")
        # Every base table is padded to the canonical chunk grid: the chunk
        # boundaries define the deterministic fold tree.
        padded = {k: t.pad_to_multiple(chunks) for k, t in tables.items()}
        caps = {k: t.capacity for k, t in padded.items()}
        proot = phys.lower_plan(root, caps, n_shards=1, sharded=False,
                                canonical_chunks=chunks, tables=padded)
        out = run(proot, padded, env)
        if isinstance(out, Table):
            return out.with_part(phys.Replicated())
        return out

    return compiled
