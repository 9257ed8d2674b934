"""Synthetic TPC-H-like probabilistic workload (paper §VIII; port of
``repro.db.tpch``): the generator, the plan constructors, the MIN/MAX
query ``q18_topk`` and Q1, Q3, Q6, Q18 (normal and ``method="exact"``) and
Q20 in the paper's four modes:

    deterministic      the plain query (p ignored)
    confidence         P(result non-empty)        = AtLeastOne over the result
    group_confidence   P(group non-empty) per group
    aggregate          PGF aggregate per group (Normal / moments / exact CF)

:func:`generate` draws the same tables as the JAX generator for the same
arguments and seed; :func:`from_numpy` carries the JAX package's tables
(as numpy arrays) across.  Tables live on the device the caller names
(the card by default).  Dates are day numbers, prices and quantities
integers (the paper's integer-grid restriction, §V-C.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.config import default_float, resolve_device
from ..core.uda import segment_sum
from . import operators as ops
from .plans import (FKJoin, GroupAgg, Map, Param, Parameterized, Project,
                    ReweightGreater, Scan, Select, compile_plan)
from .table import Table

DAY0_1995 = 9131          # days since epoch-ish origin for synthetic dates
TABLES = ("lineitem", "orders", "customer", "part", "partsupp", "supplier",
          "nation")


@dataclasses.dataclass
class TPCH:
    """A scale-parameterised synthetic TPC-H instance with p columns."""

    lineitem: Table
    orders: Table
    customer: Table
    part: Table
    partsupp: Table
    supplier: Table
    nation: Table
    scale: dict

    def tables(self) -> Dict[str, Table]:
        """The plan-compiler catalogue view: name -> Table."""
        return {t: getattr(self, t) for t in TABLES}


def _four_smallest(rng, n_parts: int, n_suppliers: int,
                   block_rows: int) -> np.ndarray:
    """Row-wise ``argsort(rng.random((n_parts, n_suppliers)))[:, :4]``,
    drawn in row blocks (consecutive ``Generator.random`` calls continue
    one stream, so the blocks are the one large draw) and selected with
    argpartition, so host memory stays at one block."""
    out = np.empty((n_parts, 4), np.int64)
    for lo in range(0, n_parts, block_rows):
        r = rng.random((min(block_rows, n_parts - lo), n_suppliers))
        idx = np.argpartition(r, 3, axis=1)[:, :4]
        order = np.argsort(np.take_along_axis(r, idx, axis=1), axis=1)
        out[lo:lo + r.shape[0]] = np.take_along_axis(idx, order, axis=1)
    return out


def generate_numpy(n_orders: int = 2000, lines_per_order: int = 4,
                   n_parts: int = 200, n_suppliers: int = 50,
                   n_customers: int = 300, n_nations: int = 25,
                   seed: int = 0, prob_mode: str = "uniform",
                   partsupp_block_rows: int | None = None):
    """The generator's host arrays: ({table: dict(columns=..., prob=...)},
    scale).  Draws in the JAX generator's order, so equal seeds give equal
    arrays (probabilities in float64)."""
    rng = np.random.default_rng(seed)
    n_lineitem = n_orders * lines_per_order
    if n_suppliers < 4:
        raise ValueError(
            f"generate() needs n_suppliers >= 4 (got {n_suppliers}): the "
            "partsupp schema keys 4 DISTINCT suppliers per part")
    n_partsupp = n_parts * 4

    def probs(n):
        if prob_mode == "uniform":
            return rng.uniform(0.0, 1.0, n).astype(np.float64)
        return np.ones(n)

    out = {}
    cols = {"n_nationkey": np.arange(n_nations),
            "n_name": np.arange(n_nations)}          # 3 == "CANADA"
    out["nation"] = dict(columns=cols, prob=probs(n_nations))
    cols = {"s_suppkey": np.arange(n_suppliers),
            "s_nationkey": rng.integers(0, n_nations, n_suppliers),
            "s_name": np.arange(n_suppliers),
            "s_address": np.arange(n_suppliers)}
    out["supplier"] = dict(columns=cols, prob=probs(n_suppliers))
    cols = {"p_partkey": np.arange(n_parts),
            "p_name_forest": rng.uniform(0, 1, n_parts) < 0.1,
            "p_retailprice": rng.integers(100, 2000, n_parts)}
    out["part"] = dict(columns=cols, prob=probs(n_parts))

    ps_part = np.repeat(np.arange(n_parts), 4)
    # 4 DISTINCT suppliers per part: ps_pskey is an FK-join build key.
    block = partsupp_block_rows or max(1, (1 << 22) // n_suppliers)
    ps_supp = _four_smallest(rng, n_parts, n_suppliers, block).reshape(-1)
    cols = {"ps_partkey": ps_part,
            "ps_suppkey": ps_supp,
            "ps_availqty": rng.integers(1, 1000, n_partsupp),
            "ps_pskey": ps_part * (1 << 10) + ps_supp}
    out["partsupp"] = dict(columns=cols, prob=probs(n_partsupp))
    cols = {"c_custkey": np.arange(n_customers),
            "c_mktsegment": rng.integers(0, 5, n_customers)}
    out["customer"] = dict(columns=cols, prob=probs(n_customers))
    cols = {"o_orderkey": np.arange(n_orders),
            "o_custkey": rng.integers(0, n_customers, n_orders),
            "o_orderdate": rng.integers(DAY0_1995 - 800, DAY0_1995 + 800,
                                        n_orders),
            "o_totalprice": rng.integers(1000, 100000, n_orders)}
    out["orders"] = dict(columns=cols, prob=probs(n_orders))

    l_part = rng.integers(0, n_parts, n_lineitem)
    # pick a supplier that actually supplies the part (partsupp has 4/part)
    l_supp = ps_supp[l_part * 4 + rng.integers(0, 4, n_lineitem)]
    cols = {"l_orderkey": np.repeat(np.arange(n_orders), lines_per_order),
            "l_partkey": l_part,
            "l_suppkey": l_supp,
            "l_pskey": l_part * (1 << 10) + l_supp,
            "l_quantity": rng.integers(1, 51, n_lineitem),
            "l_extendedprice": rng.integers(100, 10000, n_lineitem),
            "l_discount": rng.integers(0, 11, n_lineitem),  # percent
            "l_shipdate": rng.integers(DAY0_1995 - 900, DAY0_1995 + 900,
                                       n_lineitem),
            "l_returnflag": rng.integers(0, 3, n_lineitem),
            "l_linestatus": rng.integers(0, 2, n_lineitem)}
    out["lineitem"] = dict(columns=cols, prob=probs(n_lineitem))
    scale = dict(n_orders=n_orders, n_lineitem=n_lineitem, n_parts=n_parts,
                 n_suppliers=n_suppliers, n_customers=n_customers,
                 n_nations=n_nations)
    return out, scale


def from_numpy(arrays: dict, device="cuda", scale: dict | None = None,
               prob_dtype=None) -> TPCH:
    """The data bridge: {table: dict(columns={name: array}, prob=array,
    valid=array or absent)} host arrays -> a :class:`TPCH` on ``device``.
    Integer columns keep their dtype; probabilities keep theirs unless
    ``prob_dtype`` is given."""
    dev = resolve_device(device)
    tabs = {}
    for name in TABLES:
        a = arrays[name]
        t = Table.from_numpy(a["columns"], a["prob"], a.get("valid"), dev)
        tabs[name] = t if prob_dtype is None else t.with_prob(
            t.prob.to(prob_dtype))
    return TPCH(**tabs, scale=dict(scale or {}))


def generate(n_orders: int = 2000, lines_per_order: int = 4,
             n_parts: int = 200, n_suppliers: int = 50,
             n_customers: int = 300, n_nations: int = 25, seed: int = 0,
             prob_mode: str = "uniform", device="cuda",
             partsupp_block_rows: int | None = None) -> TPCH:
    """The JAX generator's tables on ``device`` (the card by default),
    probabilities in :func:`default_float`, integer columns int64."""
    dev = resolve_device(device)
    arrays, scale = generate_numpy(n_orders, lines_per_order, n_parts,
                                   n_suppliers, n_customers, n_nations,
                                   seed, prob_mode, partsupp_block_rows)
    return from_numpy(arrays, dev, scale, prob_dtype=default_float())


# ------------------------------------------------------ plan constructors
def _q1_select():
    return Select(Scan("lineitem"),
                  lambda t: t["l_shipdate"] <= DAY0_1995 + 500)


def q1_plan():
    """Q1 aggregate-mode plan: pricing summary GROUP BY (returnflag,
    linestatus) with SUM/COUNT/cumulant riders in one pass."""
    return GroupAgg(_q1_select(), ("l_returnflag", "l_linestatus"),
                    "l_quantity", "SUM", 8, "normal",
                    extra=(("price", "l_extendedprice", "SUM", "normal"),
                           ("count", "", "COUNT", "normal"),
                           ("cumulants_qty", "l_quantity", "SUM",
                            "cumulants")))


def _q3_join(segment: int = 1, order_join_budget: int | None = None):
    cust = Select(Scan("customer"), lambda t: t["c_mktsegment"] == segment)
    orders = Select(Scan("orders"), lambda t: t["o_orderdate"] < DAY0_1995)
    o = FKJoin(orders, cust, "o_custkey", "c_custkey", ("c_mktsegment",))
    li = Select(Scan("lineitem"), lambda t: t["l_shipdate"] > DAY0_1995)
    return FKJoin(li, o, "l_orderkey", "o_orderkey",
                  ("o_orderdate", "o_custkey"),
                  gather_budget=order_join_budget)


def q3_plan(segment: int = 1, max_groups: int = 512,
            order_join_budget: int | None = None):
    """Q3 aggregate-mode plan: revenue per order of one market segment."""
    return GroupAgg(_q3_join(segment, order_join_budget), ("l_orderkey",),
                    "l_extendedprice", "SUM", max_groups, "normal",
                    extra=(("cumulants", "l_extendedprice", "SUM",
                            "cumulants"),))


def _q6_select():
    return Select(
        Scan("lineitem"),
        lambda t: (t["l_shipdate"] >= DAY0_1995 - 400)
        & (t["l_shipdate"] < DAY0_1995)
        & (t["l_discount"] >= 5) & (t["l_discount"] <= 7)
        & (t["l_quantity"] < 24))


def q6_plan(num_freq: int | None = None):
    """Q6 aggregate-mode plan: the single-group scalar revenue SUM."""
    val = Map(_q6_select(), "q6_value",
              lambda t: t["l_quantity"] * t["l_discount"])
    extra = (("cumulants", "q6_value", "SUM", "cumulants"),)
    if num_freq:
        extra += (("exact", "q6_value", "SUM", "exact"),)
    return GroupAgg(val, (), "q6_value", "SUM", 1, "normal", extra=extra,
                    num_freq=num_freq or 0)


def q18_plan(qty_threshold: float = 150.0, max_groups: int = 2048):
    """Q18 reweight plan: keep each order with p *= P(SUM(qty) > cutoff)."""
    return ReweightGreater(Scan("lineitem"), ("l_orderkey",), "l_quantity",
                           "", max_groups, threshold=float(qty_threshold))


def q18_topk_plan(max_groups: int = 2048, kappa: int = 8):
    """:func:`q18_topk`'s plan: per-order MAX(l_quantity) with ``kappa``
    support values a group (the plan :func:`~repro_torch.db.plans.run_plan`
    escalates)."""
    return GroupAgg(Scan("lineitem"), ("l_orderkey",), "l_quantity", "MAX",
                    max_groups, kappa=kappa)


def _q20_r10(nation_name: int = 3, max_groups: int = 1024,
             avail_frac: float = 0.05):
    r1 = Select(Scan("part"), lambda t: t["p_name_forest"])
    r2 = FKJoin(Scan("partsupp"), r1, "ps_partkey", "p_partkey",
                ("p_name_forest",))
    r3 = Select(Scan("lineitem"),
                lambda t: (t["l_shipdate"] >= DAY0_1995 - 365)
                & (t["l_shipdate"] < DAY0_1995))
    r4 = FKJoin(r3, r2, "l_pskey", "ps_pskey",
                ("ps_availqty", "ps_suppkey", "ps_pskey"))
    r4t = Map(r4, "q20_thresh",
              lambda t: t["ps_availqty"].to(t.prob.dtype) * avail_frac)
    r7 = ReweightGreater(r4t, ("ps_pskey",), "l_quantity", "q20_thresh",
                         max_groups, carry_cols=("ps_suppkey",))
    nat = Select(Scan("nation"), lambda t: t["n_name"] == nation_name)
    r9 = FKJoin(Scan("supplier"), nat, "s_nationkey", "n_nationkey",
                ("n_name",))
    return FKJoin(r7, r9, "ps_suppkey", "s_suppkey",
                  ("s_name", "s_address"))


def q20_plan(nation_name: int = 3, max_groups: int = 1024,
             avail_frac: float = 0.05):
    """Q20 plan (the paper's Fig. 6): project(s_name) of the reweighted
    excess-stock pipeline."""
    return Project(_q20_r10(nation_name, max_groups, avail_frac),
                   ("s_name",), 64)


def serving_plans(max_groups: int = 512) -> dict:
    """One representative logical plan per TPC-H query: the serving
    workload (``launch/serve.py --db``) and the cache-hit bit-equality
    tests submit exactly these.  The defaults are the JAX package's; at
    SF1 Q3, Q18 and Q20 need larger group capacities."""
    return {"q1": q1_plan(), "q3": q3_plan(max_groups=max_groups),
            "q6": q6_plan(), "q18": q18_plan(max_groups=4 * max_groups),
            "q20": q20_plan()}


# ------------------------------------------------- parameterized families
def q6_family():
    """Q6 as a parameterized family: the discount window and quantity
    limit are lifted :class:`~repro_torch.db.plans.Param` holes
    (``disc_lo`` / ``disc_hi`` / ``qty_lim``), so one binding serves every
    setting (:meth:`repro_torch.db.serving.QueryService.sweep`)."""
    sel = Select(Scan("lineitem"), Parameterized(
        lambda t, lo, hi, lim: (t["l_shipdate"] >= DAY0_1995 - 400)
        & (t["l_shipdate"] < DAY0_1995)
        & (t["l_discount"] >= lo) & (t["l_discount"] <= hi)
        & (t["l_quantity"] < lim),
        ("disc_lo", "disc_hi", "qty_lim")))
    val = Map(sel, "q6_value", lambda t: t["l_quantity"] * t["l_discount"])
    return GroupAgg(val, (), "q6_value", "SUM", 1, "normal",
                    extra=(("cumulants", "q6_value", "SUM", "cumulants"),))


def q18_family(max_groups: int = 2048):
    """Q18 as a parameterized family: the quantity cutoff is the lifted
    ``qty_threshold`` param of the reweight, so threshold sweeps share one
    binding."""
    return ReweightGreater(Scan("lineitem"), ("l_orderkey",), "l_quantity",
                           "", max_groups,
                           threshold=Param("qty_threshold"))


# --------------------------------------------------------------- queries
def _masked(t: Table, col: str):
    return torch.where(t.valid, t[col], torch.zeros_like(t[col]))


def _confidence_of(plan, db: TPCH, mesh=None, opts=None):
    """P(result non-empty): one-group AtLeastOne over the plan's output."""
    agg = GroupAgg(plan, keys=(), value="", agg="COUNT", max_groups=1)
    out = compile_plan(agg, mesh, **(opts or {}))(db.tables())
    return dict(confidence=out["confidence"][0])


def q1(db: TPCH, mode: str = "aggregate", mesh=None, plan_opts=None):
    """Pricing summary: GROUP BY (returnflag, linestatus); SUM(quantity),
    SUM(extendedprice), COUNT(*) over shipped lineitems.  ``plan_opts``
    (every query): extra ``compile_plan`` keywords."""
    sel = _q1_select()
    keys = ("l_returnflag", "l_linestatus")
    if mode == "deterministic":
        li = compile_plan(sel)(db.tables())
        ids, _, gvalid = ops.group_ids(li, list(keys), 8)
        return dict(valid=gvalid,
                    sum_qty=segment_sum(_masked(li, "l_quantity"), ids, 8),
                    sum_price=segment_sum(_masked(li, "l_extendedprice"),
                                          ids, 8),
                    count=segment_sum(li.valid.to(torch.int32), ids, 8))
    if mode == "confidence":
        return _confidence_of(sel, db, mesh, plan_opts)
    if mode == "group_confidence":
        out = compile_plan(GroupAgg(sel, keys, "", "COUNT", 8), mesh,
                           **(plan_opts or {}))(db.tables())
        return dict(valid=out["valid"], confidence=out["confidence"])
    out = compile_plan(q1_plan(), mesh, **(plan_opts or {}))(db.tables())
    return dict(valid=out["valid"], qty=out["sum"], price=out["price"],
                count=out["count"], cumulants_qty=out["cumulants_qty"])


def q3(db: TPCH, mode: str = "aggregate", segment: int = 1,
       max_groups: int = 512, mesh=None, plan_opts=None,
       order_join_budget: int | None = None):
    """Shipping priority: revenue per order for one market segment."""
    j = _q3_join(segment, order_join_budget)
    if mode == "deterministic":
        jt = compile_plan(j)(db.tables())
        ids, _, gvalid = ops.group_ids(jt, ["l_orderkey"], max_groups)
        return dict(valid=gvalid,
                    revenue=segment_sum(_masked(jt, "l_extendedprice"),
                                        ids, max_groups))
    if mode == "confidence":
        return _confidence_of(j, db, mesh, plan_opts)
    if mode == "group_confidence":
        out = compile_plan(GroupAgg(j, ("l_orderkey",), "", "COUNT",
                                    max_groups), mesh,
                           **(plan_opts or {}))(db.tables())
        return dict(valid=out["valid"], confidence=out["confidence"])
    plan = q3_plan(segment, max_groups, order_join_budget)
    out = compile_plan(plan, mesh, **(plan_opts or {}))(db.tables())
    return dict(valid=out["valid"], revenue=out["sum"],
                cumulants=out["cumulants"])


def q6(db: TPCH, mode: str = "aggregate", num_freq: int | None = None,
       mesh=None, plan_opts=None):
    """Forecast revenue change: scalar SUM over filtered lineitem;
    ``num_freq`` adds the exact distribution (the Figure 9 shape)."""
    sel = _q6_select()
    if mode == "deterministic":
        li = compile_plan(sel)(db.tables())
        rev = torch.where(li.valid, li["l_quantity"] * li["l_discount"],
                          torch.zeros_like(li["l_quantity"]))
        return dict(revenue=torch.sum(rev))
    if mode in ("confidence", "group_confidence"):
        return _confidence_of(sel, db, mesh, plan_opts)
    r = compile_plan(q6_plan(num_freq), mesh, **(plan_opts or {}))(db.tables())
    mu, var = r["sum"]
    out = dict(normal=(mu[0], var[0]), cumulants=r["cumulants"][0])
    if num_freq:
        out["exact_coeffs"] = r["exact"][0]
    return out


def q18(db: TPCH, mode: str = "aggregate", qty_threshold: int = 150,
        max_groups: int = 2048, mesh=None, method: str = "normal",
        num_freq: int = 256, plan_opts=None):
    """Large-volume customers: orders whose SUM(l_quantity) > threshold,
    kept with p = p_order * P(SUM > threshold).  ``method="exact"``
    (aggregate mode) computes each order's quantity distribution through
    the grouped exact-CF path and takes the exact tail mass."""
    li = Scan("lineitem")
    if mode == "deterministic":
        t = db.lineitem
        ids, _, gvalid = ops.group_ids(t, ["l_orderkey"], max_groups)
        qty = segment_sum(_masked(t, "l_quantity"), ids, max_groups)
        return dict(valid=gvalid & (qty > qty_threshold), sum_qty=qty)
    rew = q18_plan(qty_threshold, max_groups)
    if mode == "confidence":
        return _confidence_of(rew, db, mesh, plan_opts)
    if mode == "group_confidence":
        t = compile_plan(rew, mesh, **(plan_opts or {}))(db.tables())
        return dict(valid=t.valid, confidence=t.prob)
    if method == "exact":
        plan = GroupAgg(li, ("l_orderkey",), "l_quantity", "SUM", max_groups,
                        "exact", num_freq=num_freq)
        out = compile_plan(plan, mesh, **(plan_opts or {}))(db.tables())
        coeffs = out["exact"]                        # (G, num_freq) rows
        gt = torch.arange(num_freq, device=coeffs.device) > qty_threshold
        p_gt = torch.sum(coeffs * gt[None, :], dim=-1)
        return dict(valid=out["valid"], sum_dist=coeffs, p_qualifies=p_gt)
    plan = GroupAgg(li, ("l_orderkey",), "l_quantity", "SUM", max_groups,
                    "normal")
    out = compile_plan(plan, mesh, **(plan_opts or {}))(db.tables())
    mu, var = out["sum"]
    p_gt = ops.normal_greater(mu, var, torch.as_tensor(
        qty_threshold, dtype=mu.dtype, device=mu.device))
    return dict(valid=out["valid"], sum_qty=(mu, var), p_qualifies=p_gt)


def q18_topk(db: TPCH, max_groups: int = 2048, kappa: int = 8, mesh=None,
             plan_opts=None):
    """Top-k variant of Q18: the per-order MAX(l_quantity) distribution
    with the paper's §V-B.2 truncation bound exposed per group.

    The MinMax UDA keeps the ``kappa`` best distinct values per group
    (§V-B.1 masses are exact on that support); ``tail_mass`` is the
    probability that a group's true MAX lies STRICTLY beyond the kept
    support,

        tail_mass_g = prod_{kept values} Q_j * (1 - prod_{evicted} (1-p)),

    exactly 0 when kappa covered every distinct value.  Returns per-run
    tensors (the flattened G*kappa support grid of
    ``operators.minmax_runs``) plus the per-group ``p_empty``, ``p_tail``
    (P(no kept value present)) and ``tail_mass``.
    """
    out = compile_plan(q18_topk_plan(max_groups, kappa), mesh,
                       **(plan_opts or {}))(db.tables())
    mm = out["minmax"]
    return dict(valid=out["valid"], keys=out["keys"],
                run_group=mm["run_group"], run_value=mm["run_value"],
                run_mass=mm["run_mass"], run_valid=mm["run_valid"],
                p_empty=mm["p_empty"], p_tail=mm["p_tail"],
                tail_mass=mm["tail_mass"])


def q20(db: TPCH, mode: str = "aggregate", nation_name: int = 3,
        max_groups: int = 1024, avail_frac: float = 0.05, mesh=None,
        plan_opts=None):
    """The paper's Fig. 6 plan: suppliers in one nation with excess stock
    of 'forest' parts (project(s_name) of R7 |x| R9)."""
    r10 = _q20_r10(nation_name, max_groups, avail_frac)
    if mode == "deterministic":
        t = compile_plan(r10, mesh, **(plan_opts or {}))(db.tables())
        return dict(valid=t.valid & (t.prob > 0.5), s_name=t["s_name"])
    proj = Project(r10, ("s_name",), 64)
    if mode == "confidence":
        return _confidence_of(proj, db, mesh, plan_opts)
    result = compile_plan(proj, mesh, **(plan_opts or {}))(db.tables())
    if mode == "group_confidence":
        return dict(valid=result.valid, s_name=result["s_name"],
                    confidence=result.prob)
    return dict(valid=result.valid, s_name=result["s_name"],
                prob=result.prob)


QUERIES = {"q1": q1, "q3": q3, "q6": q6, "q18": q18, "q20": q20}
MODES = ("deterministic", "confidence", "group_confidence", "aggregate")
