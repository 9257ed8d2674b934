"""The benchmark's query families, written with the port's public plan
nodes the way a user writes them (the patterns of the port's
``db/tpch.py`` and of ``chip_smoke.py``'s ``q3_family``, copied here so a
change to either does not move the yardstick).

Every substitution parameter is a :class:`Param` hole of the plan
(``Parameterized`` predicates), so one binding of the service's plan
cache serves every value.  A family is looked up by name:

    family = FAMILIES[name]
    root = family.plan(cfg)           # cfg: the configuration's file
    params = family.params(subst)     # TPC-H substitution parameters
    out = family.post(result, cfg)    # the query's own last step

``opts(cfg)`` are the family's ``compile_plan`` options.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import subst as S


def _nodes():
    from repro_torch.db import plans
    return plans


def q1_plan(cfg: dict):
    """Q1 pricing summary, GROUP BY (returnflag, linestatus): SUM(qty),
    SUM(price), COUNT, and the quantity's cumulants in one pass."""
    P = _nodes()
    sel = P.Select(P.Scan("lineitem"), P.Parameterized(
        lambda t, cutoff: t["l_shipdate"] <= cutoff, ("q1_cutoff",)))
    return P.GroupAgg(sel, ("l_returnflag", "l_linestatus"), "l_quantity",
                      "SUM", 8, "normal",
                      extra=(("price", "l_extendedprice", "SUM", "normal"),
                             ("count", "", "COUNT", "normal"),
                             ("cumulants_qty", "l_quantity", "SUM",
                              "cumulants")))


def q3_plan(cfg: dict):
    """Q3 shipping priority: revenue per order of one market segment,
    orders before DATE, lines shipped after it (SEGMENT on ``customer``,
    DATE on ``orders`` and ``lineitem``)."""
    P = _nodes()
    cust = P.Select(P.Scan("customer"), P.Parameterized(
        lambda t, seg: t["c_mktsegment"] == seg, ("segment",)))
    orders = P.Select(P.Scan("orders"), P.Parameterized(
        lambda t, date: t["o_orderdate"] < date, ("date",)))
    o = P.FKJoin(orders, cust, "o_custkey", "c_custkey", ("c_mktsegment",))
    li = P.Select(P.Scan("lineitem"), P.Parameterized(
        lambda t, date: t["l_shipdate"] > date, ("date",)))
    j = P.FKJoin(li, o, "l_orderkey", "o_orderkey",
                 ("o_orderdate", "o_custkey"))
    return P.GroupAgg(j, ("l_orderkey",), "l_extendedprice", "SUM",
                      int(cfg["groups"]["q3"]), "normal",
                      extra=(("cumulants", "l_extendedprice", "SUM",
                              "cumulants"),))


def q6_plan(cfg: dict):
    """Q6 forecast revenue: SUM(quantity * discount) over one year's
    lines in a discount window below a quantity, as (mean, variance),
    cumulants and the exact distribution at ``num_freq`` frequencies,
    with the exact distribution of the COUNT of those lines beside it
    (the SUM's spreads over many times ``num_freq`` at scale, so its
    distribution mod ``num_freq`` is all but uniform; the COUNT's is
    narrow, so it shows what the CF kernel computed)."""
    P = _nodes()
    sel = P.Select(P.Scan("lineitem"), P.Parameterized(
        lambda t, lo, hi, dlo, dhi, qty: (t["l_shipdate"] >= lo)
        & (t["l_shipdate"] < hi) & (t["l_discount"] >= dlo)
        & (t["l_discount"] <= dhi) & (t["l_quantity"] < qty),
        ("q6_lo", "q6_hi", "q6_dlo", "q6_dhi", "q6_qty")))
    val = P.Map(sel, "q6_value",
                lambda t: t["l_quantity"] * t["l_discount"])
    return P.GroupAgg(val, (), "q6_value", "SUM", 1, "normal",
                      extra=(("cumulants", "q6_value", "SUM", "cumulants"),
                             ("exact", "q6_value", "SUM", "exact"),
                             ("exact_count", "", "COUNT", "exact")),
                      num_freq=int(cfg["num_freq"]["q6"]))


def q18_plan(cfg: dict):
    """Q18 large-volume orders, exact: each order's quantity
    distribution through the grouped exact-CF path."""
    P = _nodes()
    return P.GroupAgg(P.Scan("lineitem"), ("l_orderkey",), "l_quantity",
                      "SUM", int(cfg["groups"]["q18"]), "exact",
                      num_freq=int(cfg["num_freq"]["q18"]))


def q18_post(out: dict, cfg: dict) -> dict:
    """P(SUM(l_quantity) > cutoff) of every order, from its exact
    distribution."""
    coeffs = out["exact"]
    cut = int(cfg["q18_cutoff"])
    return dict(out, p_qualifies=coeffs[:, cut + 1:].sum(-1))


def q20_plan(cfg: dict):
    """Q20 (the paper's Fig. 6): suppliers of NATION with excess stock of
    forest parts, project(s_name) of the reweighted pipeline."""
    P = _nodes()
    r1 = P.Select(P.Scan("part"), lambda t: t["p_name_forest"])
    r2 = P.FKJoin(P.Scan("partsupp"), r1, "ps_partkey", "p_partkey",
                  ("p_name_forest",))
    lo, hi = S.Q20_LO, S.Q20_HI
    r3 = P.Select(P.Scan("lineitem"), lambda t: (t["l_shipdate"] >= lo)
                  & (t["l_shipdate"] < hi))
    r4 = P.FKJoin(r3, r2, "l_pskey", "ps_pskey",
                  ("ps_availqty", "ps_suppkey", "ps_pskey"))
    frac = S.Q20_AVAIL_FRAC
    r4t = P.Map(r4, "q20_thresh",
                lambda t: t["ps_availqty"].to(t.prob.dtype) * frac)
    r7 = P.ReweightGreater(r4t, ("ps_pskey",), "l_quantity", "q20_thresh",
                           int(cfg["groups"]["q20"]),
                           carry_cols=("ps_suppkey",))
    nat = P.Select(P.Scan("nation"), P.Parameterized(
        lambda t, n: t["n_name"] == n, ("nation",)))
    r9 = P.FKJoin(P.Scan("supplier"), nat, "s_nationkey", "n_nationkey",
                  ("n_name",))
    r10 = P.FKJoin(r7, r9, "ps_suppkey", "s_suppkey",
                   ("s_name", "s_address"))
    return P.Project(r10, ("s_name",), int(cfg["groups"]["q20_project"]))


def _q6_params(s: dict) -> dict:
    b = S.q6_bounds(s["year"], s["discount"], s["quantity"])
    return {"q6_lo": b["lo"], "q6_hi": b["hi"], "q6_dlo": b["dlo"],
            "q6_dhi": b["dhi"], "q6_qty": b["qty"]}


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    plan: Callable
    params: Callable
    #: group slots of the result (its leading axis)
    groups: Callable
    post: Callable = lambda out, cfg: out
    opts: Callable = lambda cfg: {}


def _slots(key: str):
    return lambda cfg: int(cfg["groups"][key])


FAMILIES = {
    "q1": Family("q1", q1_plan,
                 lambda s: {"q1_cutoff": S.q1_cutoff(s["delta"])},
                 lambda cfg: 8),
    "q3": Family("q3", q3_plan,
                 lambda s: {"segment": int(s["segment"]),
                            "date": S.q3_date(s["day"])}, _slots("q3")),
    "q6": Family("q6", q6_plan, _q6_params, lambda cfg: 1),
    "q18": Family("q18", q18_plan, lambda s: {}, _slots("q18"), q18_post,
                  lambda cfg: dict(cfg.get("plan_opts", {}).get("q18", {}))),
    "q20": Family("q20", q20_plan, lambda s: {"nation": int(s["nation"])},
                  _slots("q20_project")),
}


def sweep_batch(family: str, points: list, device) -> dict:
    """A sweep's parameter batch: each plan parameter as a length-N
    tensor over ``points`` (a list of substitution dicts)."""
    rows = [FAMILIES[family].params(p) for p in points]
    return {k: torch.tensor([r[k] for r in rows], device=device)
            for k in rows[0]}
