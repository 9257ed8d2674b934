"""The reference answers of the benchmark's five TPC-H queries, recomputed
from the generated tables alone (joins, groups and aggregate states), in
plain PyTorch.  Imports nothing of the program.

``answer(family, tables, cfg, subst, dt, sample)`` returns what the
comparison reads: the number of valid groups, the sum of each key over
the valid groups, and every result leaf at the ``sample`` slots with the
scale its rounding is judged against (``None``: an absolute error).
Leaf names follow the benchmark's flattening of the program's result
(``results.flatten``): ``valid``, ``key.<column>``, ``prob.<name>``,
``mean.<name>``, ``var.<name>``, ``cum.<name>``.
"""
from __future__ import annotations

import torch

from .. import subst as S
from . import engine as E


def _li(tables):
    return tables["lineitem"]


def _groups_out(t, keys, max_groups):
    g = E.group(t, keys, max_groups)
    out = {"valid": (g["valid"], None)}
    for k, v in g["keys"].items():
        out[f"key.{k}"] = (v, None)
    return g, out


def _sum_leaves(out, name, p, v, gid, groups, dt):
    (mu, var), (smu, svar) = E.normal(p, v, gid, groups, dt)
    out[f"mean.{name}"] = (mu, smu)
    out[f"var.{name}"] = (var, svar)


def _masked_p(t):
    return torch.where(t["valid"], t["prob"], 0.0)


def q1(tables, cfg, s, dt, sample):
    li = _li(tables)
    t = E.select(li, li["columns"]["l_shipdate"] <= S.q1_cutoff(s["delta"]))
    g, out = _groups_out(t, ("l_returnflag", "l_linestatus"), 8)
    p, gid, c = _masked_p(t), g["gid"], t["columns"]
    out["prob.confidence"] = (E.confidence(p, gid, 8, dt), None)
    _sum_leaves(out, "sum", p, c["l_quantity"], gid, 8, dt)
    _sum_leaves(out, "price", p, c["l_extendedprice"], gid, 8, dt)
    _sum_leaves(out, "count", p, torch.ones_like(p), gid, 8, dt)
    out["cum.cumulants_qty"] = E.cumulants(p, c["l_quantity"], gid, 8, dt)
    return g, out


def q3(tables, cfg, s, dt, sample):
    date = S.q3_date(s["day"])
    cust = tables["customer"]
    cust = E.select(cust, cust["columns"]["c_mktsegment"] == s["segment"])
    orders = tables["orders"]
    orders = E.select(orders, orders["columns"]["o_orderdate"] < date)
    o = E.fk_join(orders, "o_custkey", cust, "c_custkey")
    li = _li(tables)
    li = E.select(li, li["columns"]["l_shipdate"] > date)
    t = E.fk_join(li, "l_orderkey", o, "o_orderkey")
    G = int(cfg["groups"]["q3"])
    g, out = _groups_out(t, ("l_orderkey",), G)
    p, gid, v = _masked_p(t), g["gid"], t["columns"]["l_extendedprice"]
    out["prob.confidence"] = (E.confidence(p, gid, G, dt), None)
    _sum_leaves(out, "sum", p, v, gid, G, dt)
    out["cum.cumulants"] = E.cumulants(p, v, gid, G, dt)
    return g, out


def q6(tables, cfg, s, dt, sample):
    b = S.q6_bounds(s["year"], s["discount"], s["quantity"])
    li = _li(tables)
    c = li["columns"]
    t = E.select(li, (c["l_shipdate"] >= b["lo"]) & (c["l_shipdate"] < b["hi"])
                 & (c["l_discount"] >= b["dlo"])
                 & (c["l_discount"] <= b["dhi"])
                 & (c["l_quantity"] < b["qty"]))
    g, out = _groups_out(t, (), 1)
    p, gid = _masked_p(t), g["gid"]
    v = c["l_quantity"] * c["l_discount"]
    out["prob.confidence"] = (E.confidence(p, gid, 1, dt), None)
    _sum_leaves(out, "sum", p, v, gid, 1, dt)
    out["cum.cumulants"] = E.cumulants(p, v, gid, 1, dt)
    n = int(cfg["num_freq"]["q6"])
    out["prob.exact"] = (E.scalar_cf_coeffs(p, v, n, dt)[None], None)
    out["prob.exact_count"] = (
        E.scalar_cf_coeffs(p, torch.ones_like(v), n, dt)[None], None)
    return g, out


def q18(tables, cfg, s, dt, sample):
    li = _li(tables)
    G, N = int(cfg["groups"]["q18"]), int(cfg["num_freq"]["q18"])
    g, out = _groups_out(li, ("l_orderkey",), G)
    p, gid = _masked_p(li), g["gid"]
    out["prob.confidence"] = (E.confidence(p, gid, G, dt), None)
    # the exact distributions only of the sampled live groups
    live = sample[sample < g["n"]]
    dist = E.grouped_distribution(p, li["columns"]["l_quantity"], gid, live,
                                  N, dt)
    full = torch.zeros((sample.shape[0], N), dtype=dist.dtype,
                       device=dist.device)
    full[:live.shape[0]] = dist            # sample is sorted: live first
    cut = int(cfg["q18_cutoff"])
    out["prob.exact"] = (full, None)
    out["prob.p_qualifies"] = (full[:, cut + 1:].sum(-1), None)
    return g, out


def q20(tables, cfg, s, dt, sample):
    part = tables["part"]
    r1 = E.select(part, part["columns"]["p_name_forest"])
    r2 = E.fk_join(tables["partsupp"], "ps_partkey", r1, "p_partkey")
    li = _li(tables)
    r3 = E.select(li, (li["columns"]["l_shipdate"] >= S.Q20_LO)
                  & (li["columns"]["l_shipdate"] < S.Q20_HI))
    r4 = E.fk_join(r3, "l_pskey", r2, "ps_pskey",
                   ("ps_availqty", "ps_suppkey"))
    G = int(cfg["groups"]["q20"])
    g7 = E.group(r4, ("l_pskey",), G)
    p4, gid = _masked_p(r4), g7["gid"]
    fin = E.fin_dtype(dt)
    (mu, var), _ = E.normal(p4, r4["columns"]["l_quantity"], gid, G, dt)
    thr = torch.zeros((G,), dtype=torch.float64, device=p4.device)
    ok = gid >= 0
    thr[gid[ok]] = r4["columns"]["ps_availqty"][ok].double() \
        * S.Q20_AVAIL_FRAC
    p7 = E.confidence(p4, gid, G, dt) * E.normal_greater(
        mu.to(fin), var.to(fin), thr.to(fin))
    supp_of = torch.zeros((G,), dtype=torch.int64, device=p4.device)
    supp_of[gid[ok]] = r4["columns"]["ps_suppkey"][ok]
    r7 = E.table({"ps_suppkey": supp_of}, p7.to(dt), g7["valid"])
    nat = tables["nation"]
    nat = E.select(nat, nat["columns"]["n_name"] == s["nation"])
    r9 = E.fk_join(tables["supplier"], "s_nationkey", nat, "n_nationkey")
    r10 = E.fk_join(r7, "ps_suppkey", r9, "s_suppkey", ("s_name",))
    GP = int(cfg["groups"]["q20_project"])
    g, out = _groups_out(r10, ("s_name",), GP)
    out["prob.p"] = (E.confidence(_masked_p(r10), g["gid"], GP, dt), None)
    return g, out


QUERIES = {"q1": q1, "q3": q3, "q6": q6, "q18": q18, "q20": q20}
#: leaves a query computes at the sample slots only
PRESAMPLED = {"q18": ("prob.exact", "prob.p_qualifies")}


def answer(family: str, tables: dict, cfg: dict, subst: dict, dt,
           sample) -> dict:
    """``{"n_valid", "keysum": {key: int}, "lost", "leaves": {name:
    (values at sample, scale at sample or None)}}``.  ``sample`` is a
    sorted tensor of slot indices; probabilities are taken in ``dt``
    from the start, so every product and sum runs in it."""
    tables = {k: dict(t, prob=t["prob"].to(dt)) for k, t in tables.items()}
    g, out = QUERIES[family](tables, cfg, subst, dt, sample)
    keysum = {k: int((v * g["valid"]).sum()) for k, v in g["keys"].items()}
    pre = PRESAMPLED.get(family, ())
    leaves = {}
    for name, (val, scale) in out.items():
        take = (lambda x: x) if name in pre else (lambda x: x[sample])
        leaves[name] = (take(val), None if scale is None else take(scale))
    return dict(n_valid=g["n"], keysum=keysum, lost=g["lost"],
                leaves=leaves)
