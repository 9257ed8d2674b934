"""The benchmark's TPC-H tables, drawn on the device from ``--seed``.

A copy of the schema, value ranges and key distributions of the port's
``tpch.generate_numpy`` (the benchmark keeps its own so that a change to
the program's generator does not move the yardstick), drawn with one
``torch.Generator`` on the device in a few large calls:

    nation     n_nationkey, n_name                 0..n_nations-1
    supplier   s_suppkey, s_name, s_address        0..n_suppliers-1
               s_nationkey                         uniform nation
    part       p_partkey                           0..n_parts-1
               p_name_forest                       P = 0.1
               p_retailprice                       [100, 2000)
    partsupp   4 rows a part, 4 DISTINCT suppliers a part (uniform)
               ps_availqty [1, 1000), ps_pskey = partkey * 1024 + suppkey
    customer   c_custkey, c_mktsegment             [0, 5)
    orders     o_orderkey, o_custkey (uniform), o_orderdate DAY0 +- 800,
               o_totalprice [1000, 100000)
    lineitem   lines_per_order rows an order; l_partkey uniform, l_suppkey
               one of the part's 4 suppliers, l_quantity [1, 51),
               l_extendedprice [100, 10000), l_discount [0, 11) percent,
               l_shipdate DAY0 +- 900, l_returnflag [0, 3), l_linestatus
               [0, 2)

Every tuple's probability is uniform on [0, 1) in float32 (the port's
precision), drawn independently: the paper's tuple-independence model.
Integer columns are int64, every row valid.  A table is a plain dict
``{"columns": {name: tensor}, "prob": tensor, "valid": tensor}``; the
program and the reference are handed the same tensors.
"""
from __future__ import annotations

import torch

#: day number of 1995-01-01 (days since 1970-01-01)
DAY0_1995 = 9131
#: ps_pskey packs the supplier into the low 10 bits
PSKEY_SHIFT = 10
#: rows of the (parts, suppliers) random matrix drawn at once
_PARTSUPP_ELEMS = 1 << 26


def generator(seed: int, device) -> torch.Generator:
    """The seeded generator every draw of a run comes from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def _table(columns: dict, prob) -> dict:
    return {"columns": columns, "prob": prob,
            "valid": torch.ones(prob.shape, dtype=torch.bool,
                                device=prob.device)}


def generate(sizes: dict, seed: int, device) -> dict:
    """{table name: table} at ``sizes`` (a configuration's n_orders,
    lines_per_order, n_parts, n_suppliers, n_customers and n_nations) on
    ``device``, from ``seed``."""
    dev = torch.device(device)
    gen = generator(seed, dev)
    n_orders = int(sizes["n_orders"])
    lines = int(sizes["lines_per_order"])
    n_parts = int(sizes["n_parts"])
    n_supp = int(sizes["n_suppliers"])
    n_cust = int(sizes["n_customers"])
    n_nat = int(sizes["n_nations"])
    if n_supp < 4 or n_supp > 1 << PSKEY_SHIFT:
        raise ValueError(f"n_suppliers must lie in [4, {1 << PSKEY_SHIFT}]"
                         f" (4 distinct suppliers a part; ps_pskey packs "
                         f"the supplier into {PSKEY_SHIFT} bits), got "
                         f"{n_supp}")
    i64 = dict(dtype=torch.int64, device=dev, generator=gen)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), **i64)

    def probs(n):
        return torch.rand((n,), dtype=torch.float32, device=dev,
                          generator=gen)

    def keys(n):
        return torch.arange(n, dtype=torch.int64, device=dev)

    out = {}
    out["nation"] = _table({"n_nationkey": keys(n_nat),
                            "n_name": keys(n_nat)}, probs(n_nat))
    out["supplier"] = _table({"s_suppkey": keys(n_supp),
                              "s_nationkey": ints(0, n_nat, n_supp),
                              "s_name": keys(n_supp),
                              "s_address": keys(n_supp)}, probs(n_supp))
    out["part"] = _table({"p_partkey": keys(n_parts),
                          "p_name_forest": probs(n_parts) < 0.1,
                          "p_retailprice": ints(100, 2000, n_parts)},
                         probs(n_parts))
    # 4 distinct suppliers a part: the 4 smallest of a uniform row, in
    # row blocks of at most _PARTSUPP_ELEMS draws.
    block = max(1, _PARTSUPP_ELEMS // n_supp)
    ps_supp = torch.cat([
        torch.rand((min(block, n_parts - lo), n_supp), device=dev,
                   generator=gen).topk(4, dim=1, largest=False).indices
        for lo in range(0, n_parts, block)]).reshape(-1)
    ps_part = keys(n_parts).repeat_interleave(4)
    n_ps = 4 * n_parts
    out["partsupp"] = _table({"ps_partkey": ps_part, "ps_suppkey": ps_supp,
                              "ps_availqty": ints(1, 1000, n_ps),
                              "ps_pskey": (ps_part << PSKEY_SHIFT) + ps_supp},
                             probs(n_ps))
    out["customer"] = _table({"c_custkey": keys(n_cust),
                              "c_mktsegment": ints(0, 5, n_cust)},
                             probs(n_cust))
    out["orders"] = _table({
        "o_orderkey": keys(n_orders),
        "o_custkey": ints(0, n_cust, n_orders),
        "o_orderdate": ints(DAY0_1995 - 800, DAY0_1995 + 800, n_orders),
        "o_totalprice": ints(1000, 100000, n_orders)}, probs(n_orders))
    n_li = n_orders * lines
    l_part = ints(0, n_parts, n_li)
    l_supp = ps_supp[l_part * 4 + ints(0, 4, n_li)]
    out["lineitem"] = _table({
        "l_orderkey": keys(n_orders).repeat_interleave(lines),
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_pskey": (l_part << PSKEY_SHIFT) + l_supp,
        "l_quantity": ints(1, 51, n_li),
        "l_extendedprice": ints(100, 10000, n_li),
        "l_discount": ints(0, 11, n_li),
        "l_shipdate": ints(DAY0_1995 - 900, DAY0_1995 + 900, n_li),
        "l_returnflag": ints(0, 3, n_li),
        "l_linestatus": ints(0, 2, n_li)}, probs(n_li))
    return out
