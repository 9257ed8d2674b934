"""The benchmark's generator: schema, value ranges, key distributions and
seed determinism."""
import torch

from portbench import datagen
from portbench.tests.tiny import tiny_config

SIZES = tiny_config("tpch_sf1")


def test_schema_and_rows():
    t = datagen.generate(SIZES, 3, "cpu")
    rows = {k: int(v["prob"].shape[0]) for k, v in t.items()}
    assert rows == {"nation": 25, "supplier": 50, "part": 400,
                    "partsupp": 1600, "customer": 300, "orders": 3000,
                    "lineitem": 12000}
    assert sorted(t["lineitem"]["columns"]) == sorted(
        ["l_orderkey", "l_partkey", "l_suppkey", "l_pskey", "l_quantity",
         "l_extendedprice", "l_discount", "l_shipdate", "l_returnflag",
         "l_linestatus"])
    for tab in t.values():
        assert tab["prob"].dtype == torch.float32
        assert bool(((tab["prob"] >= 0) & (tab["prob"] < 1)).all())
        assert bool(tab["valid"].all())


def test_value_ranges():
    c = datagen.generate(SIZES, 4, "cpu")["lineitem"]["columns"]
    day0 = datagen.DAY0_1995
    for name, lo, hi in (("l_quantity", 1, 50), ("l_extendedprice", 100,
                                                 9999),
                         ("l_discount", 0, 10), ("l_returnflag", 0, 2),
                         ("l_linestatus", 0, 1),
                         ("l_shipdate", day0 - 900, day0 + 899)):
        assert int(c[name].min()) >= lo and int(c[name].max()) <= hi, name
    assert bool((c["l_orderkey"] == torch.arange(3000).repeat_interleave(
        4)).all())


def test_four_distinct_suppliers_a_part_and_lines_use_them():
    t = datagen.generate(SIZES, 5, "cpu")
    ps = t["partsupp"]["columns"]
    supp = ps["ps_suppkey"].view(-1, 4)
    assert bool((supp.sort(1).values.diff(dim=1) > 0).all())
    assert bool((ps["ps_pskey"] == ps["ps_partkey"] * 1024
                 + ps["ps_suppkey"]).all())
    li = t["lineitem"]["columns"]
    of_part = supp[li["l_partkey"]]
    assert bool((of_part == li["l_suppkey"][:, None]).any(1).all())
    assert bool((li["l_pskey"] == li["l_partkey"] * 1024
                 + li["l_suppkey"]).all())


def test_seed_determinism():
    a = datagen.generate(SIZES, 2**31 + 12345, "cpu")
    b = datagen.generate(SIZES, 2**31 + 12345, "cpu")
    c = datagen.generate(SIZES, 2**31 + 12346, "cpu")
    for name in a:
        assert torch.equal(a[name]["prob"], b[name]["prob"])
        for k in a[name]["columns"]:
            assert torch.equal(a[name]["columns"][k], b[name]["columns"][k])
    assert not torch.equal(a["lineitem"]["prob"], c["lineitem"]["prob"])
