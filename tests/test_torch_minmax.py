"""MIN/MAX, port against the JAX package on the same numpy inputs: the
grouped ``uda.MinMax`` (accumulate from a fresh and from a given state,
the chunked fold, merge, finalize, ``p_empty``, ``tail_mass``) on groups
with duplicate values and kappa below the distinct count,
``operators.group_minmax`` and ``cf_greater``, and ``tpch.q18_topk`` at
kappa 8 and 2.  Float64 (x64 is on through tests/conftest.py) to
rtol=1e-9, atol=1e-12; values, validity and group ids exactly.  The JAX
side runs under ``jax.jit`` (one compile instead of one per primitive)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import uda as juda
from repro.db import operators as jops
from repro.db import tpch as jtpch
from repro.db.plans import GroupAgg, Scan, compile_plan
from repro.db.table import Table as JTable
from repro_torch.core import uda as tuda
from repro_torch.db import operators as tops
from repro_torch.db import tpch as ttpch
from repro_torch.db.table import Table as TTable
from test_torch_tpch import N_ORDERS, _arrays, _assert_same

G, KAPPA = 7, 3


@pytest.fixture(scope="module")
def column():
    """200 tuples over 7 groups with values 0..9: duplicate (group, value)
    runs, more distinct values per group than kappa, some p = 0."""
    rng = np.random.default_rng(21)
    p = rng.uniform(0, 1, 200)
    p[rng.uniform(0, 1, 200) < 0.1] = 0.0
    return p, rng.integers(0, 10, 200).astype(float), rng.integers(0, G, 200)


def _run(mod, p, v, g):
    """Fresh accumulate, accumulate onto a given state (a merge), the
    3-chunk fold, and every epilogue."""
    u = mod.MinMax(kappa=KAPPA, sign=-1.0)
    fresh = mod.accumulate({"m": u}, p[:120], v[:120], g[:120],
                           max_groups=G)["m"]
    cont = mod.accumulate({"m": u}, p[120:], v[120:], g[120:], max_groups=G,
                          states={"m": fresh})["m"]
    chunked = mod.accumulate_chunked({"m": u}, p, v, g, max_groups=G,
                                     num_chunks=3)["m"]
    return (fresh, cont, chunked, u.finalize(cont), u.p_empty(cont),
            u.tail_mass(cont), u.tail_mass(chunked))


def test_minmax_uda_matches_jax(column):
    p, v, g = column
    want = jax.jit(lambda *a: _run(juda, *a))(p, v, g.astype(np.int32))
    got = _run(tuda, *(torch.from_numpy(x) for x in column))
    _assert_same(got, tuple(want))
    values = got[1].values
    assert bool(torch.isfinite(values).all(1).any())   # kappa filled
    assert float(got[5].max()) > 0                     # truncation live
    # The continued state equals one accumulate over the whole column.
    whole = tuda.accumulate({"m": tuda.MinMax(KAPPA, -1.0)},
                            *(torch.from_numpy(x) for x in column),
                            max_groups=G)["m"]
    _assert_same(whole, got[1])


def test_group_minmax_and_cf_greater_match_jax(column):
    p, v, g = column
    valid = p > 0.05
    jt = JTable.from_columns({"v": v}, p, valid)
    tt = TTable.from_numpy({"v": v}, p, valid, device="cpu")

    def run(ops, t, ids):
        la, an = ops.group_logcf(t, t["v"].astype(np.int32)
                                 if ops is jops else t["v"].long(), ids, G,
                                 num_freq=64)
        thr = np.arange(G) * 3.0
        return (ops.group_minmax(t, t["v"], ids, G, sign=1.0),
                ops.cf_greater(la, an, thr if ops is jops
                               else torch.from_numpy(thr)))

    want = jax.jit(lambda t, ids: run(jops, t, ids))(jt, g.astype(np.int32))
    got = run(tops, tt, torch.from_numpy(g))
    _assert_same(got, want)


@pytest.fixture(scope="module")
def dbs():
    jdb = jtpch.generate(n_orders=N_ORDERS, seed=3)
    return jdb, ttpch.from_numpy(_arrays(jdb), device="cpu",
                                 scale=jdb.scale)


@pytest.mark.parametrize("kappa", [8, 2])
def test_q18_topk_matches_jax(dbs, kappa):
    """The port's entry point against the JAX q18_topk plan (its result
    dict is this plan's ``minmax`` runs).  At kappa 8 every order's <= 4
    values fit: no tail; at kappa 2 the tail is live."""
    jdb, tdb = dbs
    plan = GroupAgg(Scan("lineitem"), ("l_orderkey",), "l_quantity", "MAX",
                    256, kappa=kappa)
    out = jax.jit(compile_plan(plan))(jdb.tables())
    mm = out["minmax"]
    want = dict(valid=out["valid"], keys=out["keys"], **{
        k: mm[k] for k in ("run_group", "run_value", "run_mass", "run_valid",
                           "p_empty", "p_tail", "tail_mass")})
    got = ttpch.q18_topk(tdb, max_groups=256, kappa=kappa)
    _assert_same(got, want)
    tail = got["tail_mass"][got["valid"]]
    assert float(tail.max()) == 0.0 if kappa == 8 else float(tail.max()) > 0
