"""The port's relational operators and UDA layer against the JAX package
on the same numpy inputs: group ids, key representatives and fk_join
exactly; UDA accumulation over the canonical chunk grid in float64 to
rtol=1e-9; the physical planner's ``explain`` text identically."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import uda as juda
from repro.db import operators as jops
from repro.db import physical as jphys
from repro.db import tpch as jtpch
from repro.db.table import Table as JTable
from repro_torch.core import uda as tuda
from repro_torch.db import operators as tops
from repro_torch.db import physical as tphys
from repro_torch.db import tpch as ttpch
from repro_torch.db.table import Table as TTable


def _tables(cols, prob, valid):
    jt = JTable.from_columns({k: jnp.asarray(v) for k, v in cols.items()},
                             jnp.asarray(prob), jnp.asarray(valid))
    tt = TTable.from_numpy(cols, prob, valid, device="cpu")
    return jt, tt


def _keyed(rng, n, kmax):
    cols = {"a": rng.integers(0, kmax, n), "b": rng.integers(0, 3, n),
            "f": rng.uniform(0, 1, n) < 0.5}
    return _tables(cols, rng.uniform(0, 1, n), rng.uniform(0, 1, n) < 0.8)


@pytest.mark.parametrize("n,kmax,max_groups,keys", [
    (500, 40, 256, ("a",)), (500, 40, 64, ("a", "b")),   # 64 < live groups
    (300, 5, 16, ("b", "f")), (64, 2, 1, ("a",)),
])
def test_group_ids_and_keys_match_jax(rng, n, kmax, max_groups, keys):
    jt, tt = _keyed(rng, n, kmax)
    jids, jcodes, jvalid = jops.group_ids(jt, list(keys), max_groups)
    tids, tcodes, tvalid = tops.group_ids(tt, list(keys), max_groups)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    jk = jops.group_key_columns(jt, list(keys), jids, max_groups)
    tk = tops.group_key_columns(tt, list(keys), tids, max_groups)
    for k in keys:
        np.testing.assert_array_equal(tk[k].numpy(), np.asarray(jk[k]))


def test_merge_group_codes_truncates_and_pads():
    codes = torch.tensor([9, 3, 3, 7, tops.BIG, 1])
    np.testing.assert_array_equal(tops.merge_group_codes(codes, 3).numpy(),
                                  [1, 3, 7])
    np.testing.assert_array_equal(tops.merge_group_codes(codes, 7).numpy(),
                                  [1, 3, 7, 9, tops.BIG, tops.BIG, tops.BIG])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fk_join_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nr, nl = 60, 400
    right = {"rk": rng.permutation(200)[:nr], "x": rng.integers(0, 9, nr),
             "y": rng.uniform(0, 1, nr)}
    left = {"lk": rng.integers(0, 200, nl), "z": rng.integers(0, 5, nl)}
    jr, tr = _tables(right, rng.uniform(0, 1, nr), rng.uniform(0, 1, nr) < .7)
    jl, tl = _tables(left, rng.uniform(0, 1, nl), rng.uniform(0, 1, nl) < .9)
    jo = jops.fk_join(jl, jr, "lk", "rk", ["x", "y"])
    to = tops.fk_join(tl, tr, "lk", "rk", ["x", "y"])
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_array_equal(to.prob.numpy(), np.asarray(jo.prob))
    for k in ("lk", "z", "x", "y"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))


def test_general_join_cross_product_matches_jax():
    """The cross-product case of tests/test_operators.py: |L| x |R| pairs,
    p = px * py (Table I row IV)."""
    ja, ta = _tables({"x": np.array([1, 2])}, np.array([0.5, 0.6]),
                     np.ones(2, bool))
    jb, tb = _tables({"y": np.array([7, 8, 9])}, np.array([0.1, 0.2, 0.3]),
                     np.ones(3, bool))
    jo = jops.general_join(ja, jb, lambda l, r, i, j: jnp.ones_like(i, bool),
                           ["y"])
    to = tops.general_join(ta, tb, lambda l, r, i, j: torch.ones_like(
        i, dtype=torch.bool), ["y"])
    assert to.capacity == jo.capacity == 6
    np.testing.assert_array_equal(to.prob.numpy(), np.asarray(jo.prob))
    np.testing.assert_allclose(to.prob.numpy(), np.outer(
        [0.5, 0.6], [0.1, 0.2, 0.3]).reshape(-1), rtol=1e-15)
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    for k in ("x", "y"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))


@pytest.mark.parametrize("seed", [0, 1])
def test_general_join_theta_matches_jax(seed):
    """A conditional theta join (l.a < r.b and r.c even) with a suffix and
    invalid rows on both sides: same pairs, columns, p and validity."""
    rng = np.random.default_rng(seed)
    nl, nr = 9, 6
    jl, tl = _tables({"a": rng.integers(0, 10, nl)}, rng.uniform(0, 1, nl),
                     np.arange(nl) != 2)
    right = {"b": rng.integers(0, 10, nr), "c": np.arange(nr) % 3}
    jr, tr = _tables(right, rng.uniform(0, 1, nr), np.arange(nr) != 1)

    def cond(l, r, i, j):
        return (l["a"][i] < r["b"][j]) & (r["c"][j] % 2 == 0)
    jo = jops.general_join(jl, jr, cond, ["b", "c"], suffix="_r")
    to = tops.general_join(tl, tr, cond, ["b", "c"], suffix="_r")
    assert sorted(to.columns) == sorted(jo.columns) == ["a", "b_r", "c_r"]
    assert 0 < int(to.valid.sum()) < nl * nr
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_array_equal(to.prob.numpy(), np.asarray(jo.prob))
    for k in to.columns:
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))


def test_uda_merge_matches_jax(rng):
    """uda.merge of two accumulated state dicts, float64, against the JAX
    package's (rtol=1e-9, as the accumulate parity below)."""
    n, g = 300, 5
    p, v = rng.uniform(0, 1, n), rng.integers(0, 30, n)
    ids = rng.integers(0, g, n)
    halves = (slice(0, 170), slice(170, n))
    js = [juda.accumulate(_udas(juda), jnp.asarray(p[h]), jnp.asarray(v[h]),
                          jnp.asarray(ids[h]), max_groups=g) for h in halves]
    ts = [tuda.accumulate(_udas(tuda), torch.from_numpy(p[h]),
                          torch.from_numpy(v[h]), torch.from_numpy(ids[h]),
                          max_groups=g) for h in halves]
    jm = juda.merge(_udas(juda), *js)
    tm = tuda.merge(_udas(tuda), *ts)
    assert sorted(tm) == sorted(jm)
    for name in jm:
        for a, b in zip(tm[name], jm[name]):
            b = np.asarray(b)
            atol = (1e-12 * np.abs(b).max(axis=0) if name == "cum"
                    else 1e-12)
            np.testing.assert_array_less(np.abs(a.numpy() - b),
                                         1e-9 * np.abs(b) + atol + 1e-300,
                                         err_msg=name)


def test_contract_violations_raise():
    _, dup = _tables({"k": np.array([1, 2, 2])}, np.ones(3), np.ones(3, bool))
    _, left = _tables({"k": np.array([1])}, np.ones(1), np.ones(1, bool))
    with pytest.raises(ValueError, match="duplicate valid keys"):
        tops.fk_join(left, dup, "k", "k", [])
    _, neg = _tables({"k": np.array([0, -1])}, np.ones(2), np.ones(2, bool))
    with pytest.raises(ValueError, match="negative"):
        tops.group_ids(neg, ["k"], 4)


def _udas(mod):
    return {"conf": mod.AtLeastOne(), "norm": mod.SumNormal(),
            "cum": mod.SumCumulants(8), "cf": mod.SumCF(64, 8, 40)}


@pytest.mark.parametrize("n,max_groups,chunks", [(1000, 7, 8), (333, 1, 3),
                                                 (2048, 64, 5)])
def test_accumulate_chunked_matches_jax_f64(rng, n, max_groups, chunks):
    """float64 (no kernel is eligible): the blocked loop and the canonical
    fold against the JAX package's."""
    p = rng.uniform(0, 1, n)
    v = rng.integers(0, 30, n)
    g = rng.integers(0, max_groups, n)
    js = juda.accumulate_chunked(_udas(juda), jnp.asarray(p), jnp.asarray(v),
                                 jnp.asarray(g), max_groups=max_groups,
                                 num_chunks=chunks)
    ts = tuda.accumulate_chunked(_udas(tuda), torch.from_numpy(p),
                                 torch.from_numpy(v), torch.from_numpy(g),
                                 max_groups=max_groups, num_chunks=chunks)
    for name in js:
        for a, b in zip(ts[name], js[name]):
            b = np.asarray(b)
            # High cumulant orders cancel (v^8 ~ 1e11 against sums ~1e2
            # smaller), so their columns get an absolute floor at 1e-12 of
            # the column's largest magnitude.
            atol = (1e-12 * np.abs(b).max(axis=0) if name == "cum"
                    else 1e-12)
            np.testing.assert_array_less(np.abs(a.numpy() - b),
                                         1e-9 * np.abs(b) + atol + 1e-300,
                                         err_msg=name)


def test_kernel_route_f32_matches_jax_scan(rng):
    """float32 with enough tuples: the port routes cumulants and CF to the
    kernels' plain versions on the CPU, the JAX package (off the TPU) to
    its blocked scan; both reach the same state within f32 bounds."""
    n, mg = 4096, 6
    p = rng.uniform(0, 1, n).astype(np.float32)
    v = rng.integers(0, 30, n)
    g = rng.integers(0, mg, n)
    udas = lambda m: {"cum": m.SumCumulants(4), "cf": m.SumCF(128, 0, 128)}
    js = juda.accumulate_chunked(udas(juda), jnp.asarray(p), jnp.asarray(v),
                                 jnp.asarray(g), max_groups=mg)
    ts = tuda.accumulate_chunked(udas(tuda), torch.from_numpy(p),
                                 torch.from_numpy(v), torch.from_numpy(g),
                                 max_groups=mg)
    np.testing.assert_allclose(ts["cum"].terms.numpy(),
                               np.asarray(js["cum"].terms), rtol=2e-4,
                               atol=1e-2)
    np.testing.assert_allclose(ts["cf"].log_abs.numpy(),
                               np.asarray(js["cf"].log_abs), atol=5e-3)
    d = ts["cf"].angle.numpy() - np.asarray(js["cf"].angle)
    assert np.abs(np.mod(d + np.pi, 2 * np.pi) - np.pi).max() < 5e-3


@pytest.mark.parametrize("leaves", [1, 2, 3, 5, 8, 11])
def test_tree_fold_shape_matches_jax(leaves):
    """The fold tree is the reference's: record it with a string merge."""
    class Rec:
        def merge(self, a, b):
            return f"({a}+{b})"
    parts = [str(i) for i in range(leaves)]
    assert tuda.tree_fold(Rec(), parts) == juda.tree_fold(Rec(), parts)


PLANS = {
    "q1": lambda m: m.q1_plan(),
    "q3": lambda m: m.q3_plan(max_groups=4096),
    "q3_budget": lambda m: m.q3_plan(order_join_budget=100),
    "q6": lambda m: m.q6_plan(num_freq=4096),
    "q18": lambda m: m.q18_plan(max_groups=8192),
    "q20": lambda m: m.q20_plan(),
}
CAPS = dict(lineitem=6_000_000, orders=1_500_000, customer=150_000,
            part=200_000, partsupp=800_000, supplier=1_000, nation=25)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_explain_text_matches_jax(name, sharded):
    kw = dict(n_shards=4 if sharded else 1, sharded=sharded)
    want = jphys.explain(jphys.lower_plan(PLANS[name](jtpch), CAPS, **kw))
    got = tphys.explain(tphys.lower_plan(PLANS[name](ttpch), CAPS, **kw))
    assert got == want
