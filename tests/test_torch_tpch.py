"""The whole slice, port against the JAX package: TPC-H Q1/Q3/Q6/Q18/Q20
in all four modes (plus Q6 with ``num_freq`` and Q18 ``method="exact"``),
on the same tables carried across as numpy arrays, in float64 (x64 is on
through tests/conftest.py; the port keeps the arrays' float64).

Keys, validity masks and group ids must be exactly equal; floats agree
within rtol=1e-9, atol=1e-12 — the two packages sum in different orders.
Also: the port's generator draws the JAX generator's tables, and its
default device is the card, with no CPU fallback."""
import numpy as np
import pytest
import torch

from repro.db import tpch as jtpch
from repro_torch.db import tpch as ttpch

N_ORDERS = 120


def _arrays(db):
    return {name: dict(columns={k: np.asarray(v)
                                for k, v in t.columns.items()},
                       prob=np.asarray(t.prob), valid=np.asarray(t.valid))
            for name, t in db.tables().items()}


@pytest.fixture(scope="module")
def dbs():
    jdb = jtpch.generate(n_orders=N_ORDERS, seed=3)
    return jdb, ttpch.from_numpy(_arrays(jdb), device="cpu",
                                 scale=jdb.scale)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_same(got, want, path="out"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating):
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                   err_msg=path)
    else:
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("mode", jtpch.MODES)
@pytest.mark.parametrize("query", sorted(jtpch.QUERIES))
def test_query_matches_jax(dbs, query, mode):
    jdb, tdb = dbs
    _assert_same(ttpch.QUERIES[query](tdb, mode),
                 jtpch.QUERIES[query](jdb, mode))


@pytest.mark.parametrize("query,kwargs", [
    ("q6", dict(num_freq=2048)),
    ("q18", dict(method="exact", num_freq=256, max_groups=512)),
    ("q18", dict(method="exact", num_freq=256, max_groups=512,
                 plan_opts=dict(cf_budget_elems=2 * 512 * 100))),
])
def test_exact_cf_matches_jax(dbs, query, kwargs):
    """Exact-CF aggregates, including a slab budget that splits Q18's
    frequency grid into three passes (100 + 100 + 56 frequencies)."""
    jdb, tdb = dbs
    _assert_same(ttpch.QUERIES[query](tdb, "aggregate", **kwargs),
                 jtpch.QUERIES[query](jdb, "aggregate", **kwargs))


def test_generate_matches_jax():
    """Same tables for the same arguments and seed, with a block size
    that splits the partsupp draw into uneven row blocks."""
    kw = dict(n_orders=50, n_parts=37, n_suppliers=23, n_customers=40,
              seed=11)
    jdb = jtpch.generate(**kw)
    tdb = ttpch.generate(**kw, device="cpu", partsupp_block_rows=5)
    assert tdb.scale == jdb.scale
    for name, jt in jdb.tables().items():
        tt = tdb.tables()[name]
        assert sorted(tt.columns) == sorted(jt.columns)
        for k, v in jt.columns.items():
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(v),
                                          err_msg=f"{name}.{k}")
        np.testing.assert_array_equal(
            tt.prob.numpy(), np.asarray(jt.prob).astype(np.float32))
        np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))


def test_default_device_is_the_card():
    """An entry point left at its default device raises on a host with no
    card instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttpch.generate(n_orders=8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttpch.from_numpy({}, device="cuda")
