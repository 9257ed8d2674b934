"""The torch twins of the examples (``examples/*_torch.py``), each run
with ``--device cpu`` at a small size, its printed results held to the
JAX package's on the same inputs: the quickstart's PGF walkthrough, the
TPC-H suite's confidence and group-count lines, the out-of-core query's
per-region sums, the distributed query's exact mean (two gloo ranks).

Float64 (the examples enable x64, as the JAX ones do): 1e-9 of a
quantity's scale where both sides compute it the same way; the Gamma
mixture's CDF and CI, fitted on the host from cumulant sums, to 1e-6;
the distributed query's float32 exact mean to 1e-3 of it.  The examples
switch the port to float64 when imported; each test pins the switch and
restores it after, so other tests keep float32."""
import importlib
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


@pytest.fixture
def example(monkeypatch):
    """Import ``examples/<name>.py`` with the port in float64 for the
    test (restored after)."""
    from repro_torch.core import config
    monkeypatch.setitem(config._X64, "on", True)
    monkeypatch.syspath_prepend(str(EXAMPLES))
    return importlib.import_module


def test_quickstart_twin_matches_reference(example, capsys):
    import jax.numpy as jnp
    from repro.core import approx, compare
    from repro.core import poisson_binomial as pb
    from repro.core.pgf import PGF
    got = example("quickstart_torch").main(["--device", "cpu", "--n",
                                            "2000"])
    out = capsys.readouterr().out
    assert "SUM distribution: {0: 0.03, 3: 0.07, 5: 0.03, 8: 0.19, " \
        "11: 0.28, 13: 0.12, 16: 0.28}" in out
    probs = jnp.asarray([0.7, 0.8, 0.5], jnp.float64)
    values = jnp.asarray([3.0, 8.0, 5.0], jnp.float64)
    np.testing.assert_allclose(got["count"],
                               np.asarray(pb.count_pgf(probs).coeffs),
                               rtol=0, atol=1e-12)
    fmin = PGF.bernoulli(0.7, 3, "MIN").mul_min(PGF.bernoulli(0.8, 8, "MIN"))
    np.testing.assert_allclose(got["min"], [float(fmin.mass_at(3)),
                                            float(fmin.mass_at(8)),
                                            float(fmin.p_pos_inf)],
                               atol=1e-12)
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, 2000)
    v = rng.integers(1, 10, 2000).astype(float)
    gm = approx.fit_from_data(p, v, p=3)
    na = approx.fit_normal(p, v)
    cdf = np.cumsum(np.asarray(pb.sum_pgf(jnp.asarray(p),
                                          jnp.asarray(v)).coeffs))
    s0 = int(gm.mean())
    assert got["s0"] == s0
    assert got["exact_cdf"] == pytest.approx(float(cdf[s0]), abs=1e-9)
    assert got["normal_cdf"] == pytest.approx(float(na.cdf(s0)), abs=1e-9)
    assert got["moment_cdf"] == pytest.approx(float(gm.cdf(s0)), abs=1e-6)
    assert got["ci_exact"] == float(np.searchsorted(cdf, 0.025))
    assert got["ci_moment"] == pytest.approx(
        float(gm.confidence_interval(0.95)[0]), rel=1e-6)
    assert got["p_greater"] == pytest.approx(
        float(compare.prob_greater(gm, s0 + 500)), abs=1e-6)
    assert f"n=2000: P(SUM <= mean) exact={float(cdf[s0]):.6f}" in out


def test_tpch_twin_matches_reference(example, capsys):
    import jax
    from repro.db import tpch as jtpch
    from repro.db.plans import GroupAgg, compile_plan
    got = example("tpch_probabilistic_torch").main(
        ["--device", "cpu", "--orders", "300"])
    out = capsys.readouterr().out
    rows = got["summaries"]
    assert len(rows) == 20 and out.count(" groups\n") >= 10
    db = jtpch.generate(n_orders=300, seed=0)
    conf = jax.jit(compile_plan(GroupAgg(jtpch.q18_plan(150, 2048), (), "",
                                         "COUNT", 1)))(db.tables())
    assert rows[("q18", "confidence")] \
        == f"confidence={float(conf['confidence'][0]):.4f}"
    q3 = jax.jit(compile_plan(jtpch.q3_plan()))(db.tables())
    assert rows[("q3", "aggregate")] == f"{int(q3['valid'].sum())} groups"
    assert rows[("q18", "group_confidence")] == "300 groups"


def test_out_of_core_twin_matches_reference(example, capsys):
    import jax
    from repro.db.plans import GroupAgg, Scan, Select, compile_plan
    from repro.db.table import HostTable
    got = example("out_of_core_query_torch").main(
        ["--device", "cpu", "--rows", "20000", "--budget", "1024"])
    out = capsys.readouterr().out
    assert "streamed == resident, bit for bit" in out
    assert "mmap-streamed == resident, bit for bit" in out
    assert got["stream_stats"]["waves"] > 1
    n = 20000
    rng = np.random.default_rng(0)
    fact = HostTable(
        {"region": rng.integers(0, 16, n).astype(np.int64),
         "amount": rng.integers(1, 100, n).astype(np.int64)},
        prob=rng.uniform(0.2, 1.0, n))
    plan = GroupAgg(Select(Scan("fact"), lambda t: t["amount"] > 10),
                    ("region",), "amount", "SUM", 16, "normal",
                    extra=(("count", "", "COUNT", "normal"),))
    want = jax.jit(compile_plan(plan, None, canonical_chunks=n // 500))(
        {"fact": fact.to_table()})
    s = got["streamed"]
    for name, (a, b) in dict(mu=(s["sum"][0], want["sum"][0]),
                             var=(s["sum"][1], want["sum"][1]),
                             count=(s["count"][0],
                                    want["count"][0])).items():
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-9 * np.abs(b).max(),
                                   err_msg=name)
    assert f"region 0: E[sum]={float(want['sum'][0][0]):12.2f}" in out


def test_distributed_twin_matches_reference(example, capsys):
    import jax.numpy as jnp
    from repro.core import poisson_binomial as pb
    got = example("distributed_query_torch").main(
        ["--device", "cpu", "--ranks", "2", "--tuples", "16384",
         "--orders", "120"])
    out = capsys.readouterr().out
    assert got["mesh"] == {"data": 1, "model": 2}
    assert "bit-equal to single-device = True" in out
    assert all(got[k]["bit_equal"] for k in ("sharded", "shuffle",
                                             "copartitioned"))
    assert got["copartitioned"]["collectives"].get("shuffle_back", 0) == 0
    rng = np.random.default_rng(0)
    n = 16384
    probs = rng.uniform(0, 1, n).astype(np.float32)
    values = np.zeros(n, np.float32)
    hot = rng.choice(n, 400, replace=False)
    values[hot] = rng.integers(1, 4, 400)
    exact = np.asarray(pb.sum_pgf(jnp.asarray(probs[hot], jnp.float64),
                                  jnp.asarray(values[hot], jnp.float64),
                                  max_sum=1023).coeffs)
    mean = float((exact * np.arange(exact.shape[0])).sum())
    assert got["mean_exact"] == pytest.approx(mean, rel=1e-3)
    assert got["closed_form"] == pytest.approx(
        float(jnp.sum(jnp.asarray(probs) * jnp.asarray(values))), rel=1e-6)
    assert got["mass"] == pytest.approx(1.0, abs=1e-4)


def test_twins_refuse_a_missing_card(example, monkeypatch):
    """``--device`` defaults to the card: without one, each twin raises
    before it computes anything."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart_torch", "tpch_probabilistic_torch",
                 "out_of_core_query_torch", "distributed_query_torch"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            example(name).main([])
