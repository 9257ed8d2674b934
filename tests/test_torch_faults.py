"""Self-healing execution in the port: the ExecutionReport diagnostics,
the RetryPolicy escalation ladder and fault-tolerant wave resume
(``repro_torch.db.report``, ``repro_torch.db.plans.run_plan``,
``repro_torch.testing.faults``).

Each case runs the same plan on the same numpy tables (float64) through
the port and through the JAX package and holds the port's report fields,
attempt count and ``final_params`` (and fault logs) against the JAX
package's; counts and labels are equal, truncation masses agree within
the float64 tolerances of tests/test_torch_tpch.py.  Inside the port a
converged result equals a first run at ``final_params`` bit for bit.  The
JAX side runs under ``jax.jit`` where it can be traced (resident plans);
its streamed runs are host loops and run as they are.
"""
import jax
import numpy as np
import pytest
import torch

from repro.db import plans as JP
from repro.db import tpch as jtpch
from repro.testing import faults as jfaults
from repro_torch.db import plans as TP
from repro_torch.db import tpch
from repro_torch.db.plans import (GroupAgg, RetryExhausted, RetryPolicy,
                                  Scan, compile_plan, run_plan)
from repro_torch.db.report import ExecutionReport, nan_count
from repro_torch.testing import faults

pytestmark = pytest.mark.faults

TINY = dict(n_orders=48, lines_per_order=4, n_parts=24, n_suppliers=8,
            n_customers=24, seed=0)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def dbs():
    """The JAX package's tiny tables and the same arrays in the port."""
    jdb = jtpch.generate(**TINY)
    arrays = {name: dict(columns={k: np.asarray(v)
                                  for k, v in t.columns.items()},
                         prob=np.asarray(t.prob), valid=np.asarray(t.valid))
              for name, t in jdb.tables().items()}
    return jdb, tpch.from_numpy(arrays, device="cpu")


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}.{k}")
    elif isinstance(x, tuple):
        for i, y in enumerate(x):
            yield from _leaves(y, f"{path}[{i}]")
    elif hasattr(x, "columns"):
        yield from _leaves(dict(x.columns, p=x.prob, valid=x.valid), path)
    else:
        yield path, x.numpy()


def _assert_biteq(ref, got):
    a, b = list(_leaves(ref)), list(_leaves(got))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, path
        if np.issubdtype(x.dtype, np.floating):
            assert ((x == y) | (np.isnan(x) & np.isnan(y))).all(), path
        else:
            np.testing.assert_array_equal(x, y, err_msg=path)


def _assert_report_matches(got: ExecutionReport, want):
    """Port report against the JAX package's: same labels, equal counts,
    waves and final_params; tail masses within float64 tolerance."""
    for f in ("exchange_overflow", "exchange_demand", "exchange_capacity",
              "group_overflow", "state_nan"):
        g, w = getattr(got, f), getattr(want, f)
        assert sorted(g) == sorted(w), f
        for k in w:
            assert int(g[k]) == int(w[k]), (f, k)
    assert sorted(got.tail_mass) == sorted(want.tail_mass)
    for k, w in want.tail_mass.items():
        np.testing.assert_allclose(got.tail_mass[k].numpy(), np.asarray(w),
                                   rtol=1e-9, atol=1e-12, err_msg=k)
    assert got.waves == want.waves
    assert got.final_params == want.final_params
    assert got.issues().keys() == want.issues().keys()


# ===================================================== clean-path report
def test_clean_run_report_is_clean_and_free(dbs):
    """Happy path: the report flags nothing and collecting it changes no
    bit (the clean reports of the escalation and streamed cases below
    are held against the JAX package's)."""
    tdb = dbs[1]
    keys = ("l_returnflag", "l_linestatus")
    root = GroupAgg(Scan("lineitem"), keys, "l_quantity", "SUM", 8, "normal")
    ref = compile_plan(root)(tdb.tables())
    out, rep = compile_plan(root, with_report=True)(tdb.tables())
    _assert_biteq(ref, out)
    assert rep.issues() == {} and rep.ok() and rep.describe() == "clean"
    assert rep.overflow_total() == 0 and rep.max_tail_mass() == 0.0
    assert sorted(rep.state_nan) == ["agg:groupagg[0].confidence",
                                     "agg:groupagg[0].sum"]
    assert rep.host_values()["state_nan"] == {
        "agg:groupagg[0].confidence": 0, "agg:groupagg[0].sum": 0}


def test_nan_count_and_one_copy_readback():
    """nan_count counts NaN only (not the +-inf of MinMax padding and
    p = 1 tuples); host_values reads every field in one copy."""
    st = (torch.tensor([1.0, float("nan"), float("inf")]),
          torch.tensor([[float("-inf"), float("nan")]]),
          torch.tensor([3, 4]))
    assert int(nan_count(st)) == 2
    rep = ExecutionReport(group_overflow={"a": torch.tensor(3)},
                          tail_mass={"t": torch.tensor([0.0, 0.25, 0.5])},
                          state_nan={"s": nan_count(st)})
    h = rep.host_values()
    assert h["group_overflow"] == {"a": 3} and h["state_nan"] == {"s": 2}
    assert h["tail_mass"] == {"t": 0.5}
    assert rep.issues(tail_tol=0.4) == {"group_overflow": {"a": 3},
                                        "tail": {"t": 0.5},
                                        "nan": {"s": 2}}


def test_minmax_tail_mass_surfaced(dbs):
    """The §V-B.2 truncation mass is a per-group result of q18_topk and a
    report signal: 0 when kappa covers every distinct value, positive
    when it truncates, gated by tail_tol; per group the JAX package's."""
    tdb = dbs[1]
    wide = tpch.q18_topk(tdb, max_groups=64, kappa=50)
    assert torch.equal(wide["tail_mass"], torch.zeros(64, dtype=torch.float64))
    narrow = tpch.q18_topk(tdb, max_groups=64, kappa=1)
    tails, valid = narrow["tail_mass"], narrow["valid"]
    assert (tails[valid] > 0).any() and (tails >= 0).all()
    def root(L):
        return L.GroupAgg(L.Scan("lineitem"), ("l_orderkey",), "l_quantity",
                          "MAX", 64, kappa=1)
    _, jrep = jax.jit(JP.compile_plan(root(JP), with_report=True))(
        dbs[0].tables())
    _, rep = compile_plan(root(TP), with_report=True)(tdb.tables())
    assert torch.equal(rep.tail_mass["agg:groupagg[0].minmax"], tails)
    assert rep.max_tail_mass() > 0 and "tail" in rep.issues()
    assert rep.issues(tail_tol=1.0) == {}
    _assert_report_matches(rep, jrep)


# ================================================== escalation ladder
def _ladder(dbs, root_of, max_attempts):
    """run_plan in both packages (the JAX side jitted)."""
    jdb, tdb = dbs
    jout, jrep = JP.run_plan(root_of(JP), jdb.tables(), jit=True,
                             policy=JP.RetryPolicy(max_attempts=max_attempts))
    out, rep = run_plan(root_of(TP), tdb.tables(),
                        policy=RetryPolicy(max_attempts=max_attempts))
    _assert_report_matches(rep, jrep)
    return out, rep


def test_kappa_escalation_converges_bit_equal(dbs):
    """Tail mass above tolerance -> kappa doubles until exact; the healed
    answer equals a first run at the final kappa bit for bit."""
    out, rep = _ladder(dbs, lambda L: L.GroupAgg(
        L.Scan("lineitem"), ("l_orderkey",), "l_quantity", "MAX", 64,
        kappa=2), 6)
    scale = rep.final_params["kappa_scale"]
    assert rep.waves["attempts"] > 1 and scale > 1
    assert rep.max_tail_mass() == 0.0
    ref = compile_plan(GroupAgg(Scan("lineitem"), ("l_orderkey",),
                                "l_quantity", "MAX", 64,
                                kappa=2 * scale))(dbs[1].tables())
    _assert_biteq(ref, out)


def test_group_overflow_escalation(dbs):
    """48 live orders into a 16-entry group-code table: the lost rows are
    counted and max_groups doubles until nothing is lost."""
    root = GroupAgg(Scan("lineitem"), ("l_orderkey",), "l_quantity", "SUM",
                    16, "normal")
    _, rep = compile_plan(root, with_report=True)(dbs[1].tables())
    assert "group_overflow" in rep.issues()
    out, rep2 = _ladder(dbs, lambda L: L.GroupAgg(
        L.Scan("lineitem"), ("l_orderkey",), "l_quantity", "SUM", 16,
        "normal"), 4)
    assert rep2.issues() == {}
    scale = rep2.final_params["groups_scale"]
    assert scale >= 4                            # 16 -> 64 holds 48 groups
    ref = compile_plan(GroupAgg(Scan("lineitem"), ("l_orderkey",),
                                "l_quantity", "SUM", 16 * scale,
                                "normal"))(dbs[1].tables())
    _assert_biteq(ref, out)


def test_retry_exhausted_carries_report(dbs):
    """Out of attempts with the group table still overflowing: the error
    carries the last report, whose lost-row count is the JAX package's."""
    jdb, tdb = dbs
    with pytest.raises(JP.RetryExhausted) as jei:
        JP.run_plan(JP.GroupAgg(JP.Scan("lineitem"), ("l_orderkey",),
                                "l_quantity", "SUM", 16, "normal"),
                    jdb.tables(), jit=True,
                    policy=JP.RetryPolicy(max_attempts=1))
    with pytest.raises(RetryExhausted) as ei:
        run_plan(GroupAgg(Scan("lineitem"), ("l_orderkey",), "l_quantity",
                          "SUM", 16, "normal"), tdb.tables(),
                 policy=RetryPolicy(max_attempts=1))
    assert ei.value.report.issues() == {
        "group_overflow": {"agg:groupagg[0]": 128}}
    _assert_report_matches(ei.value.report, jei.value.report)


# ================================================= streamed wave resume
STREAM = dict(device_row_budget=64, stream_wave_chunks=1)


def test_fault_plan_mechanics():
    """One-shot and persistent faults, no nesting, no-op hooks outside a
    plan; the same call sequence logs as in the JAX package."""
    logs = []
    for F in (jfaults, faults):
        fp = F.FaultPlan(transfer_calls={1}, exchange_calls={0},
                         transfer_rows_over=100)
        with F.inject(fp):
            F.on_transfer(0, 10)
            with pytest.raises(F.TransferFault):
                F.on_transfer(0, 10)             # one-shot occurrence 1
            F.on_transfer(1, 10)                 # consumed: passes now
            with pytest.raises(F.TransferFault):
                F.on_transfer(2, 101)            # persistent rows_over
            with pytest.raises(F.TransferFault):
                F.on_exchange()
            F.on_exchange()
            with pytest.raises(RuntimeError):
                with F.inject(F.FaultPlan()):    # no nesting
                    pass
        assert fp.consumed()
        F.on_transfer(0, 10 ** 9)                # no-ops outside a plan
        F.on_exchange()
        logs.append(fp.log)
    assert logs[0] == logs[1]
    assert [f for *_x, f in logs[1]] == [False, True, False, True]


def test_transient_fault_resumes_bit_equal(dbs):
    """A slab-copy fault re-ships ONLY the faulted wave (no completed wave
    re-streamed) and the result equals the fault-free run, for the
    plain-aggregate (Q1) and exact-CF (Q6) streamed shapes; the transfer
    log is the JAX package's (its Q1 run), occurrence for occurrence."""
    jdb, tdb = dbs
    with jfaults.inject(jfaults.FaultPlan(transfer_calls={10})) as jfp:
        jtpch.q1(jdb, "aggregate", plan_opts=STREAM)
    for qname, kw in (("q1", {}), ("q6", dict(num_freq=256))):
        call = tpch.QUERIES[qname]
        ref = call(tdb, "aggregate", **kw)
        # 8 waves per phase: occurrence 10 is phase B, wave 2
        with faults.inject(faults.FaultPlan(transfer_calls={10})) as fp:
            got = call(tdb, "aggregate", plan_opts=dict(STREAM, **CPU),
                       **kw)
        assert fp.consumed(), qname
        _assert_biteq(ref, got)
        assert fp.log == jfp.log, qname
        (fi, fw), = [(i, w) for i, w, _r, f in fp.log if f]
        assert fp.log[fi + 1][1] == fw           # the same wave re-ships


@pytest.mark.parametrize("occ", [1, 9, 12, 15])
def test_fault_during_prefetch_no_double_file(dbs, occ):
    """A fault on the slab copy that is prefetched while the wave before
    it computes: the retry ships the same wave and no chunk is filed
    twice (ChunkStateAccumulator raises on that); result unchanged."""
    tdb = dbs[1]
    ref = tpch.q1(tdb, "aggregate")
    with faults.inject(faults.FaultPlan(transfer_calls={occ})) as fp:
        got = tpch.q1(tdb, "aggregate", plan_opts=dict(STREAM, **CPU))
    assert fp.consumed()
    _assert_biteq(ref, got)
    ships = list(range(8)) * 2                   # phase A, then phase B
    assert [w for _i, w, _r, _f in fp.log] == \
        ships[:occ] + [ships[occ]] + ships[occ:]


def test_fault_exhausts_inloop_retries_annotated(dbs):
    """A persistent fault escapes after stream_wave_retries re-ships,
    annotated with the halved wave size, as in the JAX package."""
    jdb, tdb = dbs
    opts = dict(device_row_budget=64, stream_wave_chunks=4)
    with jfaults.inject(jfaults.FaultPlan(transfer_rows_over=50)) as jfp:
        with pytest.raises(jfaults.TransferFault) as jei:
            jtpch.q1(jdb, "aggregate", plan_opts=opts)
    with faults.inject(faults.FaultPlan(transfer_rows_over=50)) as fp:
        with pytest.raises(faults.TransferFault) as ei:
            tpch.q1(tdb, "aggregate", plan_opts=dict(opts, **CPU))
    assert ei.value.wave_chunks == 2 and not ei.value.at_minimum
    assert (ei.value.wave_chunks, ei.value.at_minimum) == \
        (jei.value.wave_chunks, jei.value.at_minimum)
    assert fp.log == jfp.log and len(fp.log) == 3


def test_wave_halving_retry(dbs):
    """Persistent too-big-transfer fault (96-row waves fail, 48-row waves
    pass): run_plan re-lowers with the halved wave; attempts, waves and
    final_params are the JAX package's, and the result equals a first run
    at the final wave size and the resident run, bit for bit."""
    jdb, tdb = dbs
    keys = ("l_returnflag", "l_linestatus")
    opts = dict(device_row_budget=64, stream_wave_chunks=4)
    with jfaults.inject(jfaults.FaultPlan(transfer_rows_over=50)):
        _, jrep = JP.run_plan(JP.GroupAgg(JP.Scan("lineitem"), keys,
                                          "l_quantity", "SUM", 8, "normal"),
                              jdb.tables(),
                              policy=JP.RetryPolicy(max_attempts=4), **opts)
    root = GroupAgg(Scan("lineitem"), keys, "l_quantity", "SUM", 8, "normal")
    with faults.inject(faults.FaultPlan(transfer_rows_over=50)):
        out, rep = run_plan(root, tdb.tables(),
                            policy=RetryPolicy(max_attempts=4), **opts,
                            **CPU)
    assert rep.waves["attempts"] == 2
    assert rep.final_params["stream_wave_chunks"] == 2
    _assert_report_matches(rep, jrep)
    first = compile_plan(root, device_row_budget=64, stream_wave_chunks=2,
                         **CPU)(tdb.tables())
    _assert_biteq(first, out)
    _assert_biteq(compile_plan(root)(tdb.tables()), out)


def test_streamed_report_counts_waves_and_retries(dbs):
    """A streamed run's report: waves completed/total and the in-loop
    re-ships, as the JAX package counts them, and a clean diagnosis."""
    jdb, tdb = dbs
    opts = dict(device_row_budget=64, stream_wave_chunks=1)
    with jfaults.inject(jfaults.FaultPlan(transfer_calls={3, 11})):
        _, jrep = JP.compile_plan(jtpch.q1_plan(), with_report=True,
                                  **opts)(jdb.tables())
    with faults.inject(faults.FaultPlan(transfer_calls={3, 11})):
        _, rep = compile_plan(tpch.q1_plan(), with_report=True, **opts,
                              **CPU)(tdb.tables())
    assert rep.waves == dict(completed=16, total=16, retries=2)
    assert rep.issues() == {}
    _assert_report_matches(rep, jrep)
