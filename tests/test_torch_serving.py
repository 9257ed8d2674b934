"""The query-serving layer of the port (``repro_torch.db.serving``, the
cache primitives of ``repro_torch.db.plans``, ``report.ServingStats``,
``launch/serve.py``).

Against the JAX package, on the same numpy inputs: ``plan_key`` equality
on the plan pairs of tests/test_serving.py::TestPlanKey, the LRU cache's
and the serving counters' ``info`` / ``as_dict`` after the same
operations, and both parameterized families swept in float64 against the
reference service's scan sweep (rtol 1e-9, atol 1e-12, jitted).

Inside the port the contracts are bit for bit (``torch.equal`` on every
leaf): a hit equals the cold run on the resident path, the streamed path
and a 2-rank gloo mesh (spawned once for the file); ``bind(tables)
(params)`` equals ``compiled(tables, params)``; a hit lowers nothing; two
bindings of one closure keep their own canonical capacities; a replaced
catalogue table re-binds; evicted entries die; a sweep equals sequential
submits point by point, whole or chunked; a healed plan replays in one
attempt.  The JAX package is imported inside functions only: the mesh
ranks import this module.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.db import physical as tphys
from repro_torch.db import plans as TP
from repro_torch.db import tpch
from repro_torch.db.plans import (GroupAgg, RetryPolicy, Scan, Select,
                                  compile_plan, plan_key, plan_params,
                                  run_plan)
from repro_torch.db.serving import QueryService
from repro_torch.db.table import HostTable, Table
from repro_torch.testing.ranks import run_ranks

pytestmark = pytest.mark.serving

TINY = dict(n_orders=48, lines_per_order=4, n_parts=24, n_suppliers=8,
            n_customers=24, seed=0)
CPU = dict(device="cpu")
#: lineitem (192 rows) streams past this budget; partsupp (96) and the
#: other tables stay resident.
STREAM = dict(device_row_budget=100, device="cpu")


def _arrays(jdb):
    return {name: dict(columns={k: np.asarray(v)
                                for k, v in t.columns.items()},
                       prob=np.asarray(t.prob), valid=np.asarray(t.valid))
            for name, t in jdb.tables().items()}


@pytest.fixture(scope="module")
def jax_db():
    from repro.db import tpch as jtpch
    return jtpch.generate(**TINY)


@pytest.fixture(scope="module")
def arrays(jax_db):
    return _arrays(jax_db)


def _tables(arrays):
    return tpch.from_numpy(arrays, device="cpu").tables()


@pytest.fixture
def tables(arrays):
    return _tables(arrays)


def _flat(x, path=""):
    """A result (dict / tuple / either package's Table) as {path: leaf}."""
    if hasattr(x, "columns") and hasattr(x, "prob"):
        x = dict(columns=x.columns, prob=x.prob, valid=x.valid)
    if isinstance(x, dict):
        out = {}
        for k in sorted(x):
            out.update(_flat(x[k], f"{path}.{k}"))
        return out
    if isinstance(x, tuple):
        out = {}
        for i, y in enumerate(x):
            out.update(_flat(y, f"{path}[{i}]"))
        return out
    return {path: x}


def _bit_equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        x.shape == fb[k].shape and x.dtype == fb[k].dtype
        and torch.equal(x, fb[k]) for k, x in fa.items())


def _lowerings(monkeypatch) -> list:
    """Count ``physical.lower_plan`` calls (the executor looks it up on
    the module at every lowering)."""
    calls = []
    real = tphys.lower_plan

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tphys, "lower_plan", counted)
    return calls


def _limit_plan(P, lim):
    """A Q6-like plan whose predicate captures ``lim`` (the reference's
    distinct-plans workload)."""
    return P.GroupAgg(P.Select(P.Scan("lineitem"),
                               (lambda t, lim=lim: t["l_quantity"] < lim)),
                      ("l_returnflag",), "l_quantity", "SUM", 8)


# ------------------------------------------------- parity: plan keys
def _key_pairs(P, mod):
    """name -> (plan a, plan b) of tests/test_serving.py::TestPlanKey,
    built from one package's plans module ``P`` and tpch module ``mod``."""
    def sel(lim):
        return P.Select(P.Scan("lineitem"), lambda t: t["l_quantity"] < lim)
    pairs = {f"fresh_{k}": (v, mod.serving_plans()[k])
             for k, v in mod.serving_plans().items()}
    pairs.update({
        "explicit_defaults_q3": (mod.q3_plan(), mod.q3_plan(
            segment=1, max_groups=512, order_join_budget=None)),
        "explicit_defaults_q18": (mod.q18_plan(), mod.q18_plan(
            qty_threshold=150.0, max_groups=2048)),
        "keyword_order": (
            P.GroupAgg(child=P.Scan("lineitem"), keys=("l_returnflag",),
                       value="l_quantity", agg="SUM", max_groups=8),
            P.GroupAgg(max_groups=8, agg="SUM", value="l_quantity",
                       keys=("l_returnflag",), child=P.Scan("lineitem"))),
        "same_constant": (sel(10.0), sel(10.0)),
        "captured_constants_differ": (sel(10.0), sel(11.0)),
        "predicate_logic_differs": (
            P.Select(P.Scan("lineitem"), lambda t: t["l_quantity"] < 10.0),
            P.Select(P.Scan("lineitem"), lambda t: t["l_quantity"] > 10.0)),
        "families": (mod.q6_family(), mod.q6_family()),
        "family_vs_plan": (mod.q6_family(), mod.q6_plan()),
    })
    return pairs


KEY_CASES = sorted(_key_pairs(TP, tpch))


@pytest.mark.parametrize("case", KEY_CASES)
def test_plan_key_equality_matches_reference(case):
    from repro.db import plans as JP
    from repro.db import tpch as jtpch
    a, b = _key_pairs(TP, tpch)[case]
    ja, jb = _key_pairs(JP, jtpch)[case]
    same = plan_key(a) == plan_key(b)
    assert same == (JP.plan_key(ja) == JP.plan_key(jb))
    assert same == (not case.endswith(("differ", "differs", "_vs_plan")))


def test_family_params_match_reference():
    from repro.db import plans as JP
    from repro.db import tpch as jtpch
    for name in ("q6_family", "q18_family", "q6_plan"):
        got = plan_params(getattr(tpch, name)())
        assert got == JP.plan_params(getattr(jtpch, name)()), name
    assert plan_params(tpch.q6_family()) == {"disc_lo", "disc_hi",
                                             "qty_lim"}
    assert plan_params(tpch.q18_family()) == {"qty_threshold"}


def test_captured_tensor_keys_by_identity(tables):
    """A lambda capturing a tensor keys by the tensor's identity: the same
    tensor hits, an equal-valued other tensor misses (never a false hit),
    where the reference keys a captured array by its bytes."""
    import jax.numpy as jnp
    from repro.db import plans as JP
    a, b = torch.tensor(24.0), torch.tensor(24.0)

    def sel(P, lim):
        return P.Select(P.Scan("lineitem"), lambda t: t["l_quantity"] < lim)
    assert plan_key(sel(TP, a)) == plan_key(sel(TP, a))
    assert plan_key(sel(TP, a)) != plan_key(sel(TP, b))
    assert JP.plan_key(sel(JP, jnp.asarray(24.0))) == JP.plan_key(
        sel(JP, jnp.asarray(24.0)))
    svc = QueryService(tables, **CPU)
    root = lambda lim: GroupAgg(sel(TP, lim), (), "l_quantity", "SUM", 1)
    assert not svc.submit(root(a))[1]["hit"]
    assert svc.submit(root(a))[1]["hit"]
    out_b, info_b = svc.submit(root(b))
    assert not info_b["hit"]
    assert _bit_equal(out_b, compile_plan(root(b), **CPU)(tables))


# --------------------------------------- parity: LRU cache and counters
def _lru_ops(cache_cls):
    """The same operation sequence on either package's LRUCache: the
    dropped values and ``info()`` after every step."""
    dropped = []
    c = cache_cls(2, on_evict=dropped.append)
    log = []

    def step(what, *args):
        ret = getattr(c, what)(*args)
        log.append((what, args, ret, list(dropped), c.info(), len(c),
                    "a" in c))
    step("put", "a", 1)
    step("put", "b", 2)
    step("get", "a")
    step("put", "c", 3)
    step("get", "b")
    step("get", "missing", 0)
    step("put", "a", 4)
    step("set_capacity", 4)
    for k in "defg":
        step("put", k, k)
    step("set_capacity", 1)
    step("clear")
    with pytest.raises(ValueError):
        c.set_capacity(0)
    with pytest.raises(ValueError):
        cache_cls(0)
    return log


def test_lru_cache_matches_reference():
    from repro.db import plans as JP
    got, want = _lru_ops(TP.LRUCache), _lru_ops(JP.LRUCache)
    assert got == want
    assert got[-1][4]["size"] == 0 and got[-1][4]["evictions"] == 7


def test_serving_stats_match_reference():
    from repro.db import report as JR
    from repro_torch.db import report as TR
    records = [dict(hit=False), dict(hit=True), dict(hit=True, points=4),
               dict(hit=False, attempts=3), dict(hit=True, points=1,
                                                 attempts=1)]
    got, want = TR.ServingStats(), JR.ServingStats()
    for r in records:
        got.record(**r)
        want.record(**r)
        assert got.as_dict() == want.as_dict()
    assert got.hit_rate == want.hit_rate


# ------------------------------------------ parity: family sweeps (f64)
def _sweep_batches(lib, mod, n, **kw):
    """name -> (family, batch) for either package (``lib`` makes the
    vectors: jnp or torch; float64)."""
    return {
        "q6": (mod.q6_family(),
               dict(disc_lo=lib.full((n,), 5.0, **kw),
                    disc_hi=lib.full((n,), 7.0, **kw),
                    qty_lim=lib.arange(1.0, n + 1.0, **kw))),
        "q18": (mod.q18_family(),
                dict(qty_threshold=lib.linspace(100.0, 240.0, n, **kw))),
    }


@pytest.mark.parametrize("family", ["q6", "q18"])
def test_family_sweep_matches_reference(jax_db, tables, family):
    """4 points, float64: the port's scan sweep against the JAX service's
    (one jitted lax.map program)."""
    import jax.numpy as jnp
    from repro.db.serving import QueryService as JQueryService
    from repro.db import tpch as jtpch
    fam, batch = _sweep_batches(torch, tpch, 4, dtype=torch.float64)[family]
    jfam, jbatch = _sweep_batches(jnp, jtpch, 4)[family]
    got, info = QueryService(tables, **CPU).sweep(fam, batch)
    want, _ = JQueryService(jax_db.tables()).sweep(jfam, jbatch)
    assert info["points"] == 4
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k, w in fw.items():
        w = np.asarray(w)
        g = fg[k].numpy()
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------ hits, bit for bit
def test_resident_hits_bit_equal(tables, monkeypatch):
    """Every serving plan cold, then fresh plan objects: each a hit that
    lowers nothing and equals the cold run (and a plain compile)."""
    svc = QueryService(tables, capacity=16, **CPU)
    lowered = _lowerings(monkeypatch)
    cold = {}
    for name, p in tpch.serving_plans().items():
        cold[name], info = svc.submit(p)
        assert not info["hit"] and info["attempts"] == 1, name
        assert _bit_equal(cold[name], compile_plan(p, **CPU)(tables)), name
    n_cold = len(lowered)
    for name, p in tpch.serving_plans().items():
        out, info = svc.submit(p)
        assert info["hit"], name
        assert _bit_equal(cold[name], out), name
    assert len(lowered) == n_cold
    assert svc.cache.info() == dict(size=5, capacity=16, hits=5, misses=5,
                                     evictions=0)


@pytest.mark.outofcore
@pytest.mark.parametrize("host", ["table", "host_table"])
def test_streamed_hits_bit_equal(tables, host, monkeypatch):
    """Q1 and Q20 streamed from the host twice (a device Table pulled to
    the host at bind time, or a HostTable): the second submit hits, lowers
    nothing, equals the first and equals the resident run."""
    if host == "host_table":
        tables = dict(tables,
                      lineitem=HostTable.from_table(tables["lineitem"]))
    svc = QueryService(tables, capacity=16, **STREAM)
    lowered = _lowerings(monkeypatch)
    for name in ("q1", "q20"):
        p = tpch.serving_plans()[name]
        cold, i0 = svc.submit(p)
        n = len(lowered)
        warm, i1 = svc.submit(p)
        assert not i0["hit"] and i1["hit"] and len(lowered) == n, name
        assert _bit_equal(cold, warm), name
        resident = {k: (t.to_table("cpu") if isinstance(t, HostTable)
                        else t) for k, t in tables.items()}
        assert _bit_equal(cold, compile_plan(p, **CPU)(resident)), name


def test_bind_equals_call(tables):
    """``bind(tables)(params)`` is ``compiled(tables, params)`` bit for bit,
    and one runner gives the same bits on every call, for a plan, a
    family (two points), a streamed plan and a reported run."""
    cases = [(tpch.q3_plan(), {}, None), (tpch.q6_family(), {},
              dict(disc_lo=5.0, disc_hi=7.0, qty_lim=24.0)),
             (tpch.q18_family(), {}, dict(qty_threshold=150.0)),
             (tpch.q1_plan(), STREAM, None),
             (tpch.q20_plan(), dict(with_report=True), None)]
    for root, opts, params in cases:
        fn = compile_plan(root, **{**CPU, **opts})
        runner = fn.bind(tables)
        want = fn(tables, params)
        for _ in range(2):
            got = runner(params)
            if opts.get("with_report"):
                assert got[1].issues() == want[1].issues() == {}
                got, w = got[0], want[0]
            else:
                w = want
            assert _bit_equal(w, got), root
    fam = compile_plan(tpch.q6_family(), **CPU)
    runner = fam.bind(tables)
    for lim in (10.0, 30.0):
        p = dict(disc_lo=5.0, disc_hi=7.0, qty_lim=lim)
        assert _bit_equal(runner(p), fam(tables, p))
    with pytest.raises(ValueError, match="parameters mismatch"):
        runner()


def test_replacing_a_table_rebinds(tables, monkeypatch):
    """A replaced catalogue table re-binds (a new lowering; never a stale
    plan); HostTable copies are placed once per service and shared by its
    entries, and the replaced table's copy is dropped."""
    host = dict(tables, lineitem=HostTable.from_table(tables["lineitem"]))
    svc = QueryService(host, capacity=16, **CPU)
    lowered = _lowerings(monkeypatch)
    q1, q6 = tpch.q1_plan(), tpch.q6_plan()
    a1, _ = svc.submit(q1)
    a6, _ = svc.submit(q6)
    gc.collect()        # the planner's closures leave cycles behind
    assert len(svc.cache.placement) == 1 and len(lowered) == 2
    svc.submit(q6)
    assert len(lowered) == 2
    li = tables["lineitem"]
    old = weakref.ref(svc.tables["lineitem"])
    svc.tables["lineitem"] = HostTable.from_table(
        li.with_prob(li.prob * 0.5))
    b6, info = svc.submit(q6)
    assert info["hit"] and len(lowered) == 3
    # q1's binding to the old table was dropped too, not kept until q1's
    # next submit
    gc.collect()
    assert len(svc.cache.placement) == 1 and old() is None
    assert not _bit_equal(a6, b6)
    fresh = {k: (t.to_table("cpu") if isinstance(t, HostTable) else t)
             for k, t in svc.tables.items()}
    assert _bit_equal(b6, compile_plan(q6, **CPU)(fresh))
    assert _bit_equal(svc.submit(q1)[0], compile_plan(q1, **CPU)(fresh))


def test_evicted_entries_die(tables):
    """Twice the capacity in distinct plans: the cache stays at capacity
    and the evicted entries (holding their bindings) become garbage."""
    svc = QueryService(tables, capacity=2, **CPU)
    refs = []
    for c in range(4):
        root = _limit_plan(TP, float(10 + c))
        svc.submit(root)
        entry, hit = svc.cache.entry(root, None, **CPU)
        assert hit and entry.runner is not None
        refs.append(weakref.ref(entry))
    info = svc.cache.info()
    assert info["size"] == 2 and info["evictions"] == 2
    del entry
    gc.collect()
    assert [r() is None for r in refs] == [True, True, False, False]
    svc.cache.clear()
    gc.collect()
    assert all(r() is None for r in refs)


def test_padded_copies_shared_and_dropped(tables):
    """A device table off the chunk grid (lineitem cut to 190 rows, nation
    at 25) is padded by a copy: two entries scanning it share one copy,
    a binding keeps no padded copy of a table it does not scan, and the
    copy dies with the last entry that holds it."""
    li = tables["lineitem"]
    tables = dict(tables, lineitem=Table(
        {k: v[:190] for k, v in li.columns.items()}, li.prob[:190],
        li.valid[:190]))
    svc = QueryService(tables, capacity=2, **CPU)
    a, _ = svc.submit(_limit_plan(TP, 10.0))
    gc.collect()        # the planner's closures leave cycles behind
    first = svc.cache.placement.copies()
    b, _ = svc.submit(_limit_plan(TP, 11.0))
    gc.collect()
    both = svc.cache.placement.copies()
    assert len(first) == len(both) == 1 and first[0] is both[0]
    assert both[0].capacity == 192
    copy = weakref.ref(both[0])
    del first, both
    for c in (8, 16):             # partsupp (96 rows) needs no copy
        svc.submit(GroupAgg(Scan("partsupp"), ("ps_suppkey",),
                            "ps_availqty", "SUM", c))
    gc.collect()
    assert svc.cache.info()["evictions"] == 2
    assert copy() is None and svc.cache.placement.copies() == []
    assert _bit_equal(a, compile_plan(_limit_plan(TP, 10.0), **CPU)(tables))
    assert _bit_equal(b, compile_plan(_limit_plan(TP, 11.0), **CPU)(tables))


# --------------------------------------------------------------- sweeps
@pytest.mark.parametrize("family", ["q6", "q18"])
def test_sweep_bit_equal_sequential(tables, family):
    """Point i of a 6-point sweep equals a sequential submit at point i's
    scalars (the batch's own 0-d tensors), whole and in chunks; a resweep
    of another size with a fresh plan object hits."""
    fam, batch = _sweep_batches(torch, tpch, 6, dtype=torch.float64)[family]
    svc = QueryService(tables, capacity=16, **CPU)
    out, info = svc.sweep(fam, batch)
    assert not info["hit"] and info["points"] == 6
    for i in range(6):
        seq, si = svc.submit(fam, {k: v[i] for k, v in batch.items()})
        assert si["hit"]
        point = {k: v[i] for k, v in _flat(out).items()}
        assert _bit_equal(point, _flat(seq)), (family, i)
    got, ci = QueryService(tables, capacity=16, **CPU).sweep(fam, batch)
    assert not ci["hit"] and _bit_equal(out, got)
    fam2, batch2 = _sweep_batches(torch, tpch, 3,
                                  dtype=torch.float64)[family]
    _, again = svc.sweep(fam2, batch2)
    assert again["hit"] and again["points"] == 3
    assert svc.stats.as_dict()["batched_points"] == 9


def test_sweep_and_submit_validation(tables):
    svc = QueryService(tables, capacity=16, **CPU)
    fam = tpch.q6_family()
    good = dict(disc_lo=torch.zeros(4), disc_hi=torch.ones(4),
                qty_lim=torch.ones(4))
    with pytest.raises(ValueError, match="param_batch"):
        svc.sweep(fam, {k: good[k] for k in ("disc_lo", "disc_hi")})
    with pytest.raises(ValueError, match="param_batch"):
        svc.sweep(fam, {**good, "qty_lim": torch.ones(3)})
    with pytest.raises(ValueError, match="param_batch"):
        svc.sweep(fam, {**good, "qty_lim": torch.ones(())})
    with pytest.raises(ValueError, match="parameterized"):
        svc.sweep(tpch.q6_plan(), good)
    with pytest.raises(NotImplementedError, match="device_row_budget"):
        svc.sweep(fam, good, device_row_budget=64)
    with pytest.raises(ValueError, match="sweep_mode"):
        QueryService(tables, sweep_mode="loop")
    vmap, vinfo = QueryService(tables, sweep_mode="vmap", **CPU).sweep(
        fam, good)
    assert vinfo["points"] == 4 and vinfo["launches"] == 1
    assert vmap["confidence"].shape == (4, 1)
    fn = compile_plan(fam, **CPU)
    with pytest.raises(ValueError, match="parameters mismatch"):
        fn(tables)
    with pytest.raises(ValueError, match="parameters mismatch"):
        fn(tables, dict(disc_lo=5.0, disc_hi=7.0, qty_lim=24.0, extra=1.0))
    with pytest.raises(ValueError, match="parameters mismatch"):
        svc.submit(fam)


def test_serving_stats_counters(tables):
    svc = QueryService(tables, capacity=16, **CPU)
    p = tpch.q6_plan()
    svc.submit(p)
    svc.submit(p)
    svc.sweep(tpch.q6_family(),
              dict(disc_lo=torch.full((4,), 5.0), disc_hi=torch.full(
                  (4,), 7.0), qty_lim=torch.arange(1.0, 5.0)))
    s = svc.stats.as_dict()
    assert s["requests"] == 3 and s["cache_hits"] == 1
    assert s["batched_requests"] == 1 and s["batched_points"] == 4
    assert s["hit_rate"] == pytest.approx(1 / 3, abs=1e-3)


# ------------------------------------------------------- healed replay
@pytest.mark.faults
def test_queryservice_healed_replay(tables):
    """The port's mirror of tests/test_faults.py::
    test_queryservice_healed_replay: retries neither poison nor duplicate
    cache entries, and a resubmit of the healed plan runs one clean
    attempt, hits the cache and answers bit-identically -- equal to a
    from-scratch escalated run."""
    root = GroupAgg(Scan("lineitem"), ("l_orderkey",), "l_quantity",
                    "SUM", 16, "normal")            # overflows: 48 groups
    svc = QueryService(tables, capacity=16,
                       policy=RetryPolicy(max_attempts=4), **CPU)
    out1, info1 = svc.submit(root)
    assert info1["attempts"] > 1
    assert info1["report"].issues() == {}
    misses_after_heal = svc.cache.misses
    out2, info2 = svc.submit(root)
    assert info2["attempts"] == 1
    assert info2["hit"] and svc.cache.misses == misses_after_heal
    assert _bit_equal(out1, out2)
    out3, _ = run_plan(root, tables, policy=RetryPolicy(max_attempts=4),
                       **CPU)
    assert _bit_equal(out1, out3)
    assert svc.stats.as_dict()["retry_attempts"] == info1["attempts"] - 1


# ---------------------------------------------------------- entry point
def test_serve_main_db(capsys, monkeypatch):
    from repro_torch.launch import serve
    assert serve.main(["--db", "--device", "cpu", "--scale", "48",
                       "--rounds", "2", "--sweep", "4"]) == 0
    out = capsys.readouterr().out
    assert "round 0: 5 queries" in out and "(0/5 cache hits)" in out
    assert "round 1: 5 queries" in out and "(5/5 cache hits)" in out
    assert "q6 sweep: 4 points in" in out
    assert "'evictions': 0" in out
    # without --db: language-model serving, on the card by default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main([])


# ------------------------------------------------------ 2-rank gloo mesh
def _mesh_serving(arrays):
    """One gloo rank: every serving plan through a mesh service cold and
    warm (fresh objects), each against mesh=None computed here; the
    lowerings a warm round makes; the placement's size; and one closure
    bound to two catalogues of different sizes, called interleaved."""
    from repro_torch.db import physical as phys
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2,), ("data",), device="cpu")
    tables = _tables(arrays)
    calls = []
    real = phys.lower_plan

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    phys.lower_plan = counted
    svc = QueryService(tables, mesh, capacity=16, **CPU)
    refs = {name: compile_plan(p, **CPU)(tables)
            for name, p in tpch.serving_plans().items()}
    out = {}
    for name, p in tpch.serving_plans().items():
        cold, i0 = svc.submit(p)
        out[name] = dict(cold_hit=i0["hit"],
                         cold_ref=_bit_equal(cold, refs[name]))
    n = len(calls)
    for name, p in tpch.serving_plans().items():
        warm, i1 = svc.submit(p)
        out[name].update(warm_hit=i1["hit"],
                         warm_ref=_bit_equal(warm, refs[name]))
    out["warm_lowerings"] = len(calls) - n
    out["placed"] = len(svc.cache.placement)
    # two bindings of one closure: the sharded Select result is cut to
    # each catalogue's own canonical lineitem capacity
    small = _tables({k: dict(columns={c: a[:160] if k == "lineitem" else a
                                      for c, a in v["columns"].items()},
                             prob=v["prob"][:160] if k == "lineitem"
                             else v["prob"],
                             valid=v["valid"][:160] if k == "lineitem"
                             else v["valid"])
                     for k, v in arrays.items()})
    cases = {"select": (Select(Scan("lineitem"),
                               lambda t: t["l_quantity"] < 30), {}),
             "q3_copartitioned": (tpch.q3_plan(order_join_budget=4),
                                  dict(copartition=True))}
    for name, (root, opts) in cases.items():
        fn = compile_plan(root, mesh, **CPU, **opts)
        ra, rb = fn.bind(tables), fn.bind(small)
        got_b, got_a = rb(), ra()
        out[f"two_bindings_{name}"] = (
            _bit_equal(got_a, compile_plan(root, **CPU, **opts)(tables))
            and _bit_equal(got_b, compile_plan(root, **CPU, **opts)(small)))
    return out


@pytest.fixture(scope="module")
def mesh_ranks(arrays, tmp_path_factory):
    return run_ranks(_mesh_serving, 2, backend="gloo", device="cpu",
                     store_dir=tmp_path_factory.mktemp("serving_mesh"),
                     args=(arrays,))


@pytest.mark.multidevice
def test_mesh_hits_bit_equal(mesh_ranks):
    """On a 2-rank gloo mesh every serving plan's cold and warm submits
    equal mesh=None bit for bit, warm submits hit and lower nothing, the
    row blocks are placed once per table, and two bindings of one closure
    keep their own canonical capacities."""
    for r in mesh_ranks:
        for name in tpch.serving_plans():
            assert r[name] == dict(cold_hit=False, cold_ref=True,
                                   warm_hit=True, warm_ref=True), name
        assert r["warm_lowerings"] == 0
        # every table a serving plan scans, one block each
        assert r["placed"] == 7
        assert r["two_bindings_select"] is True
        assert r["two_bindings_q3_copartitioned"] is True
