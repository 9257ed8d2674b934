"""Batched parameter sweeps of the port (``QueryService(sweep_mode=
"vmap")``, ``repro_torch.db.sweep``): the point is an extra group key,
joined in at the parameterized predicate.

Tolerances.  The fold order differs from a run at one point, so a vmap
sweep is held to tolerance, per leaf and relative to the leaf's largest
magnitude over all points: ``VMAP_RTOL`` = 1e-9 in float64 (against the
reference's own ``sweep_mode="vmap"``, jitted as its tests run it, and
against the port's scan sweep) and ``VMAP_RTOL_F32`` = 1e-5 in float32
(against the port's scan sweep; the cumulant riders then go through the
grouped kernels' plain versions, the scan sweep's one-group passes
through the scalar ones), except the float32 cumulant terms, held per
order to 1e-3 of that order's largest magnitude (``CUMULANT_RTOL_F32``:
an order's terms change sign, and a float32 sum of a few hundred of them
in another order errs by up to ~2e-4 of the result).  Integer and
boolean leaves (keys, validity) are equal.  A sweep cut into launches
by ``batch_row_budget`` is held to the one-launch sweep likewise.  The
``cuda`` cases hold the card's vmap sweep to its scan sweep within
``CARD_RTOL_F32`` = 1e-4 (chip_smoke.py's phase-15 bound).

On a mesh (two gloo ranks, spawned once: a 2-rank data axis and a
(1, 2) data x model mesh) the vmap sweep equals mesh=None's bit for bit,
as every plan does, through every exchange the lowering can pick: the
gathered and the shuffled join, a swept build side, the co-partitioned
pipeline (CoPartitionedJoin + PartitionedAgg, forced with
``copartition=True`` and a small join budget) and a Repartition into a
PartitionedAgg (``agg_shuffle_budget``).  Where a small
``shuffle_slack`` makes some points overflow their buckets, each point's
report counts equal the scan sweep's on the same mesh, and only those
points are NaN-poisoned.

Sizes: n_orders=600 (2,400 lineitem rows), 4-8 points.  The JAX package
is imported inside functions only: the mesh ranks import this module."""
import numpy as np
import pytest
import torch

from repro_torch.db import plans as TP
from repro_torch.db import tpch
from repro_torch.db.plans import (FKJoin, GroupAgg, Map, Param,
                                  Parameterized, Project, ReweightGreater,
                                  Scan, Select)
from repro_torch.db.serving import QueryService
from repro_torch.testing.ranks import run_ranks

pytestmark = pytest.mark.serving

SMALL = dict(n_orders=600, lines_per_order=4, n_parts=60, n_suppliers=12,
             n_customers=90, seed=1)
CPU = dict(device="cpu")
VMAP_RTOL = 1e-9
VMAP_RTOL_F32 = 1e-5
CUMULANT_RTOL_F32 = 1e-3
#: on the card, where the scan sweep's one-group passes run the scalar
#: kernels (``logcf`` computes half the grid and mirrors it) and the vmap
#: sweep's the grouped ones: chip_smoke.py's phase-15 bound
CARD_RTOL_F32 = 1e-4


@pytest.fixture(scope="module")
def jax_db():
    from repro.db import tpch as jtpch
    return jtpch.generate(**SMALL)


@pytest.fixture(scope="module")
def arrays(jax_db):
    return {name: dict(columns={k: np.asarray(v)
                                for k, v in t.columns.items()},
                       prob=np.asarray(t.prob), valid=np.asarray(t.valid))
            for name, t in jax_db.tables().items()}


def _tables(arrays, prob_dtype=None):
    return tpch.from_numpy(arrays, device="cpu",
                           prob_dtype=prob_dtype).tables()


def _flat(x, path=""):
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


def _close(got, want, rtol, cumulant_rtol=None):
    """Every leaf of ``got`` within ``rtol`` of ``want``'s largest
    finite magnitude (floats; the same infinities and NaNs) or equal
    (integers, booleans); with
    ``cumulant_rtol``, cumulant terms within it of each order's largest
    magnitude."""
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k, w in fw.items():
        w = np.asarray(w)
        g = np.asarray(fg[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            tol = rtol
            axes = None
            if cumulant_rtol is not None and "cumulants" in k:
                tol, axes = cumulant_rtol, tuple(range(w.ndim - 1))
            if not w.size:
                continue
            finite = np.where(np.isfinite(w), np.abs(w), 0.0)
            atol = tol * np.maximum(finite.max(axis=axes), 1e-30)
            with np.errstate(invalid="ignore"):
                ok = (g == w) | (np.abs(g - w) <= atol) \
                    | (np.isnan(g) & np.isnan(w))
            with np.errstate(invalid="ignore"):
                worst = float(np.nanmax(np.where(ok, 0.0,
                                                 np.abs(g - w) / atol)))
            assert ok.all(), f"{k}: {worst:.3g} x the bound"
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------------------ families
def _q1_family(P):
    """Q1 with its shipdate cutoff lifted: a grouped family (8 groups)."""
    sel = P.Select(P.Scan("lineitem"), P.Parameterized(
        lambda t, cut: t["l_shipdate"] <= cut, ("ship_cut",)))
    return P.GroupAgg(sel, ("l_returnflag", "l_linestatus"), "l_quantity",
                      "SUM", 8, "normal",
                      extra=(("price", "l_extendedprice", "SUM", "normal"),
                             ("count", "", "COUNT", "normal"),
                             ("cumulants_qty", "l_quantity", "SUM",
                              "cumulants")))


def _q6_exact_family(P):
    """A narrow Q6 with an exact SUM rider on 512 frequencies (the
    grouped CF path: one group a point)."""
    sel = P.Select(P.Scan("lineitem"), P.Parameterized(
        lambda t, lo, lim: (t["l_discount"] >= lo) & (t["l_discount"] <= 6)
        & (t["l_quantity"] < lim), ("disc_lo", "qty_lim")))
    return P.GroupAgg(sel, (), "l_quantity", "SUM", 1, "normal",
                      extra=(("exact", "l_quantity", "SUM", "exact"),),
                      num_freq=512)


def _q3_family(P, order_join_budget=None):
    """TPC-H Q3 with its substitution parameters lifted: SEGMENT on
    ``customer`` (the build side of ``orders``' join) and DATE on
    ``orders`` (the build side of ``lineitem``'s join) and on
    ``lineitem``."""
    cust = P.Select(P.Scan("customer"), P.Parameterized(
        lambda t, seg: t["c_mktsegment"] == seg, ("segment",)))
    orders = P.Select(P.Scan("orders"), P.Parameterized(
        lambda t, day: t["o_orderdate"] < day, ("date",)))
    o = P.FKJoin(orders, cust, "o_custkey", "c_custkey", ("c_mktsegment",))
    li = P.Select(P.Scan("lineitem"), P.Parameterized(
        lambda t, day: t["l_shipdate"] > day, ("date",)))
    j = P.FKJoin(li, o, "l_orderkey", "o_orderkey",
                 ("o_orderdate", "o_custkey"),
                 gather_budget=order_join_budget)
    return P.GroupAgg(j, ("l_orderkey",), "l_extendedprice", "SUM", 512,
                      "normal", extra=(("cumulants", "l_extendedprice",
                                        "SUM", "cumulants"),))


def _build_side_family(P):
    """A parameter on a join's build side only: lineitem's quantity under
    the orders of a date window (one group a point)."""
    orders = P.Select(P.Scan("orders"), P.Parameterized(
        lambda t, day: t["o_orderdate"] < day, ("date",)))
    j = P.FKJoin(P.Scan("lineitem"), orders, "l_orderkey", "o_orderkey",
                 ("o_custkey",))
    return P.GroupAgg(j, (), "l_quantity", "SUM", 1)


def _max_family(P):
    """MAX (MinMax runs and a truncation tail at kappa 8) a point."""
    sel = P.Select(P.Scan("lineitem"), P.Parameterized(
        lambda t, lim: t["l_quantity"] < lim, ("qty_lim",)))
    return P.GroupAgg(sel, ("l_returnflag",), "l_quantity", "MAX", 4,
                      kappa=8)


def _families(P, mod, lib, n, **kw):
    """name -> (family, batch) for either package (``P`` its plans
    module, ``mod`` its tpch, ``lib`` jnp or torch)."""
    ar = lambda a, b: lib.linspace(a, b, n, **kw)
    return {
        "q6": (mod.q6_family(),
               dict(disc_lo=lib.floor(ar(2.0, 6.0)),
                    disc_hi=lib.floor(ar(5.0, 9.0)),
                    qty_lim=lib.floor(ar(10.0, 50.0)))),
        "q1": (_q1_family(P),
               dict(ship_cut=lib.floor(ar(9000.0, 9400.0)))),
        "q18": (mod.q18_family(max_groups=1024),
                dict(qty_threshold=ar(60.0, 180.0))),
        "q6_exact": (_q6_exact_family(P),
                     dict(disc_lo=lib.floor(ar(4.0, 6.0)),
                          qty_lim=lib.floor(ar(4.0, 9.0)))),
        "q3": (_q3_family(P), dict(segment=lib.floor(ar(0.0, 4.99)),
                                   date=lib.floor(ar(9400.0, 8800.0)))),
        "build_side": (_build_side_family(P),
                       dict(date=lib.floor(ar(8500.0, 9800.0)))),
        "max": (_max_family(P), dict(qty_lim=lib.floor(ar(5.0, 45.0)))),
    }


def _port_only(n, dtype):
    """Port families without a reference run: MAX (MinMax runs), more
    groups a point than ``max_groups`` (each point keeps its own first
    16), a relational (Table) root, a Project root, two parameterized
    nodes and a threshold over a swept input."""
    fam = _families(TP, tpch, torch, n, dtype=dtype)
    lim = torch.floor(torch.linspace(5.0, 45.0, n, dtype=dtype))
    qty_lt = Parameterized(lambda t, lim: t["l_quantity"] < lim,
                           ("qty_lim",))
    sel = Select(Scan("lineitem"), qty_lt)
    fam["overflow"] = (GroupAgg(sel, ("l_orderkey",), "l_quantity", "SUM",
                                16), dict(qty_lim=lim))
    fam["rows"] = (Map(sel, "scaled", Parameterized(
        lambda t, s: t["l_quantity"] * s, ("scale",))),
        dict(qty_lim=lim, scale=torch.linspace(0.5, 2.0, n, dtype=dtype)))
    fam["project"] = (Project(FKJoin(sel, Scan("orders"), "l_orderkey",
                                     "o_orderkey", ("o_custkey",)),
                              ("o_custkey",), 128), dict(qty_lim=lim))
    fam["reweight"] = (ReweightGreater(
        Map(sel, "thr", lambda t: t["l_quantity"] * 0.0 + 40.0),
        ("l_orderkey",), "l_quantity", "thr", 1024), dict(qty_lim=lim))
    return fam


FAMILIES = ("q6", "q1", "q18", "q6_exact", "q3", "build_side", "max")


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("family", FAMILIES)
def test_vmap_matches_reference_vmap(jax_db, arrays, family):
    """Float64, 6 points: the port's vmap sweep against the JAX service's
    ``sweep_mode="vmap"`` (one jitted ``jax.vmap`` program)."""
    import jax.numpy as jnp
    from repro.db import plans as JP
    from repro.db import tpch as jtpch
    from repro.db.serving import QueryService as JQueryService
    fam, batch = _families(TP, tpch, torch, 6,
                           dtype=torch.float64)[family]
    jfam, jbatch = _families(JP, jtpch, jnp, 6)[family]
    got, info = QueryService(_tables(arrays), sweep_mode="vmap",
                             **CPU).sweep(fam, batch)
    want, _ = JQueryService(jax_db.tables(),
                            sweep_mode="vmap").sweep(jfam, jbatch)
    assert info["points"] == 6 and info["launches"] == 1
    _close(got, want, VMAP_RTOL)


# ---------------------------------------------- against the scan sweep
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("family", FAMILIES + ("overflow", "rows",
                                               "project", "reweight"))
def test_vmap_matches_scan(arrays, family, dtype):
    """8 points: vmap against the port's scan sweep (which is bit-equal to
    sequential submits), in float64 and in float32 tables."""
    tables = _tables(arrays, prob_dtype=dtype)
    fam, batch = _port_only(8, dtype)[family]
    scan, _ = QueryService(tables, **CPU).sweep(fam, batch)
    vmap, info = QueryService(tables, sweep_mode="vmap",
                              **CPU).sweep(fam, batch)
    assert info["launches"] == 1 and info["chunk"] == 8
    if dtype == torch.float64:
        _close(vmap, scan, VMAP_RTOL)
    else:
        _close(vmap, scan, VMAP_RTOL_F32, CUMULANT_RTOL_F32)


@pytest.mark.parametrize("family", ("q6", "q1", "q18", "max"))
def test_vmap_chunked_equals_one_launch(arrays, family):
    """A ``batch_row_budget`` of 3 points' rows cuts 8 points into 3
    launches; they agree with one launch, and a resweep of another size
    with a fresh plan object hits."""
    tables = _tables(arrays)
    fam, batch = _port_only(8, torch.float64)[family]
    one, _ = QueryService(tables, sweep_mode="vmap", **CPU).sweep(fam,
                                                                  batch)
    svc = QueryService(tables, sweep_mode="vmap", **CPU)
    per_point = svc._per_point_rows(fam)
    svc.batch_row_budget = int(3 * per_point)
    cut, info = svc.sweep(fam, batch)
    assert info["chunk"] == 3 and info["launches"] == 3
    assert not info["hit"]
    _close(cut, one, VMAP_RTOL)
    fam2, batch2 = _port_only(5, torch.float64)[family]
    _, again = svc.sweep(fam2, batch2)
    assert again["hit"] and again["launches"] == 2
    assert svc.stats.as_dict()["batched_points"] == 13


def test_vmap_scan_stays_bit_equal_to_submits(arrays):
    """The vmap mode leaves the scan mode alone: a scan sweep after a vmap
    sweep of the same family on one service is still bit-equal to
    sequential submits."""
    tables = _tables(arrays)
    fam, batch = _families(TP, tpch, torch, 4, dtype=torch.float64)["q1"]
    vmap_svc = QueryService(tables, sweep_mode="vmap", **CPU)
    vmap_svc.sweep(fam, batch)
    scan_svc = QueryService(tables, **CPU)
    out, _ = scan_svc.sweep(fam, batch)
    for i in range(4):
        seq, _ = scan_svc.submit(fam, {k: v[i] for k, v in batch.items()})
        point = {k: v[i] for k, v in _flat(out).items()}
        fs = _flat(seq)
        assert point.keys() == fs.keys()
        assert all(torch.equal(point[k], fs[k]) for k in fs)


# ---------------------------------------------------------- refusals
def _refused():
    lim = Parameterized(lambda t, lim: t["l_quantity"] < lim, ("qty_lim",))
    li = Select(Scan("lineitem"), lim)
    return {
        "project_limit": (
            Project(li, ("l_returnflag",), Param("groups")),
            "Project.max_groups"),
        "groupagg_kappa": (
            GroupAgg(li, ("l_returnflag",), "l_quantity", "MAX", 4,
                     kappa=Param("kappa")), "GroupAgg.kappa"),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_vmap_refuses_what_the_point_join_cannot_express(arrays, case):
    root, construct = _refused()[case]
    svc = QueryService(_tables(arrays), sweep_mode="vmap", **CPU)
    with pytest.raises(ValueError, match=construct):
        svc.sweep(root, dict(qty_lim=torch.ones(4), groups=torch.ones(4),
                             kappa=torch.ones(4)))


def test_vmap_keeps_the_reference_refusals(arrays):
    """The reference's own refusals stay, with its exception classes."""
    svc = QueryService(_tables(arrays), sweep_mode="vmap", **CPU)
    fam = tpch.q6_family()
    good = dict(disc_lo=torch.zeros(4), disc_hi=torch.ones(4),
                qty_lim=torch.ones(4))
    with pytest.raises(ValueError, match="parameterized"):
        svc.sweep(tpch.q6_plan(), good)
    with pytest.raises(ValueError, match="param_batch"):
        svc.sweep(fam, {**good, "qty_lim": torch.ones(3)})
    with pytest.raises(NotImplementedError, match="device_row_budget"):
        svc.sweep(fam, good, device_row_budget=64)
    with pytest.raises(ValueError, match="sweep_mode"):
        QueryService({}, sweep_mode="loop")


# --------------------------------------------------------------- mesh
#: case -> (family, compile options); every family of ``_port_only``
MESH_OPTS = {"shuffle": ("project", dict(join_gather_budget=4)),
             "q3_shuffle": ("q3", dict(join_gather_budget=4)),
             "q3_copart": ("q3_copart", dict(copartition=True)),
             "repartition": ("reweight", dict(agg_shuffle_budget=4))}
MESH_CASES = ("q6", "q1", "q18", "q6_exact", "max", "overflow", "rows",
              "project", "shuffle", "q3", "build_side", "q3_shuffle",
              "q3_copart", "repartition")
#: the pipelines each forced case must lower to (``compiled.explain``)
PIPELINES = {"q3_copart": ("CoPartitionedJoin", "PartitionedAgg"),
             "repartition": ("Repartition", "PartitionedAgg")}
#: a small shuffle_slack: the points that select more rows overflow
SLACK = 0.5


def _bit_equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        x.shape == fb[k].shape and x.dtype == fb[k].dtype
        and torch.equal(x, fb[k]) for k, x in fa.items())


def _keyed_join_family(by: str):
    """A join on a key computed en route (a Map), whose exchange buckets
    are therefore sized by ``shuffle_slack``; ``by="okey"`` groups on the
    join key (the co-partitioned pipeline with ``copartition=True``),
    ``by="o_custkey"`` on a build column (ShuffleJoin + PartialAgg)."""
    sel = Select(Scan("lineitem"), Parameterized(
        lambda t, lim: t["l_quantity"] < lim, ("qty_lim",)))
    keyed = Map(sel, "okey", lambda t: t["l_orderkey"])
    j = FKJoin(keyed, Scan("orders"), "okey", "o_orderkey", ("o_custkey",),
               gather_budget=4)
    return GroupAgg(j, (by,), "l_quantity", "SUM", 1024)


def _report(rep) -> dict:
    return {f: getattr(rep, f) for f in ("exchange_overflow",
                                         "exchange_demand",
                                         "exchange_capacity",
                                         "group_overflow", "tail_mass",
                                         "state_nan")}


def _mesh_vmap(arrays):
    """One gloo rank: every case's vmap sweep on a 2-rank data mesh and on
    a (1, 2) data x model mesh against mesh=None's vmap sweep (computed
    here), bit for bit ("shuffle": the Project family with its join forced
    onto ShuffleJoin; "q3_copart": Q3 through the co-partitioned
    pipeline; "repartition": the reweight family through a Repartition).
    Then, on the data mesh, the vmap and scan sweeps with reports of
    "q3_copart" and of the two ``_keyed_join_family`` plans at
    ``SLACK``."""
    from repro_torch.launch.mesh import make_mesh
    tables = _tables(arrays)
    meshes = {"data": make_mesh((2,), ("data",), device="cpu"),
              "model": make_mesh((1, 2), ("data", "model"), device="cpu")}
    fams = _port_only(4, torch.float64)
    fams["q3_copart"] = (_q3_family(TP, order_join_budget=4),
                         fams["q3"][1])
    out = {}
    for name in MESH_CASES:
        fam_name, opts = MESH_OPTS.get(name, (name, {}))
        fam, batch = fams[fam_name]
        ref, _ = QueryService(tables, sweep_mode="vmap", **CPU,
                              **opts).sweep(fam, batch)
        for axes, mesh in meshes.items():
            got, _ = QueryService(tables, mesh, sweep_mode="vmap", **CPU,
                                  **opts).sweep(fam, batch)
            out[f"{name}/{axes}"] = _bit_equal(got, ref)
        if name in PIPELINES:
            out[f"{name}/explain"] = TP.compile_plan(
                fam, meshes["data"], **CPU, **opts).explain(tables)
    lim = dict(qty_lim=torch.floor(torch.linspace(5.0, 45.0, 8,
                                                  dtype=torch.float64)))
    reported = {"q3_copart": (fams["q3_copart"][0], fams["q3"][1],
                              dict(copartition=True)),
                "overflow_copart": (_keyed_join_family("okey"), lim,
                                    dict(copartition=True,
                                         shuffle_slack=SLACK)),
                "overflow_shuffle": (_keyed_join_family("o_custkey"), lim,
                                     dict(shuffle_slack=SLACK))}
    for name, (fam, batch, opts) in reported.items():
        runs = {}
        for mode in ("vmap", "scan"):
            (res, rep), _ = QueryService(
                tables, meshes["data"], sweep_mode=mode, **CPU,
                **opts).sweep(fam, batch, with_report=True)
            runs[mode] = (res, _report(rep), rep.points)
        out[f"{name}/report"] = runs
        out[f"{name}/explain"] = TP.compile_plan(
            fam, meshes["data"], **CPU, **opts).explain(tables)
    return out


@pytest.fixture(scope="module")
def mesh_ranks(arrays, tmp_path_factory):
    return run_ranks(_mesh_vmap, 2, backend="gloo", device="cpu",
                     store_dir=tmp_path_factory.mktemp("vmap_mesh"),
                     args=(arrays,))


@pytest.mark.multidevice
@pytest.mark.parametrize("case", MESH_CASES)
def test_vmap_on_a_mesh_bit_equal(mesh_ranks, case):
    for r in mesh_ranks:
        assert r[f"{case}/data"] is True
        assert r[f"{case}/model"] is True


@pytest.mark.multidevice
@pytest.mark.parametrize("case", sorted(PIPELINES))
def test_vmap_runs_the_copartitioned_pipeline(mesh_ranks, case):
    """The forced pipelines are in the plan the bit-equal sweeps ran."""
    for r in mesh_ranks:
        assert all(node in r[f"{case}/explain"] for node in PIPELINES[case])


def _overflowed(rep: dict) -> np.ndarray:
    return sum(np.asarray(v) for v in rep["exchange_overflow"].values())


@pytest.mark.multidevice
@pytest.mark.parametrize("case", ("q3_copart", "overflow_copart",
                                  "overflow_shuffle"))
def test_vmap_report_on_a_mesh_equals_scan(mesh_ranks, case):
    """On the data mesh, the vmap sweep's report holds each point's
    counts, equal to the scan sweep's; the results agree within
    ``VMAP_RTOL``.  At ``SLACK`` some points overflow their buckets and
    some do not: exactly the overflowing points are NaN-poisoned, as in
    the scan sweep (a point's rows were held to one point's bucket)."""
    for r in mesh_ranks:
        runs = r[f"{case}/report"]
        (vres, vrep, vpts), (sres, srep, spts) = runs["vmap"], runs["scan"]
        assert vpts == spts
        _close(vrep, srep, VMAP_RTOL)
        _close(vres, sres, VMAP_RTOL)
        over = _overflowed(vrep)
        explain = r[f"{case}/explain"]
        if case == "q3_copart":
            assert not over.any()
            assert "CoPartitionedJoin" in explain
            continue
        assert over.any() and not over.all(), over
        node = "CoPartitionedJoin" if case == "overflow_copart" \
            else "ShuffleJoin"
        assert node in explain
        poisoned = torch.isnan(vres["sum"][0]).reshape(8, -1).any(1)
        np.testing.assert_array_equal(poisoned.numpy(), over > 0)


# --------------------------------------------------------------- card
@pytest.mark.cuda
@pytest.mark.parametrize("family", ("q6", "q1", "q6_exact", "q3"))
def test_vmap_on_the_card_runs_the_grouped_kernels(family):
    """On the card, float32 at n_orders=20,000 (10,000 rows a canonical
    chunk): the vmap sweep launches the grouped kernels
    (``group_cumulant_sums``; ``group_logcf`` for the exact rider) and
    agrees with the scan sweep within ``CARD_RTOL_F32`` (cumulant orders
    ``CUMULANT_RTOL_F32``), both with reports whose counts are equal
    ("q3": parameters on both build sides)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.kernels import ops
    tables = tpch.generate(n_orders=20000, device="cuda").tables()
    fam, batch = _families(TP, tpch, torch, 8, dtype=torch.float32,
                           device="cuda")[family]
    scan, srep = QueryService(tables).sweep(fam, batch,
                                            with_report=True)[0]
    ops.reset_launches()
    vmap, vrep = QueryService(tables, sweep_mode="vmap").sweep(
        fam, batch, with_report=True)[0]
    torch.cuda.synchronize()
    launched = ops.launches()
    # q6_exact carries the exact rider and no cumulant one
    assert (launched["group_cumulant_sums"] > 0) == (family != "q6_exact")
    assert (launched["group_logcf"] > 0) == (family == "q6_exact")
    cpu = lambda x: {k: v.cpu() for k, v in _flat(x).items()}
    _close(cpu(vmap), cpu(scan), CARD_RTOL_F32, CUMULANT_RTOL_F32)
    _close(cpu(_report(vrep)), cpu(_report(srep)), CARD_RTOL_F32)
