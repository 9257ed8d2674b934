"""The multi-rank slice as a whole: ``compile_plan(root, mesh)`` on gloo
ranks on the CPU (``repro_torch.launch.mesh``, one process per rank).

Inside the port the contract is bit for bit: on 2, 3 and 4 data ranks (8
canonical chunks over 3 ranks is the ragged split), on a (2, 2) data x
model mesh, with the exchange strategies forced (ShuffleJoin, the
co-partitioned pipeline, Repartition) and streamed from a HostTable,
every leaf of the mesh result equals ``mesh=None`` under ``torch.equal``.
Against the JAX package the same results agree with its ``mesh=None``
run (jitted) within the float64 tolerance of tests/test_torch_tpch.py, and
the report's exchange fields at 3 ranks equal the JAX package's at 3 host
devices.  One spawn per mesh shape for the whole file: the rank function
runs every case and hands back what each rank saw.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.db import tpch as ttpch
from repro_torch.testing.ranks import run_ranks

N_ORDERS = 120
SEED = 3
Q3_GROUPS = 512
Q18_GROUPS = 512
#: lineitem (480 rows) streams past this per-rank budget; orders (120)
#: and partsupp stay resident.
STREAM = dict(device_row_budget=48, stream_wave_chunks=2)
F32 = "q6_exact_f32"
MESHES = {"2": ((2,), ("data",)), "3": ((3,), ("data",)),
          "4": ((4,), ("data",)), "2x2": ((2, 2), ("data", "model"))}


def _plans(mod):
    """name -> (logical plan, compile options) of every case, from the
    port's or the JAX package's modules."""
    from importlib import import_module
    P = import_module(mod.__name__.replace(".tpch", ".plans"))
    q18x = P.GroupAgg(P.Scan("lineitem"), ("l_orderkey",), "l_quantity",
                      "SUM", Q18_GROUPS, "exact", num_freq=256)
    return {
        "q1": (mod.q1_plan(), {}),
        "q3": (mod.q3_plan(max_groups=Q3_GROUPS), {}),
        "q6_exact": (mod.q6_plan(num_freq=256), {}),
        "q18_exact": (q18x, {}),
        "q18_exact_slabs": (q18x, dict(cf_budget_elems=2 * Q18_GROUPS * 100)),
        "q20": (mod.q20_plan(), {}),
        "q3_copartitioned": (mod.q3_plan(max_groups=Q3_GROUPS,
                                         order_join_budget=4),
                             dict(copartition=True)),
        "q3_shuffle_join": (mod.q3_plan(max_groups=Q3_GROUPS,
                                        order_join_budget=4),
                            dict(copartition=False)),
        "q20_shuffle_join": (mod.q20_plan(), dict(join_gather_budget=4)),
        "q18_topk_repartition": (
            P.GroupAgg(P.Scan("lineitem"), ("l_orderkey",), "l_quantity",
                       "MAX", Q18_GROUPS, kappa=2),
            dict(agg_shuffle_budget=4)),
        "q1_streamed": (mod.q1_plan(), STREAM),
        "q6_exact_streamed": (mod.q6_plan(num_freq=256), STREAM),
        "q18_exact_streamed": (q18x, STREAM),
        # float32 probabilities and one canonical chunk (480 tuples): the
        # scalar exact CF runs the logcf kernel's plain version, whose
        # N/2 + 1 columns split over the model axis
        F32: (mod.q6_plan(num_freq=256), dict(canonical_chunks=1)),
    }


def _tables(arrays):
    from repro_torch.db import tpch
    return tpch.from_numpy(arrays, device="cpu").tables()


def _f32(tables):
    return {k: t.with_prob(t.prob.float()) for k, t in tables.items()}


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


def _mesh_cases(shape, names, arrays, stale_arrays):
    """Every case on this rank: {case: (bit-equal to mesh=None, result)},
    plus the 3-rank extras (report, retry, fault)."""
    from repro_torch.db import distributed as dist
    from repro_torch.db import plans, tpch
    from repro_torch.db.table import HostTable
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.testing import faults
    mesh = make_mesh(shape, names, device="cpu")
    tables = _tables(arrays)
    host = dict(tables, lineitem=HostTable.from_table(tables["lineitem"]))
    # the (freq_lo, freq_cnt) windows of the logcf plain version's calls
    from repro_torch.kernels import pb_cf
    windows, plain = [], pb_cf.logcf_plain

    def spy(probs, values, num_freq, freq_lo=0, freq_cnt=None):
        windows.append((freq_lo, freq_cnt))
        return plain(probs, values, num_freq, freq_lo, freq_cnt)
    pb_cf.logcf_plain = spy
    out = {}
    for name, (plan, opts) in _plans(tpch).items():
        streamed = "device_row_budget" in opts
        tabs = _f32(tables) if name == F32 else tables
        ref = plans.compile_plan(plan, device="cpu", **{
            k: v for k, v in opts.items() if k not in STREAM})(tabs)
        dist.reset_collective_counts()
        windows.clear()
        got = plans.compile_plan(plan, mesh, device="cpu", **opts)(
            host if streamed else tabs)
        out[name] = (_bit_equal(ref, got), _flat(got),
                     dict(dist.COLLECTIVE_COUNTS), list(windows))
    if shape != (3,):
        return out
    # the report's exchange fields, ShuffleJoin forced
    root = tpch.q3_plan(max_groups=Q3_GROUPS, order_join_budget=4)
    _, rep = plans.compile_plan(root, mesh, device="cpu", with_report=True,
                                copartition=False)(tables)
    vals = rep.host_values()
    out["report"] = {f: vals[f] for f in ("exchange_overflow",
                                          "exchange_demand",
                                          "exchange_capacity")}
    # stale stats: the first run overflows, run_plan escalates the floor
    stale = _tables(stale_arrays)
    _, rep0 = plans.compile_plan(root, mesh, device="cpu", with_report=True,
                                 copartition=False,
                                 stats_tables=stale)(tables)
    got, rep1 = plans.run_plan(root, tables, mesh, device="cpu",
                               copartition=False, stats_tables=stale)
    fin = rep1.final_params
    first = plans.compile_plan(
        root, mesh, device="cpu", copartition=False, stats_tables=stale,
        shuffle_slack=fin["shuffle_slack"],
        shuffle_bucket_floor=fin["shuffle_bucket_floor"])(tables)
    ref = plans.compile_plan(root, device="cpu")(tables)
    out["retry"] = dict(first_issues=rep0.issues(), issues=rep1.issues(),
                        attempts=rep1.waves["attempts"], final=fin,
                        equal_first=_bit_equal(first, got),
                        equal_ref=_bit_equal(ref, got))
    # an exchange fault propagates out of every rank, no hang
    try:
        with faults.inject(faults.FaultPlan(exchange_calls={0})) as fp:
            plans.compile_plan(root, mesh, device="cpu")(tables)
        out["fault"] = "not raised"
    except faults.TransferFault as e:
        out["fault"] = f"raised: {e}; consumed={fp.consumed()}"
    return out


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def jax_db():
    from repro.db import tpch as jtpch
    return jtpch.generate(n_orders=N_ORDERS, seed=SEED)


def _arrays(db):
    return {name: dict(columns={k: np.asarray(v)
                                for k, v in t.columns.items()},
                       prob=np.asarray(t.prob), valid=np.asarray(t.valid))
            for name, t in db.tables().items()}


@pytest.fixture(scope="module")
def ranks(jax_db, tmp_path_factory):
    """{mesh: per-rank results}: every mesh shape's ranks, the spawns run
    side by side (most of a rank's time is its imports)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro.db import tpch as jtpch
    arrays = _arrays(jax_db)
    stale = _arrays(jtpch.generate(n_orders=N_ORDERS // 2, seed=SEED + 2))

    # (made here, not in the threads: the first mktemp creates the base)
    dirs = {key: tmp_path_factory.mktemp(f"m{key}") for key in MESHES}

    def spawn(key):
        shape, names = MESHES[key]
        return run_ranks(_mesh_cases, int(np.prod(shape)), backend="gloo",
                         device="cpu", store_dir=dirs[key],
                         args=(shape, names, arrays, stale))
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = dict(zip(MESHES, pool.map(spawn, MESHES)))
    return runs.__getitem__


@pytest.fixture(scope="module")
def jax_results(jax_db):
    """The JAX package's mesh=None result of every case (jitted)."""
    import jax
    from repro.db import plans as JP
    from repro.db import tpch as jtpch
    out = {}
    for name, (plan, opts) in _plans(jtpch).items():
        # (the float32 case is held to the float64 Q6 exact run)
        base = "q6_exact" if name == F32 else name.replace("_streamed", "")
        if base in out:
            out[name] = out[base]
            continue
        opts = {k: v for k, v in opts.items() if k not in STREAM}
        res = jax.jit(JP.compile_plan(plan, **opts))(jax_db.tables())
        out[name] = {k: np.asarray(v) for k, v in _flat(res).items()}
    return out


CASES = tuple(_plans(ttpch))


# ------------------------------------------------------------------ tests
@pytest.mark.multidevice
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_bit_equal_to_single_device(ranks, mesh, case):
    """Every rank's result equals mesh=None bit for bit."""
    res = ranks(mesh)
    assert [r[case][0] for r in res] == [True] * len(res)
    if case == "q3_copartitioned":
        # the fused pipeline never ships responses home
        assert "shuffle_back" not in res[0][case][2]
        assert res[0][case][2].get("merge_psum", 0) > 0
    if case == "q3":
        # the co-partitioned pipeline is not the default lowering
        assert "merge_psum" not in res[0][case][2]
    if case == F32:
        # data rank 0 holds the one chunk: model rank m ran its window of
        # the 129 unique columns (N = 256); without a model axis the whole
        # half, mirrored
        want = ([[(0, 65)], [(65, 64)], [], []] if mesh == "2x2"
                else [[(0, None)]] + [[]] * (len(res) - 1))
        assert [r[case][3] for r in res] == want


@pytest.mark.multidevice
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_matches_jax(ranks, jax_results, mesh):
    """Rank 0's results against the JAX package's mesh=None runs, within
    the float64 tolerance (rtol=1e-9, atol=1e-12); the float32 case
    against the same float64 run, within float32 rounding."""
    for case in CASES:
        got, want = ranks(mesh)[0][case][1], jax_results[case]
        assert sorted(got) == sorted(want), case
        tol = (dict(rtol=1e-4, atol=1e-5) if case == F32
               else dict(rtol=1e-9, atol=1e-12))
        for k, w in want.items():
            g = got[k].numpy()
            assert g.shape == w.shape, (case, k)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, **tol,
                                           err_msg=f"{case}{k}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{case}{k}")


_REF_REPORT = r"""
import json, jax, numpy as np
from repro.compat import make_mesh
from repro.core import enable_x64
enable_x64()
from repro.db import plans as L, tpch
mesh = make_mesh((3,), ("data",))
db = tpch.generate(n_orders=%(n)d, seed=%(seed)d)
root = tpch.q3_plan(max_groups=%(groups)d, order_join_budget=4)
fn = jax.jit(L.compile_plan(root, mesh, with_report=True, copartition=False,
                            stats_tables=db.tables()))
_, rep = fn(db.tables())
print("REPORT " + json.dumps({f: {k: int(np.asarray(v))
                                  for k, v in getattr(rep, f).items()}
                              for f in ("exchange_overflow",
                                        "exchange_demand",
                                        "exchange_capacity")}))
"""


@pytest.mark.multidevice
def test_exchange_report_matches_jax_at_3_ranks(ranks):
    """Q3 with ShuffleJoin forced at 3 data ranks: the report's exchange
    overflow, demand and capacity per leg equal the JAX package's at 3
    host devices (its jitted run sizes buckets from the same histograms
    through stats_tables)."""
    from conftest import run_sub
    out = run_sub(_REF_REPORT % dict(n=N_ORDERS, seed=SEED,
                                     groups=Q3_GROUPS), devices=3)
    line = [ln for ln in out.splitlines() if ln.startswith("REPORT ")][-1]
    want = json.loads(line[len("REPORT "):])
    res = ranks("3")
    for r in res:
        assert r["report"] == want
    assert want["exchange_overflow"] and not any(
        want["exchange_overflow"].values())


@pytest.mark.multidevice
def test_stale_stats_escalate_the_exchange(ranks):
    """Stats from a smaller snapshot undersize the probe buckets: the run
    overflows; run_plan raises the floor to the observed demand and
    converges, bit-equal to a first run at its final_params and to
    mesh=None."""
    for r in ranks("3"):
        info = r["retry"]
        assert "overflow" in info["first_issues"]
        assert info["issues"] == {} and info["attempts"] == 2
        assert info["final"]["shuffle_bucket_floor"] > 0
        assert info["final"]["shuffle_slack"] == 3.0
        assert info["equal_first"] and info["equal_ref"]


@pytest.mark.multidevice
def test_exchange_fault_propagates(ranks):
    for r in ranks("3"):
        assert r["fault"].startswith("raised: injected exchange fault")
        assert r["fault"].endswith("consumed=True")


# ------------------------------------------- the keywords, on one rank
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process (torn down after the
    module)."""
    import torch.distributed as tdist
    store = tdist.FileStore(str(tmp_path_factory.mktemp("one") / "store"), 1)
    tdist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        from repro_torch.launch.mesh import make_mesh
        yield make_mesh((1,), ("data",), device="cpu")
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def tdb(jax_db):
    return ttpch.from_numpy(_arrays(jax_db), device="cpu")


def _probe_key_plan():
    """Q3's lineitem-orders join on a computed probe key: its probe bucket
    is slack-sized (no histogram reaches a computed column)."""
    from repro_torch.db import plans as P
    li = P.Map(P.Scan("lineitem"), "okey", lambda t: t["l_orderkey"] + 0)
    j = P.FKJoin(li, P.Scan("orders"), "okey", "o_orderkey",
                 ("o_orderdate",), gather_budget=4)
    return P.GroupAgg(j, ("l_returnflag",), "l_quantity", "SUM", 8)


@pytest.mark.parametrize("keyword", ["mesh", "stats_tables",
                                     "shuffle_slack", "shuffle_bucket_floor"])
def test_mesh_keywords_take_effect(one_rank, tdb, keyword):
    """Each mesh keyword of compile_plan now takes effect: a one-rank gloo
    mesh equals mesh=None (and a non-Mesh raises TypeError); stats_tables,
    shuffle_slack and shuffle_bucket_floor change the bucket capacities
    that explain prints."""
    from repro_torch.db import plans as P
    tables = tdb.tables()
    cpu = dict(device="cpu")
    if keyword == "mesh":
        for plan in (ttpch.q1_plan(), ttpch.q3_plan(max_groups=Q3_GROUPS),
                     ttpch.q20_plan()):
            assert _bit_equal(P.compile_plan(plan, **cpu)(tables),
                              P.compile_plan(plan, one_rank, **cpu)(tables))
        with pytest.raises(TypeError, match="Mesh"):
            P.compile_plan(ttpch.q1_plan(), object(), **cpu)
        return
    plan = _probe_key_plan()
    base = dict(shuffle_slack=0.25, **cpu)
    if keyword == "stats_tables":
        from repro.db import tpch as jtpch
        older = ttpch.from_numpy(_arrays(jtpch.generate(
            n_orders=N_ORDERS // 2, seed=SEED)), device="cpu")
        other = dict(stats_tables=dict(tables, orders=older.orders))
    elif keyword == "shuffle_slack":
        other = dict(shuffle_slack=1.0)
    else:
        other = dict(shuffle_bucket_floor=tables["lineitem"].capacity)
    before = P.compile_plan(plan, one_rank, **base).explain(tables)
    after = P.compile_plan(plan, one_rank, **dict(base, **other))
    assert "buckets=(build=" in before
    assert after.explain(tables) != before
    if keyword != "stats_tables":
        # a bucket of the sender's local rows cannot overflow
        assert _bit_equal(P.compile_plan(plan, **cpu)(tables),
                          after(tables))


def test_default_mesh_device_is_the_card(one_rank):
    """make_mesh's device defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh((1,), ("data",))
