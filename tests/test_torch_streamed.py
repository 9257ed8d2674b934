"""Out-of-core streamed execution in the port (``repro_torch.db.plans``
with ``device_row_budget``, ``repro_torch.db.table.HostTable``).

Inside the port, streamed must equal resident bit for bit, for every
TPC-H query, with column pruning on and off, for any wave size, from
numpy and from memory-mapped columns (exact equality, never allclose, as
in tests/test_streamed.py).  Against the JAX package the port's streamed
results agree within the float64 tolerances of tests/test_torch_tpch.py;
the JAX side runs its resident plan under ``jax.jit`` (its own tests hold
its streamed path bit-equal to that).  Runs on the CPU (``device="cpu"``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.db import tpch as jtpch
from repro.db.plans import compile_plan as jcompile
from repro_torch.db import plans as P
from repro_torch.db import tpch
from repro_torch.db.plans import GroupAgg, Scan, Select, compile_plan
from repro_torch.db.table import HostTable, Table

pytestmark = pytest.mark.outofcore

# lineitem = 192 rows (24 per chunk of the 8-chunk grid); orders 48,
# partsupp 96, the rest smaller: a budget of 64 rows streams only
# lineitem, 128 keeps q20's partsupp build side resident.
TINY = dict(n_orders=48, lines_per_order=4, n_parts=24, n_suppliers=8,
            n_customers=24, seed=0)
BUDGET = {"q1": 64, "q3": 64, "q6": 64, "q18": 64, "q20": 128}
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def db():
    return tpch.generate(**TINY, device="cpu")


def _run_query(db, qname, plan_opts=None):
    kw = dict(plan_opts=plan_opts) if plan_opts else {}
    if qname == "q1":
        return tpch.q1(db, "aggregate", **kw)
    if qname == "q3":
        return tpch.q3(db, "aggregate", max_groups=64, **kw)
    if qname == "q6":
        return tpch.q6(db, "aggregate", num_freq=256, **kw)
    if qname == "q18":
        return tpch.q18(db, "aggregate", max_groups=64, **kw)
    return tpch.q20(db, "aggregate", max_groups=64, **kw)


def _plan(mod, qname):
    return {"q1": lambda: mod.q1_plan(),
            "q3": lambda: mod.q3_plan(max_groups=64),
            "q6": lambda: mod.q6_plan(num_freq=256),
            "q18": lambda: mod.q18_plan(max_groups=64),
            "q20": lambda: mod.q20_plan(max_groups=64)}[qname]()


def _q18_exact(plans):
    """Q18's exact plan (tpch.q18(method="exact")), in either package."""
    return plans.GroupAgg(plans.Scan("lineitem"), ("l_orderkey",),
                          "l_quantity", "SUM", 64, "exact", num_freq=256)


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}.{k}")
    elif isinstance(x, tuple):
        for i, y in enumerate(x):
            yield from _leaves(y, f"{path}[{i}]")
    elif hasattr(x, "columns"):                 # a Table (either package)
        yield from _leaves(dict(x.columns, p=x.prob, valid=x.valid), path)
    elif isinstance(x, torch.Tensor):
        yield path, x.numpy()
    else:
        yield path, np.asarray(x)


def _assert_biteq(ref, got):
    a, b = list(_leaves(ref)), list(_leaves(got))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, path
        if np.issubdtype(x.dtype, np.floating):
            same = (x == y) | (np.isnan(x) & np.isnan(y))
            assert same.all(), (path, x, y)
        else:
            np.testing.assert_array_equal(x, y, err_msg=path)


# ---------------------------------------------------- streamed == resident
@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("qname", sorted(tpch.QUERIES))
def test_streamed_bit_equal_resident(db, qname, prune):
    """Every TPC-H query: streamed lineitem == resident, bit for bit, with
    required-column pruning on (the default) and off; the run really
    streamed."""
    ref = _run_query(db, qname)
    P.reset_stream_stats()
    got = _run_query(db, qname, dict(device_row_budget=BUDGET[qname],
                                     stream_prune_columns=prune, **CPU))
    assert P.stream_stats()["waves"] > 0
    _assert_biteq(ref, got)


@pytest.mark.parametrize("wave_chunks", [1, 3, 8])
def test_wave_size_invariance(db, wave_chunks):
    """One chunk per wave, a ragged tail (3 of 8 slots: a padding slot)
    and the whole table in one wave all give the resident bits."""
    for qname in ("q1", "q6", "q18"):
        _assert_biteq(_run_query(db, qname), _run_query(
            db, qname, dict(device_row_budget=64,
                            stream_wave_chunks=wave_chunks, **CPU)))


@pytest.mark.parametrize("qname", sorted(tpch.QUERIES))
def test_streamed_from_memmap(db, qname, tmp_path):
    """Every query streaming from a disk-backed (save -> open, np.memmap)
    lineitem equals the resident run, pruned and unpruned, for wave sizes
    1, 3 and 8."""
    plan = _plan(tpch, qname)
    tabs = db.tables()
    ref = compile_plan(plan)(tabs)
    HostTable.from_table(tabs["lineitem"]).save(str(tmp_path / "li"))
    disk = dict(tabs, lineitem=HostTable.open(str(tmp_path / "li")))
    assert isinstance(disk["lineitem"]["l_quantity"], np.memmap)
    runs = [dict(stream_prune_columns=p) for p in (True, False)] \
        + [dict(stream_wave_chunks=wc) for wc in (1, 3, 8)]
    for opts in runs:
        got = compile_plan(plan, device_row_budget=BUDGET[qname], **opts,
                           **CPU)(disk)
        _assert_biteq(ref, got)


def test_sync_transfer_matches_double_buffered(db):
    """stream_double_buffer only changes the transfer schedule."""
    _assert_biteq(_run_query(db, "q1"), _run_query(
        db, "q1", dict(device_row_budget=64, stream_double_buffer=False,
                       **CPU)))


def test_streamed_exact_cf_frequency_slabs(db):
    """Exact CF over several frequency slabs, streamed: the per-wave slab
    passes and the cross-wave fold compose bit-exactly (Q6 scalar)."""
    opts = dict(cf_budget_elems=256)
    _assert_biteq(
        tpch.q6(db, "aggregate", num_freq=256, plan_opts=opts),
        tpch.q6(db, "aggregate", num_freq=256,
                plan_opts=dict(opts, device_row_budget=64, **CPU)))


def test_streamed_q18_exact_slabs_presorted_operands():
    """Q18 exact with three frequency slabs at a size where the grouped CF
    accumulation takes the kernel route (256-tuple chunks, float32): the
    resident pass hoists presorted operands above its slab loop and every
    wave does the same, so the two agree bit for bit."""
    db = tpch.generate(n_orders=512, lines_per_order=4, n_parts=64,
                       n_suppliers=8, n_customers=64, seed=1, device="cpu")
    kw = dict(method="exact", num_freq=256, max_groups=512)
    opts = dict(cf_budget_elems=2 * 512 * 100)
    ref = tpch.q18(db, "aggregate", plan_opts=opts, **kw)
    for wc in (2, 3):
        got = tpch.q18(db, "aggregate", **kw, plan_opts=dict(
            opts, device_row_budget=600, stream_wave_chunks=wc, **CPU))
        _assert_biteq(ref, got)


def test_pruned_stream_ships_fewer_bytes(db):
    """Q6 (3 of 10 lineitem columns) pruned ships fewer slab bytes than
    unpruned over the same waves, and the slicing timer advances."""
    host = dict(db.tables(), lineitem=HostTable.from_table(db.lineitem))
    seen = {}
    for prune in (True, False):
        P.reset_stream_stats()
        compile_plan(tpch.q6_plan(), device_row_budget=64,
                     stream_wave_chunks=1, stream_prune_columns=prune,
                     **CPU)(host)
        seen[prune] = P.stream_stats()
    assert seen[True]["slab_bytes"] < seen[False]["slab_bytes"]
    assert seen[True]["waves"] == seen[False]["waves"] == 16
    assert seen[True]["slice_s"] > 0.0 and seen[True]["copy_s"] == 0.0


def test_host_table_streams_and_materialises(db):
    """A HostTable input streams under a budget, materialises on the
    requested device without one, and both give the device-resident
    bits."""
    plan = GroupAgg(Scan("lineitem"), ("l_returnflag",), "l_quantity",
                    "SUM", 4, "normal")
    dev = db.tables()
    host = dict(dev, lineitem=HostTable.from_table(db.lineitem))
    ref = compile_plan(plan)(dev)
    _assert_biteq(ref, compile_plan(plan, **CPU)(host))
    _assert_biteq(ref, compile_plan(plan, device_row_budget=64,
                                    **CPU)(host))


# ------------------------------------------------------ JAX parity, float64
def _bridged():
    jdb = jtpch.generate(**TINY)
    arrays = {name: dict(columns={k: np.asarray(v)
                                  for k, v in t.columns.items()},
                         prob=np.asarray(t.prob), valid=np.asarray(t.valid))
              for name, t in jdb.tables().items()}
    return jdb, tpch.from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def bridged():
    return _bridged()


@pytest.mark.parametrize("qname", sorted(tpch.QUERIES) + ["q18_exact"])
def test_streamed_matches_jax(bridged, qname):
    """The port's streamed plan on the JAX package's tables (float64)
    against the JAX plan under jax.jit: keys, masks and group ids equal,
    floats within rtol=1e-9, atol=1e-12 (the two sum in other orders).
    Q18 exact runs over three frequency slabs (100 + 100 + 56)."""
    jdb, tdb = bridged
    if qname == "q18_exact":
        from repro.db import plans as jplans
        opts = dict(cf_budget_elems=2 * 64 * 100)
        want = jax.jit(jcompile(_q18_exact(jplans), **opts))(jdb.tables())
        got = compile_plan(_q18_exact(P), device_row_budget=64, **opts,
                           **CPU)(tdb.tables())
    else:
        want = jax.jit(jcompile(_plan(jtpch, qname)))(jdb.tables())
        got = compile_plan(_plan(tpch, qname),
                           device_row_budget=BUDGET[qname],
                           **CPU)(tdb.tables())
    a, b = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, w), (_, g) in zip(a, b):
        assert g.shape == w.shape, path
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype, path
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


# ----------------------------------------------------- HostTable mechanics
def test_host_table_slabs():
    ht = HostTable({"a": np.arange(10)}, prob=np.full(10, 0.5))
    s = ht.slab(8, 4)
    assert isinstance(s, Table) and s.capacity == 4
    assert s["a"].tolist() == [8, 9, 0, 0]
    assert s.valid.tolist() == [True, True, False, False]
    assert s.prob.tolist() == [0.5, 0.5, 0.0, 0.0]
    ws = ht.pad_to(12).wave_slab((0, 6), 3)
    assert ws["a"].tolist() == [0, 1, 2, 6, 7, 8]
    assert [s0 for s0, _ in ht.slabs(4)] == [0, 4, 8]


def test_wave_slab_strided_starts_and_virtual_pad():
    """Runs with gaps between them, concatenated in order; a run reaching
    past the stored rows zero-fills (the virtual pad)."""
    ht = HostTable({"a": np.arange(20)}, prob=np.full(20, 0.25)).pad_to(24)
    ws = ht.wave_slab((2, 11, 21), 3)
    assert ws["a"].tolist() == [2, 3, 4, 11, 12, 13, 0, 0, 0]
    assert ws.valid[-4:].tolist() == [True, False, False, False]
    assert ws.prob[-3:].tolist() == [0, 0, 0]


def test_wave_slab_fills_alloc_slab_buffers():
    """wave_slab(out=) writes the alloc_slab tensors in place (the
    ping-pong pair; plain CPU tensors for device="cpu") and returns them;
    a second fill overwrites, zeroed tail included."""
    ht = HostTable({"a": np.arange(10, dtype=np.int64)},
                   prob=np.full(10, 0.5)).pad_to(12)
    buf = ht.alloc_slab(6, device="cpu")
    assert not buf.prob.is_pinned() and buf["a"].dtype == torch.int64
    assert buf.valid.dtype == torch.bool
    out = ht.wave_slab((0, 6), 3, out=buf)
    assert out.columns["a"] is buf.columns["a"]
    assert out.prob is buf.prob and out.valid is buf.valid
    assert buf["a"].tolist() == [0, 1, 2, 6, 7, 8]
    ht.wave_slab((3, 9), 3, out=buf)
    assert buf["a"].tolist() == [3, 4, 5, 9, 0, 0]
    assert buf.valid.tolist() == [True] * 4 + [False] * 2
    assert buf.prob[-2:].tolist() == [0.0, 0.0]


def test_save_open_roundtrip(tmp_path):
    """save -> open restores values, dtypes and the virtual padding (only
    stored rows reach the disk); mmap_mode=None loads into RAM."""
    ht = HostTable({"a": np.arange(10), "b": np.linspace(0, 1, 10)},
                   prob=np.full(10, 0.5),
                   valid=np.arange(10) % 3 != 0).pad_to(16)
    ht.save(str(tmp_path))
    back = HostTable.open(str(tmp_path))
    assert back.capacity == 16 and back.stored_rows == 10
    for k in ("a", "b"):
        assert isinstance(back[k], np.memmap) and back[k].dtype == ht[k].dtype
        np.testing.assert_array_equal(back[k], ht[k])
    np.testing.assert_array_equal(back.prob, ht.prob)
    np.testing.assert_array_equal(back.valid, ht.valid)
    _assert_biteq(ht.to_table("cpu"), back.to_table("cpu"))
    ram = HostTable.open(str(tmp_path), mmap_mode=None)
    assert not isinstance(ram["a"], np.memmap)


def test_select_columns_pad_and_cache():
    ht = HostTable({"a": np.arange(10), "b": np.arange(10) * 2},
                   prob=np.full(10, 0.5)).pad_to(16)
    pruned = ht.select_columns(["a"])
    assert set(pruned.columns) == {"a"}
    assert pruned["a"] is ht["a"] and pruned.prob is ht.prob
    assert pruned.capacity == 16
    assert pruned.slab(8, 4)["a"].tolist() == [8, 9, 0, 0]
    one = HostTable({"a": np.asarray([7])}, prob=np.asarray([0.5]))
    p8 = one.pad_to_multiple(8)
    assert p8.capacity == 8 and p8.stored_rows == 1
    assert p8.pad_to_multiple(8) is p8
    t = p8.to_table("cpu")
    assert t["a"].tolist() == [7] + [0] * 7
    assert t.valid.tolist() == [True] + [False] * 7


def test_one_chunk_table_streams(db):
    """A one-chunk grid streams in one wave and equals resident."""
    one = Table.from_columns({"k": db.lineitem["l_returnflag"][:8],
                              "v": db.lineitem["l_quantity"][:8]},
                             prob=db.lineitem.prob[:8])
    plan = GroupAgg(Scan("t"), ("k",), "v", "SUM", 4, "normal")
    ref = compile_plan(plan, canonical_chunks=1)({"t": one})
    got = compile_plan(plan, canonical_chunks=1, device_row_budget=4,
                       **CPU)({"t": HostTable.from_table(one)})
    _assert_biteq(ref, got)


# --------------------------------------------------------- rejections
def test_streamed_build_side_rejected(db):
    """Only the probe side of a join may stream: a budget that streams a
    build-side table is a NotImplementedError, not a wrong answer."""
    with pytest.raises(NotImplementedError, match="build side"):
        tpch.q20(db, "aggregate", max_groups=64,
                 plan_opts=dict(device_row_budget=64, **CPU))


def test_streamed_requires_aggregation(db):
    """A StreamedScan with no aggregation above it cannot execute; the
    error names the knobs that avoid it."""
    fn = compile_plan(Select(Scan("lineitem"), lambda t: t["l_quantity"] > 0),
                      device_row_budget=64, **CPU)
    with pytest.raises(NotImplementedError,
                       match="grouped aggregation") as ei:
        fn(db.tables())
    assert "device_row_budget" in str(ei.value)
    assert "to_table" in str(ei.value)


def test_streamed_default_device_is_the_card(db):
    """A streamed compile left at its default device ships to the card:
    on a host with none it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpch.q1(db, "aggregate", plan_opts=dict(device_row_budget=64))


@pytest.mark.parametrize("num_chunks", [1, 5, 8, 11])
def test_chunk_state_accumulator_is_tree_fold(num_chunks):
    """The accumulator's incremental fold is tree_fold's tree, bit for
    bit, for any wave size (padding slots dropped) and any filing order
    of a wave's chunks; a chunk filed twice or never filed raises."""
    from repro_torch.core import uda
    u = uda.SumNormal()
    gen = torch.Generator().manual_seed(num_chunks)
    parts = [{"n": uda.NormalState(torch.randn(4, 2, generator=gen) * 1e3)}
             for _ in range(num_chunks)]
    want = uda.tree_fold(u, [p["n"] for p in parts])
    for wave in (1, 3, num_chunks):
        acc = uda.ChunkStateAccumulator({"n": u}, num_chunks)
        for w in reversed(range(-(-num_chunks // wave))):
            ids = list(range(w * wave, (w + 1) * wave))
            acc.add_wave(ids, [parts[i] if i < num_chunks else None
                               for i in ids])
        assert torch.equal(acc.fold()["n"].terms, want.terms)
        with pytest.raises(RuntimeError, match="filed twice"):
            acc.add_wave([0], [parts[0]])
    short = uda.ChunkStateAccumulator({"n": u}, num_chunks + 1)
    short.add_wave(list(range(num_chunks)), parts)
    with pytest.raises(RuntimeError, match="never streamed"):
        short.fold()
