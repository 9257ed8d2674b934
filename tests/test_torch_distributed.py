"""The multi-rank protocol pieces of the port (``repro_torch.db.distributed``,
``repro_torch.launch.mesh``, ``repro_torch.testing.ranks``).

The exchange-bucket helpers are held against the JAX package's
``repro.db.operators`` on the same numpy inputs.  The collectives run on
2, 3 and 4 gloo ranks on the CPU, one spawn per rank count for the whole
file (the rank function runs every case and returns what each rank saw),
and are held against the port's single-device functions: bit for bit
where the protocol promises it (shuffle round trip, group ids, gathered
tables, the two canonical merges), within the float64 tolerance of
tests/test_torch_tpch.py for the psum merges (a backend's all_reduce adds
in its own order).
"""
import numpy as np
import pytest
import torch

from repro_torch.db import operators as ops
from repro_torch.testing.ranks import RankFailed, run_ranks

WORLDS = (2, 3, 4)
CHUNKS = 8
CSZ = 24                      # rows of one canonical chunk
GROUPS = 16


# ------------------------------------------------------ bucket helpers
def _bucket_inputs(seed, n, n_shards):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n_shards, n).astype(np.int32)
    ok = rng.random(n) < 0.8
    cols = {"x": rng.random(n), "k": rng.integers(0, 100, n)}
    return dest, ok, cols


@pytest.mark.parametrize("seed,n,n_shards,capacity", [
    (0, 40, 3, 20), (1, 40, 3, 6), (2, 64, 4, 16), (3, 64, 4, 3),
    (4, 17, 2, 9), (5, 1, 2, 1)])
def test_bucket_helpers_match_jax(seed, n, n_shards, capacity):
    """bucket_slots / bucket_fill_index / scatter_to_buckets /
    take_from_buckets equal the JAX package's, overflow included."""
    import jax
    import jax.numpy as jnp
    from repro.db import operators as jops
    dest, ok, cols = _bucket_inputs(seed, n, n_shards)
    size = n_shards * capacity

    @jax.jit
    def ref(dest, ok, cols):
        slot, sent, over = jops.bucket_slots(dest, ok, n_shards, capacity)
        inv = jops.bucket_fill_index(slot, size)
        send = jops.scatter_to_buckets(cols, slot, size, inv=inv)
        back = jops.take_from_buckets(send, slot, sent)
        return slot, sent, over, inv, send, back

    want = jax.tree.map(np.asarray, ref(
        jnp.asarray(dest), jnp.asarray(ok),
        {k: jnp.asarray(v) for k, v in cols.items()}))
    t = {k: torch.from_numpy(v) for k, v in cols.items()}
    slot, sent, over = ops.bucket_slots(torch.from_numpy(dest),
                                        torch.from_numpy(ok), n_shards,
                                        capacity)
    inv = ops.bucket_fill_index(slot, size)
    send = ops.scatter_to_buckets(t, slot, size, inv=inv)
    back = ops.take_from_buckets(send, slot, sent)
    got = (slot, sent, over, inv, send, back)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(np.asarray(g), w)
    for g, w in ((send, want[4]), (back, want[5])):
        for k in cols:
            np.testing.assert_array_equal(g[k].numpy(), w[k])


# ------------------------------------------------------- rank protocol
def _global_columns(world):
    """The same global columns on every rank: CHUNKS canonical chunks of
    CSZ rows, shard-padded with invalid rows for ``world`` ranks."""
    rng = np.random.default_rng(11)
    n = CHUNKS * CSZ
    local = -(-CHUNKS // world)
    padded = world * local * CSZ
    p = np.zeros(padded)
    p[:n] = rng.uniform(0.05, 0.95, n)
    v = np.zeros(padded, np.int64)
    v[:n] = rng.integers(0, 9, n)
    key = np.zeros(padded, np.int64)
    key[:n] = rng.integers(0, 3 * GROUPS, n)
    valid = np.zeros(padded, bool)
    valid[:n] = rng.random(n) < 0.9
    return (torch.from_numpy(p), torch.from_numpy(v), torch.from_numpy(key),
            torch.from_numpy(valid), local)


def _udas():
    from repro_torch.core import uda
    return dict(conf=uda.AtLeastOne(), normal=uda.SumNormal(),
                cum=uda.SumCumulants(4), cf=uda.SumCF(40, 3, 21),
                mm=uda.MinMax(kappa=3))


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _close(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_close(x, y) for x, y in zip(a, b))
    return torch.allclose(a, b, rtol=1e-9, atol=1e-12)


def _protocol_cases(world):
    """Every protocol case on this rank; returns {case: bool}."""
    import torch.distributed as tdist
    from repro_torch.core import aggregates, poisson_binomial, uda
    from repro_torch.db import distributed as dist
    from repro_torch.db.table import Table
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",), device="cpu")
    ax = mesh.axis("data")
    r = ax.index
    p, v, key, valid, local = _global_columns(world)
    rows = local * CSZ
    sl = slice(r * rows, (r + 1) * rows)
    glob = Table({"key": key, "v": v}, p, valid)
    mine = Table({"key": key[sl], "v": v[sl]}, p[sl], valid[sl])
    out = {}

    # gather_table: the global table back, bit for bit
    g = dist.gather_table(mine, ax)
    out["gather_table"] = all(_same(g[c], glob[c]) for c in ("key", "v")) \
        and _same(g.prob, glob.prob) and _same(g.valid, glob.valid)

    # shuffle_by_key + shuffle_back: every sent row reaches its owner and
    # comes home unchanged; a small bucket overflows and is counted
    for name, cap in (("shuffle_round_trip", rows), ("shuffle_overflow", 3)):
        cols = {"key": mine["key"], "p": mine.prob}
        recv, mask, slot, sent, over = dist.shuffle_by_key(
            mine["key"], cols, ax, n_shards=world, capacity=cap,
            valid=mine.valid)
        owner_ok = bool(torch.all(~mask | (recv["key"] % world == r)))
        got = ops.take_from_buckets(dist.shuffle_back(recv, ax), slot, sent)
        back_ok = _same(got["key"], torch.where(sent, mine["key"], 0)) \
            and _same(got["p"], torch.where(sent, mine.prob, 0.0))
        total = int(dist.psum(over, ax))
        dest = key[valid] % world
        rank_of = torch.arange(key.shape[0])[valid] // rows
        need = torch.zeros(world, world, dtype=torch.int64)
        need.index_put_((rank_of, dest), torch.ones_like(dest),
                        accumulate=True)
        want = int((need - cap).clamp(min=0).sum())
        out[name] = owner_ok and back_ok and total == want \
            and (want > 0) == (name == "shuffle_overflow")

    # group ids: the single-device ids of the global table, overflow too
    for mg in (64, 20):
        ids, merged, gvalid = dist.group_ids_sharded(mine, ["key"], mg, ax)
        w_ids, w_merged, w_gvalid = ops.group_ids(glob, ["key"], mg)
        out[f"group_ids_{mg}"] = _same(ids, w_ids[sl]) \
            and _same(merged, w_merged) and _same(gvalid, w_gvalid)
        kc = dist.group_key_columns_sharded(mine, ["key"], ids, mg, ax)
        out[f"key_columns_{mg}"] = _same(
            kc["key"], ops.group_key_columns(glob, ["key"], w_ids, mg)["key"])

    # allgather_merge: tree_fold over every canonical chunk state
    udas = _udas()
    gid = torch.remainder(key, GROUPS)
    n = CHUNKS * CSZ
    mp = torch.where(valid, p, 0.0)
    want = uda.accumulate_chunked(udas, mp[:n], v[:n], gid[:n],
                                  max_groups=GROUPS, num_chunks=CHUNKS)
    real = max(0, min(local, CHUNKS - r * local))
    parts = uda.accumulate_chunk_states(
        udas, mp[sl][:real * CSZ], v[sl][:real * CSZ], gid[sl][:real * CSZ],
        max_groups=GROUPS, num_chunks=real) if real else []
    parts += [{k: u.init(GROUPS, mp.dtype, "cpu") for k, u in udas.items()}
              ] * (local - real)
    got = dist.allgather_merge(udas, parts, ax, CHUNKS, world)
    out["allgather_merge"] = all(_same(got[k], want[k]) for k in udas)
    # gather_chunk_states: every rank's chunk states, rank-major
    states = dist.gather_chunk_states(udas, parts, ax)
    out["gather_chunk_states"] = all(
        _same(uda.tree_fold(u, [s[k] for s in states[:CHUNKS]]), want[k])
        for k, u in udas.items())

    # partitioned_merge: each rank holds the groups g % world == rank at
    # their canonical positions; owner state + exact zeros elsewhere
    pos = torch.arange(n)
    owned = valid[:n] & (gid[:n] % world == r)
    cp, cv, cg = dist.chunk_columns(
        mp[:n], {"x": v[:n]}, gid[:n], (pos // CSZ).to(torch.int32),
        (pos % CSZ).to(torch.int32), owned, chunk_size=CSZ,
        num_chunks=CHUNKS, max_groups=GROUPS)
    parts = uda.accumulate_chunk_states(udas, cp, cv["x"], cg,
                                        max_groups=GROUPS, num_chunks=CHUNKS)
    got = dist.partitioned_merge(udas, parts, ax, n_shards=world)
    out["partitioned_merge"] = all(_same(got[k], want[k]) for k in udas)

    # psum merges: within tolerance of the single-device sums
    st = uda.accumulate(udas, mp[sl], v[sl], gid[sl], max_groups=GROUPS)
    red = uda.reduce_collective(udas, st, ax)
    one = uda.accumulate(udas, mp, v, gid, max_groups=GROUPS)
    out["reduce_collective"] = all(_close(red[k], one[k]) for k in udas)
    la, an = poisson_binomial.sharded_logcf(mp[sl], v[sl], 40, ax)
    wla, wan = poisson_binomial.logcf_terms(mp, v, 40)
    out["sharded_logcf"] = _close(la, wla) and _close(an, wan)
    norm = aggregates.SumNormal
    s_loc = norm.accumulate(norm.init(torch.float64, "cpu"), mp[sl], v[sl])
    s_all = norm.accumulate(norm.init(torch.float64, "cpu"), mp, v)
    out["psum_merge"] = _close(norm.psum_merge(s_loc, ax).terms, s_all.terms)
    pp, vv, gg = dist.pad_for(mesh, mp[:n - 5], v[:n - 5], gid[:n - 5],
                              max_groups=GROUPS)
    step = dist.make_uda_step(
        mesh, lambda size, rank: dict(conf=uda.AtLeastOne(),
                                      normal=uda.SumNormal()),
        max_groups=GROUPS)
    res = step(pp, vv, gg)
    ref = uda.finalize(dict(conf=uda.AtLeastOne(), normal=uda.SumNormal()),
                       uda.accumulate(dict(conf=uda.AtLeastOne(),
                                           normal=uda.SumNormal()),
                                      mp[:n - 5], v[:n - 5], gid[:n - 5],
                                      max_groups=GROUPS))
    out["make_uda_step"] = _close(res["conf"], ref["conf"]) \
        and _close(res["normal"], ref["normal"])

    # the canonical query step: per-group confidence, Normal and
    # cumulant terms, and the exact global distribution
    qstep = dist.make_query_step(mesh, max_groups=GROUPS, num_freq=40,
                                 orders=4)
    conf, normal, cum, coeffs = qstep(pp, vv, gg)
    q_udas = dict(conf=uda.AtLeastOne(), normal=uda.SumNormal(),
                  cum=uda.SumCumulants(4))
    q_one = uda.accumulate(q_udas, mp[:n - 5], v[:n - 5], gid[:n - 5],
                           max_groups=GROUPS)
    cf_one = uda.accumulate({"cf": uda.SumCF(40)}, mp[:n - 5], v[:n - 5],
                            None)["cf"]
    out["make_query_step"] = _close(conf, uda.AtLeastOne().finalize(
        q_one["conf"])) and _close(normal, q_one["normal"].terms) \
        and _close(cum, q_one["cum"].terms) \
        and _close(coeffs, uda.SumCF(40).finalize(cf_one)[0])

    # a scalar exact-CF pass split over the ranks as a model axis: each
    # runs its window of the logcf kernel's N/2 + 1 columns (the plain
    # version here), the gathered half is mirrored: the unsplit bits
    from repro_torch.db import plans
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pb_cf
    rng = np.random.default_rng(5)
    m = kops.MIN_KERNEL_TUPLES
    p32 = torch.from_numpy(rng.uniform(0.05, 0.95, m).astype(np.float32))
    a = torch.from_numpy(rng.integers(0, 1000, m))
    whole = uda.accumulate({"cf": uda.SumCF(257)}, p32, a, None)["cf"]
    win = {}
    for nf in (257, 256, 2 * world - 1):
        pa = type("Pass", (), dict(max_groups=1, num_freq=nf, kappa=1,
                                   specs=[("cf", "v", "SUM", "exact")]))
        assert plans._mirrored(pa, ["cf"], ((0, nf),), p32, {"cf": a})
        u, _ = plans._slab_udas(pa, 1, 0, nf, {"cf": a}, r, world, True)
        st = uda.accumulate(u, p32, {"cf": a}, None)
        win[nf] = plans._gather_model_slabs(u, st, ["cf"], nf, ax, True,
                                            True)["cf"]
        want = uda.accumulate({"cf": uda.SumCF(nf)}, p32, a, None)["cf"]
        win[nf] = u["cf"].half and win[nf].log_abs.shape == (1, nf) and \
            _same(win[nf].log_abs, want.log_abs) and \
            _same(win[nf].angle, want.angle)
    out["scalar_cf_model_split"] = all(win.values()) and _same(
        pb_cf.mirror(*pb_cf.logcf(p32, a, num_freq=257, freq_lo=0,
                                  freq_cnt=129), 257)[0],
        whole.log_abs[0])

    # the model-axis gather along the last dim
    x = torch.arange(6.0).reshape(2, 3) + 10 * r
    gl = dist.all_gather_last(x, ax)
    out["all_gather_last"] = _same(gl, torch.cat(
        [torch.arange(6.0).reshape(2, 3) + 10 * i for i in range(world)], -1))
    tdist.barrier()
    return out


CASES = ("gather_table", "shuffle_round_trip", "shuffle_overflow",
         "group_ids_64", "group_ids_20", "key_columns_64", "key_columns_20",
         "allgather_merge", "gather_chunk_states", "partitioned_merge",
         "reduce_collective", "sharded_logcf", "psum_merge",
         "make_uda_step", "make_query_step", "scalar_cf_model_split",
         "all_gather_last")


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """{world: per-rank results}, the three spawns side by side."""
    from concurrent.futures import ThreadPoolExecutor

    # (made here, not in the threads: the first mktemp creates the base)
    dirs = {w: tmp_path_factory.mktemp(f"ranks{w}") for w in WORLDS}

    def spawn(world):
        return run_ranks(_protocol_cases, world, backend="gloo",
                         device="cpu", store_dir=dirs[world], args=(world,))
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = dict(zip(WORLDS, pool.map(spawn, WORLDS)))
    return runs.__getitem__


@pytest.mark.multidevice
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_protocol_on_gloo_ranks(protocol, world, case):
    results = protocol(world)
    assert [r[case] for r in results] == [True] * world


@pytest.mark.multidevice
def test_run_ranks_raises_the_failing_rank(tmp_path):
    """A rank's exception fails run_ranks with its traceback (the peer
    blocked in a collective is ended, never left hanging)."""
    with pytest.raises(RankFailed) as ei:
        run_ranks(_fail_on_rank_one, 2, device="cpu", store_dir=tmp_path)
    assert ei.value.rank == 1
    assert "ValueError: rank one fails" in str(ei.value)


def test_run_ranks_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``device=`` the ranks compute on the card; on a host
    without one that raises before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_ranks(_fail_on_rank_one, 2, store_dir=tmp_path)
    assert not any(tmp_path.iterdir())


def _fail_on_rank_one():
    import torch.distributed as tdist
    if tdist.get_rank() == 1:
        raise ValueError("rank one fails")
    tdist.all_reduce(torch.ones(1))
    return 0
