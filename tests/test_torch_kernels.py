"""The port's five kernel modules on the CPU: each plain PyTorch version
against the JAX package's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and against ``repro.kernels.ref``, with
the bounds those tests use; the split-modmult operands, the piece table
of the grouped kernels and the dispatch guards.  The CUDA kernels
themselves run only on a card (tests/test_torch_cuda.py; ``chip_smoke.py``
holds them against the plain versions at the SF1 shapes)."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.approx import _bernoulli_cumulant_polys
from repro.kernels import cumulants as jcum
from repro.kernels import group_cf as jgcf
from repro.kernels import group_cumulants as jgcum
from repro.kernels import pb_cf as jcf
from repro.kernels import polymul as jpm
from repro.kernels import ref as jref
from repro_torch.kernels import cumulants, group_cf, group_cumulants, ops
from repro_torch.kernels import pb_cf, polymul, ref, segments


def _cf_inputs(rng, n, num_groups=1, vmax=50):
    p = rng.uniform(0.01, 0.99, n).astype(np.float32)
    v = rng.integers(0, vmax, n).astype(np.int32)
    g = rng.integers(0, num_groups, n).astype(np.int32)
    return p, v, g


def _assert_angles_close(got, want, atol):
    """Angle sums compared modulo 2*pi (tests/test_group_cf.py:31)."""
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    wrapped = np.abs(np.mod(d + np.pi, 2 * np.pi) - np.pi)
    np.testing.assert_array_less(wrapped, atol)


def _assert_scale_aware_close(got, want, p, v, g, num_groups, orders,
                              rtol=2e-6):
    """Bound by the absolute-coefficient scale sum_d |c_jd| p^d |v|^j per
    group (tests/test_group_cumulants.py:27)."""
    tabs = np.abs(_bernoulli_cumulant_polys()[1:orders + 1]).astype(
        np.float32)
    powers = p[None, :].astype(np.float64) ** np.arange(tabs.shape[1])[:,
                                                                       None]
    vpow = np.abs(v[None, :].astype(np.float64)) ** np.arange(
        1, orders + 1)[:, None]
    rows = ((tabs @ powers) * vpow).T
    scale = np.zeros((num_groups, orders))
    np.add.at(scale, g, rows)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    np.testing.assert_array_less(err, rtol * np.maximum(scale, 1.0))


@pytest.mark.parametrize("n,num_freq", [(100, 129), (300, 257),
                                        (1000, 1001)])
def test_logcf_plain_matches_pallas(rng, n, num_freq):
    p, v, _ = _cf_inputs(rng, n)
    la_k, an_k = jcf.logcf(jnp.asarray(p), jnp.asarray(v),
                           num_freq=num_freq, interpret=True)
    la_r, an_r = jref.logcf_ref(jnp.asarray(p), jnp.asarray(v, jnp.float32),
                                num_freq)
    la, an = pb_cf.logcf(torch.from_numpy(p), torch.from_numpy(v),
                         num_freq=num_freq)
    tol = 5e-4 * max(1, n / 500)
    for want in (la_k, la_r):
        np.testing.assert_allclose(la.numpy(), np.asarray(want), atol=tol)
    for want in (an_k, an_r):
        _assert_angles_close(an.numpy(), want, tol)


def _logcf_case_ten_times():
    """test_logcf_plain_matches_pallas[100-129], its torch side 10 times
    (the JAX sides are computed once)."""
    p, v, _ = _cf_inputs(np.random.default_rng(0), 100)
    want = [jcf.logcf(jnp.asarray(p), jnp.asarray(v), num_freq=129,
                      interpret=True),
            jref.logcf_ref(jnp.asarray(p), jnp.asarray(v, jnp.float32), 129)]
    for _ in range(10):
        la, an = pb_cf.logcf(torch.from_numpy(p), torch.from_numpy(v),
                             num_freq=129)
        for la_w, an_w in want:
            np.testing.assert_allclose(la.numpy(), np.asarray(la_w),
                                       atol=5e-4)
            _assert_angles_close(an.numpy(), an_w, 5e-4)


def test_logcf_plain_in_the_order_that_failed():
    """The [100-129] case above failed now and then (1 run in 2 here)
    when it ran right after test_torch_polymul, test_torch_cuda and
    test_torch_imports in one process: the first multi-threaded
    ``torch.cos`` of the process came back with relative errors up to
    1.5e-4 on one intra-op thread's share.  Importing the port now runs
    each vectorised math function once on one thread
    (``core.config.settle_cpu_math``).  Only a process's first call can
    fail, so six fresh processes side by side each run those three files,
    then the case's torch side 10 times; two intra-op threads each are
    enough for the failure (1 process in 6 to 1 in 4 without the warm-up)
    and keep them from crowding the cores."""
    import os
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    script = (
        "import sys, numpy as np, pytest\n"
        "assert pytest.main(['-q', '-p', 'no:randomly', '-p',"
        " 'no:cacheprovider', '-p', 'no:xdist', 'tests/test_torch_polymul.py',"
        " 'tests/test_torch_cuda.py', 'tests/test_torch_imports.py']) == 0\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_kernels as k\n"
        "k._logcf_case_ten_times()\n"
        "print('TEN PASSED')\n")
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=root,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "TEN PASSED" in out, out[-3000:]


def test_logcf_plain_large_values(rng):
    """k*a far beyond int32 exactness: the float64 phase must hold."""
    n, num_freq = 500, 1 << 14
    p = rng.uniform(0.01, 0.99, n).astype(np.float32)
    v = rng.integers(0, num_freq, n).astype(np.int32)
    la_k, _ = jcf.logcf(jnp.asarray(p), jnp.asarray(v), num_freq=num_freq,
                        interpret=True)
    la, _ = pb_cf.logcf(torch.from_numpy(p), torch.from_numpy(v),
                        num_freq=num_freq)
    np.testing.assert_allclose(la.numpy(), np.asarray(la_k), atol=2e-3)


@pytest.mark.parametrize("n,num_groups,num_freq,lo,cnt", [
    (300, 5, 129, 0, None), (513, 9, 64, 0, None), (700, 12, 320, 128, 128),
])
def test_group_logcf_plain_matches_pallas(rng, n, num_groups, num_freq, lo,
                                          cnt):
    p, v, g = _cf_inputs(rng, n, num_groups)
    la_k, an_k = jgcf.group_logcf(jnp.asarray(p), jnp.asarray(v),
                                  jnp.asarray(g), num_groups=num_groups,
                                  num_freq=num_freq, freq_lo=lo,
                                  freq_cnt=cnt, interpret=True)
    la_r, an_r = jref.group_logcf_ref(jnp.asarray(p), jnp.asarray(v),
                                      jnp.asarray(g), num_groups, num_freq,
                                      lo, cnt)
    tp, tv, tg = map(torch.from_numpy, (p, v, g))
    la, an = group_cf.group_logcf(tp, tv, tg, num_groups=num_groups,
                                  num_freq=num_freq, freq_lo=lo,
                                  freq_cnt=cnt)
    # the presorted-operand route gives the same answer
    ops_ = group_cf.presort_operands(tp, tv, tg, num_freq, num_groups)
    la_o, an_o = group_cf.group_logcf(tp, tv, tg, num_groups=num_groups,
                                      num_freq=num_freq, freq_lo=lo,
                                      freq_cnt=cnt, operands=ops_)
    tol = 5e-4 * max(1, n / 500)
    for got in (la, la_o):
        for want in (la_k, la_r):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=tol)
    for got in (an, an_o):
        for want in (an_k, an_r):
            _assert_angles_close(got.numpy(), want, 2e-3 * max(1, n / 500))


@pytest.mark.parametrize("n,orders", [(1000, 4), (3000, 8)])
def test_cumulants_plain_matches_pallas(rng, n, orders):
    p = rng.uniform(0.01, 0.99, n).astype(np.float32)
    v = rng.uniform(0, 5, n).astype(np.float32)
    sk = jcum.cumulant_sums(jnp.asarray(p), jnp.asarray(v), orders=orders,
                            interpret=True)
    sr = jref.cumulants_ref(jnp.asarray(p), jnp.asarray(v), orders)
    got = cumulants.cumulant_sums(torch.from_numpy(p), torch.from_numpy(v),
                                  orders=orders)
    for want in (sk, sr):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("n,num_groups,orders", [(300, 5, 8), (1500, 200, 4),
                                                 (1024, 16, 12)])
def test_group_cumulants_plain_matches_pallas(rng, n, num_groups, orders):
    p = rng.uniform(0.01, 0.99, n).astype(np.float32)
    v = rng.uniform(0, 5, n).astype(np.float32)
    g = rng.integers(0, num_groups, n).astype(np.int32)
    sk = jgcum.group_cumulant_sums(jnp.asarray(p), jnp.asarray(v),
                                   jnp.asarray(g), num_groups=num_groups,
                                   orders=orders, interpret=True)
    sr = jref.group_cumulants_ref(jnp.asarray(p), jnp.asarray(v),
                                  jnp.asarray(g), num_groups, orders)
    tp, tv, tg = map(torch.from_numpy, (p, v, g))
    got = group_cumulants.group_cumulant_sums(tp, tv, tg,
                                              num_groups=num_groups,
                                              orders=orders)
    got_o = group_cumulants.group_cumulant_sums(
        tp, tv, tg, num_groups=num_groups, orders=orders,
        operands=group_cumulants.presort_operands(tp, tv, tg))
    assert got.shape == (num_groups, orders)
    for out in (got, got_o):
        for want in (sk, sr):
            _assert_scale_aware_close(out.numpy(), want, p, v, g,
                                      num_groups, orders)


@pytest.mark.parametrize("num_freq", [1, 2, 257, 4096, 1 << 20])
def test_split_modmult_operands_match_jax(rng, num_freq):
    v = rng.integers(-3 * num_freq, 3 * num_freq, 400)
    a, a2, shift = pb_cf.split_modmult_operands(torch.from_numpy(v),
                                                num_freq)
    ja, ja2, jshift = jcf.split_modmult_operands(jnp.asarray(v), num_freq)
    assert shift == jshift == pb_cf.phase_shift(num_freq)
    assert a.dtype == a2.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(a2.numpy(), np.asarray(ja2))
    with pytest.raises(ValueError, match="2\\^20"):
        pb_cf.split_modmult_operands(torch.from_numpy(v), (1 << 20) + 1)


@pytest.mark.parametrize("sizes,max_len,short_max", [
    ([0, 5, 0, 2048, 1, 1025, 0], 1024, 0), ([3, 3, 3], 2, 0),
    ([0, 0], 4, 0),
    # the grouped CF kernel's split: short groups get no piece
    ([0, 1, 5000, 32, 33, 0, 4, 1, 2049, 0], 1024, 32),
    ([1, 2, 3, 4, 5], 2, 3), ([7, 0, 7], 3, 7),
])
def test_pieces_cover_each_group_in_order(sizes, max_len, short_max):
    """Every sorted tuple is covered exactly once, in group order: by the
    group's pieces when it has more than ``short_max`` tuples, else by its
    bounds alone (the direct path of csrc/group_logcf.cu)."""
    g = torch.from_numpy(np.repeat(np.arange(len(sizes)), sizes)
                         .astype(np.int32))
    bounds = segments.group_bounds(g, len(sizes))
    start, end, first = segments.pieces(bounds, max_len, short_max)
    assert start.dtype == end.dtype == first.dtype == torch.int32
    assert first[0] == 0 and first[-1] == start.shape[0]
    assert torch.equal(bounds, torch.from_numpy(
        np.concatenate([[0], np.cumsum(sizes)])).to(bounds.dtype))
    covered_all = []
    for gi, size in enumerate(sizes):
        own = range(int(first[gi]), int(first[gi + 1]))
        lo = sum(sizes[:gi])
        if size <= short_max:
            assert len(own) == 0
            covered = list(range(int(bounds[gi]), int(bounds[gi + 1])))
        else:
            assert len(own) == -(-size // max_len)
            assert all(int(end[r]) - int(start[r]) <= max_len for r in own)
            covered = [i for r in own for i in range(int(start[r]),
                                                     int(end[r]))]
        assert covered == list(range(lo, lo + size))
        covered_all += covered
    assert covered_all == list(range(sum(sizes)))


def _source(name):
    return (pathlib.Path(segments.__file__).parent / "csrc" / name
            ).read_text()


def _constants(text):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("sizes", [
    [0, 5, 0, 2048, 1, 1025, 0],                   # empty groups
    [0, 0, 100_000, 0],                            # one huge group
    [1, 32, 5, 0, 32, 17, 3] * 20,                 # all <= SHORT_MAX
    [5000],                                        # G = 1
    [33] * 300,                                    # every group one slot
    [33, 34, 1024, 1025, 1056, 2048, 2049, 32, 33, 0, 67],
    "random",
])
def test_slot_pieces_match_pieces(sizes):
    """The sync-free piece table of route (b) (csrc/group_cumulants.cu,
    written in PyTorch as segments.slot_pieces): n // SLOT slots sized
    from n alone; listed in slot order its live slots are exactly the
    counted table segments.pieces, and a long group's pieces sit in the
    slots [first // SLOT, first // SLOT + pieces), in order -- what the
    direct pass folds."""
    if sizes == "random":
        r = np.random.default_rng(3)
        sizes = r.choice([0, 1, 4, 32, 33, 34, 100, 1023, 1024, 1025, 5000],
                         400).tolist()
    short, piece, slot = (group_cumulants.SHORT_MAX, group_cumulants.PIECE,
                          group_cumulants.SLOT)
    g = torch.from_numpy(np.repeat(np.arange(len(sizes)), sizes))
    n = g.shape[0]
    bounds = segments.group_bounds(g, len(sizes))
    start, end = segments.slot_pieces(g, bounds, piece, short)
    assert start.shape[0] == group_cumulants.slot_count(n) == n // slot
    live = end > start
    p_start, p_end, p_first = segments.pieces(bounds, piece, short)
    assert torch.equal(start[live], p_start.long())
    assert torch.equal(end[live], p_end.long())
    assert not start[~live].any() and not end[~live].any()
    for gi in range(len(sizes)):
        k = int(p_first[gi + 1] - p_first[gi])
        s0 = int(bounds[gi]) // slot
        for j in range(k):
            r = int(p_first[gi]) + j
            assert int(start[s0 + j]) == int(p_start[r])
            assert int(end[s0 + j]) == int(p_end[r])


def test_cumulant_launch_split_depends_on_n_only(monkeypatch):
    """Tiles of route (a) and the scalar kernel, and slots of route (b),
    come from n alone (never from the card: asking for its properties
    here raises); the tiles cover [0, n) once; the route comes from
    num_groups alone; the sources' constants are the wrappers' and neither
    cumulant source uses atomics."""
    def no_card(*_, **__):
        raise AssertionError("the launch split asked for the card")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    tile = cumulants.TILE
    for n in (0, 1, tile - 1, tile, tile + 1, 750_000, 10 ** 8):
        t = cumulants.tile_count(n)
        assert t == -(-n // tile)
        assert t * tile >= n and (t - 1) * tile < max(n, 1)
        assert group_cumulants.slot_count(n) == n // group_cumulants.SLOT
    c = _constants(_source("cumulants.cu"))
    assert c["kThreads"] * c["kVec"] * c["kRuns"] == tile
    assert c["kMaxTileGroups"] == group_cumulants.NO_SORT_MAX
    c = _constants(_source("group_cumulants.cu"))
    assert c["kShortMax"] == group_cumulants.SHORT_MAX
    assert c["kPiece"] == group_cumulants.PIECE
    for name in ("cumulants.cu", "group_cumulants.cu", "common.cuh"):
        assert not re.search(r"\batomic\w*\s*\(", _source(name))


def test_cumulant_table_in_source():
    """The kernels' __constant__ coefficient table (csrc/common.cuh) is the
    plain versions' float32 table, bit for bit."""
    text = _source("common.cuh")
    body = text[text.index("cumulant table begin"):
                text.index("cumulant table end")]
    body = body[body.index("= {"):]
    got = np.array([float(x) for x in re.findall(r"(-?\d+)\.f", body)],
                   np.float32).reshape(12, 13)
    from repro_torch.core.approx import _bernoulli_cumulant_polys as polys
    want = np.asarray(polys()[1:], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_presort_operands_group_tables(rng):
    """presort_operands returns the sorted columns with the group bounds
    and the long-group piece table, and the CPU route of group_logcf
    takes them."""
    sizes = [0, 3, group_cf.SHORT_MAX + 1, 0, 1, 2500]
    gids = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(gids)
    n, G = gids.shape[0], len(sizes)
    p = torch.from_numpy(rng.uniform(0.01, 0.99, n).astype(np.float32))
    v = torch.from_numpy(rng.integers(0, 300, n))
    g = torch.from_numpy(gids)
    ops_ = group_cf.presort_operands(p, v, g, 257, G)
    ps, a, a2, gs, bounds, first, start, end = ops_
    assert torch.equal(gs, torch.sort(g.to(torch.int32)).values)
    assert torch.equal(bounds, torch.tensor(
        np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32))
    assert first.tolist() == [0, 0, 0, 1, 1, 1, 4]
    assert start.tolist() == [3, 37, 1061, 2085]
    assert end.tolist() == [36, 1061, 2085, 2537]
    want = group_cf.group_logcf_plain(p, v, g, G, 257, 40, 60)
    got = group_cf.group_logcf(p, v, g, num_groups=G, num_freq=257,
                               freq_lo=40, freq_cnt=60, operands=ops_)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=2e-3, rtol=0)


@pytest.mark.parametrize("num_freq", [1, 2, 3, 257, 1001, 4096])
def test_logcf_plain_conjugate_symmetry(rng, num_freq):
    """The identity the logcf kernel relies on to compute k <= N/2 only:
    for real p, log_abs[N - k] = log_abs[k] and angle[N - k] = -angle[k]
    (mod 2 pi), with values up to N - 1, on every frequency computed
    directly (the plain version mirrors as the kernel does)."""
    n = 64
    p = torch.from_numpy(rng.uniform(0.01, 0.99, n).astype(np.float32))
    v = torch.from_numpy(np.concatenate([[num_freq - 1], rng.integers(
        0, num_freq, n - 1)]))
    la, an = ref.logcf_ref(p, v, num_freq)
    k = np.arange(1, num_freq)
    mirror = num_freq - k
    np.testing.assert_allclose(la.numpy()[mirror], la.numpy()[k], rtol=0,
                               atol=1e-5)
    _assert_angles_close(an.numpy()[mirror], -an.numpy()[k], 1e-5)


def _barrett(x, num_freq):
    """The kernels' phase reduction (csrc/cf.cuh reduce_phase) in uint64:
    x - umulhi(x, magic) * N in 32-bit arithmetic, then one unsigned min."""
    x, n = np.asarray(x, np.uint64), np.uint64(num_freq)
    m32 = np.uint64(0xFFFFFFFF)
    magic = np.uint64(pb_cf.barrett_magic(num_freq))
    r = (x - ((x * magic) >> np.uint64(32)) * n) & m32
    return np.minimum(r, (r - n) & m32)


@pytest.mark.parametrize("num_freq", [1, 2, 3, 401, 1001, 4096, 4097,
                                      (1 << 20) - 1, 1 << 20])
def test_phase_reduction_is_exact(rng, num_freq):
    """The kernels' phase: the host's a2 = (a << S) mod N, k_hi * a2 +
    k_lo * a stays below 2^32, and one Barrett step gives exactly
    (k * a) mod N, for k and a up to N - 1."""
    n = num_freq
    shift = pb_cf.phase_shift(n)
    assert pb_cf.barrett_magic(n) < 1 << 32
    edge = np.arange(min(n, 40))
    k = np.concatenate([edge, n - 1 - edge, rng.integers(0, n, 300)])
    a = np.concatenate([edge, n - 1 - edge, rng.integers(0, n, 300)])
    kk, aa = (x.astype(np.uint64) for x in np.meshgrid(k, a))
    _, t_a2, _ = pb_cf.split_modmult_operands(torch.from_numpy(a), n)
    a2 = np.broadcast_to(t_a2.numpy().astype(np.uint64)[:, None], aa.shape)
    assert np.array_equal(a2, (aa << np.uint64(shift)) % np.uint64(n))
    x = ((kk >> np.uint64(shift)) * a2
         + (kk & np.uint64((1 << shift) - 1)) * aa)
    assert int(x.max()) < 1 << 32
    assert np.array_equal(_barrett(x, n), (kk * aa) % np.uint64(n))


def test_dispatch_guards():
    """Eligibility comes from the guards alone: size, float32, frequency
    grid and integer values; on a CPU tensor every wrapper then computes
    its plain version and counts no launch."""
    big = torch.rand(ops.MIN_KERNEL_TUPLES)
    small = big[:-1]
    assert ops.cumulant_eligible(big)
    assert not ops.cumulant_eligible(small)
    assert not ops.cumulant_eligible(big.double())
    assert ops.cf_eligible(big, ops.MAX_KERNEL_FREQ, True)
    assert not ops.cf_eligible(big, ops.MAX_KERNEL_FREQ + 1, True)
    assert not ops.cf_eligible(big, 64, False)
    ops.reset_launches()
    v = torch.ones(big.shape[0], dtype=torch.int64)
    g = torch.zeros_like(v)
    la, _ = pb_cf.logcf(big, v, num_freq=64)
    torch.testing.assert_close(la, ref.logcf_ref(big, v, 64)[0])
    la, _ = group_cf.group_logcf(big, v, g, num_groups=2, num_freq=64)
    torch.testing.assert_close(la, ref.group_logcf_ref(big, v, g, 2, 64)[0])
    torch.testing.assert_close(
        cumulants.cumulant_sums(big, v.float(), orders=3),
        ref.cumulants_ref(big, v.float(), 3))
    torch.testing.assert_close(
        group_cumulants.group_cumulant_sums(big, v.float(), g, num_groups=2,
                                            orders=3),
        ref.group_cumulants_ref(big, v.float(), g, 2, 3))
    assert all(n == 0 for n in ops.launches().values())


@pytest.mark.parametrize("na,nb", [(128, 128), (130, 257), (300, 200)])
def test_polymul_plain_matches_pallas(rng, na, nb):
    """float32, the bounds of tests/test_kernels.py: rtol=1e-5, atol=1e-4."""
    a = rng.uniform(0, 1, na).astype(np.float32)
    b = rng.uniform(0, 1, nb).astype(np.float32)
    ck = jpm.polymul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    cr = jref.polymul_ref(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got in (polymul.polymul(ta, tb), polymul.polymul_plain(ta, tb),
                polymul.polymul_plain(tb, ta)):
        assert got.dtype == torch.float32 and got.shape == (na + nb - 1,)
        for want in (ck, cr):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("na,nb,dtype,eligible", [
    (128, 128, torch.float32, True), (1024, 128, torch.float32, True),
    (127, 1024, torch.float32, False), (128, 128, torch.float64, False),
    (128, 128, None, False)])
def test_polymul_eligible_guard(na, nb, dtype, eligible):
    """Float32 factors of at least MIN_KERNEL_DEGREE coefficients (the JAX
    guard of ops.py:79-80); a float64 second factor is not eligible."""
    a = torch.rand(na, dtype=dtype or torch.float32)
    b = torch.rand(nb, dtype=dtype or torch.float64)
    assert ops.MIN_KERNEL_DEGREE == 128
    assert ops.polymul_eligible(a, b) is eligible
    assert ops.polymul_eligible(b, a) is eligible
