"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes (the SF1 shapes are ``chip_smoke.py``'s).  Needs an
NVIDIA card and no JAX; on the card run

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Elsewhere the test skips (decided inside its fixture)."""
import numpy as np
import pytest
import torch

from repro_torch.core.approx import _bernoulli_cumulant_polys
from repro_torch.kernels import (cumulants, group_cf, group_cumulants, ops,
                                 pb_cf, polymul, ref)


@pytest.fixture
def cuda_device():
    """The card, decided inside the test: skip on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _abs_scale(p, v, g, num_groups, orders=8):
    """Per-group sum_i sum_d |c_jd| p_i^d |v_i|^j, at least 1."""
    table = np.abs(_bernoulli_cumulant_polys()[1:orders + 1, :orders + 1])
    table = torch.as_tensor(table, dtype=torch.float64, device=p.device)
    powers = p.double()[None, :] ** torch.arange(
        orders + 1, dtype=torch.float64, device=p.device)[:, None]
    vpow = v.double().abs()[None, :] ** torch.arange(
        1, orders + 1, dtype=torch.float64, device=p.device)[:, None]
    rows = ((table @ powers) * vpow).T
    if g is None:
        g = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    out = torch.zeros((num_groups, orders), dtype=torch.float64,
                      device=p.device).index_add_(0, g, rows)
    return out.clamp(min=1).float()


def _angle_err(got, want):
    d = got.double().cpu() - want.double().cpu()
    return float((torch.remainder(d + torch.pi, 2 * torch.pi)
                  - torch.pi).abs().max())


def _bits(t):
    return t.contiguous().view(torch.int32)


def _cf_rel_err(la, an, p, v, k, num_freq, gids=None, num_groups=1):
    """Max error of (la, an) at frequencies ``k`` against the plain terms
    summed in float64 (per group when ``gids`` is given), over the sum of
    |term| (at least 1): chip_smoke.py's measure, tolerance 2e-5."""
    tl, ta = ref._cf_terms(p[:, None], v[:, None], k[None, :], num_freq)
    tl, ta = tl.double(), ta.double()
    if gids is None:
        gids = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    err = 0.0
    for got, t in ((la, tl), (an, ta)):
        want = ref.segment_sum(t, gids, num_groups)
        scale = ref.segment_sum(t.abs(), gids, num_groups).clamp(min=1)
        d = got.double().reshape(want.shape) - want
        if t is ta:
            d = torch.remainder(d + torch.pi, 2 * torch.pi) - torch.pi
        err = max(err, float((d.abs() / scale).max()))
    return err


@pytest.mark.cuda
def test_cuda_logcf_shapes(cuda_device):
    """logcf computes k <= N/2 and mirrors the rest: N = 1 and 2, the odd
    N of the value layer (401, 1001), Q6's 4096 and the device-memory
    twiddle table at 2^20, at n from 1 to 5000 with values up to N - 1 and
    some p = 0 tuples.  Frequencies k <= N/2 within 2e-5 of sum|term| of
    the float64 plain sums (at N = 2^20 those next to 0 and N/2), the
    others their exact mirrors (log_abs[N-k] = log_abs[k], angle[N-k] =
    -angle[k]); bit-equal on a rerun, one launch counted per call."""
    rng = np.random.default_rng(7)
    pb_cf.logcf.launches = 0
    calls = 0
    for num_freq in (1, 2, 401, 1001, 4096, 1 << 20):
        for n in (1, 255, 1024, 5000):
            pr = rng.uniform(0.01, 0.99, n)
            pr[::7] = 0.0
            p = torch.tensor(pr, dtype=torch.float32, device=cuda_device)
            v = torch.tensor(np.concatenate([[num_freq - 1], rng.integers(
                0, num_freq, n - 1)]), device=cuda_device)
            la, an = pb_cf.logcf(p, v, num_freq=num_freq)
            la2, an2 = pb_cf.logcf(p, v, num_freq=num_freq)
            calls += 2
            assert torch.equal(_bits(la), _bits(la2))
            assert torch.equal(_bits(an), _bits(an2))
            half = num_freq // 2 + 1
            if num_freq * n <= 1 << 23:
                k = torch.arange(half, device=cuda_device)
            else:
                k = torch.cat([torch.arange(64), torch.arange(half - 64,
                                                              half)]
                              ).to(cuda_device)
            err = _cf_rel_err(la[k], an[k], p, v, k.double(), num_freq)
            assert err <= 2e-5, (num_freq, n, err)
            mk = torch.arange(half, num_freq, device=cuda_device)
            assert torch.equal(la[mk], la[num_freq - mk])
            assert torch.equal(an[mk], -an[num_freq - mk])
    assert pb_cf.logcf.launches == calls


@pytest.mark.cuda
def test_cuda_group_logcf_skew(cuda_device):
    """group_logcf over skewed groups -- empty, 1-tuple, short_max and
    short_max + 1, a 5,000-tuple group cut into pieces -- at windows that
    start at 0, end at N - 1, or are narrower than a warp; within 2e-5 of
    sum|term| per group, bit-equal on a rerun and through presorted
    operands, one launch counted per call."""
    rng = np.random.default_rng(8)
    short = group_cf.SHORT_MAX
    sizes = [0, 1, 5000, 0, short, short + 1, 1, 4, 2 * group_cf.PIECE + 3,
             0, 3]
    gids = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(gids)
    n, G = gids.shape[0], len(sizes) + 2        # two trailing empty groups
    pr = rng.uniform(0.01, 0.99, n)
    pr[::11] = 0.0
    p = torch.tensor(pr, dtype=torch.float32, device=cuda_device)
    g = torch.tensor(gids, device=cuda_device)
    group_cf.group_logcf.launches = 0
    calls = 0
    for num_freq, lo, cnt in ((256, 0, 256), (256, 166, 90), (1001, 994, 7),
                              (1 << 20, (1 << 20) - 40, 40)):
        v = torch.tensor(rng.integers(0, num_freq, n), device=cuda_device)
        run = lambda **kw: group_cf.group_logcf(
            p, v, g, num_groups=G, num_freq=num_freq, freq_lo=lo,
            freq_cnt=cnt, **kw)
        la, an = run()
        ops_ = group_cf.presort_operands(p, v, g, num_freq, G)
        for la2, an2 in (run(), run(operands=ops_)):
            assert torch.equal(_bits(la), _bits(la2))
            assert torch.equal(_bits(an), _bits(an2))
        calls += 3
        k = lo + torch.arange(cnt, dtype=torch.float64, device=cuda_device)
        err = _cf_rel_err(la, an, p, v, k, num_freq, g, G)
        assert err <= 2e-5, (num_freq, lo, cnt, err)
        empty = torch.tensor([i for i in range(G)
                              if i >= len(sizes) or sizes[i] == 0],
                             device=cuda_device)
        assert not la[empty].any() and not an[empty].any()
    assert group_cf.group_logcf.launches == calls


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """Each CUDA kernel against its plain version on the card, including
    the phase at N = 2^20 with values up to N - 1."""
    rng = np.random.default_rng(5)
    dev = cuda_device
    n = 5000
    p = torch.tensor(rng.uniform(0.01, 0.99, n), dtype=torch.float32,
                     device=dev)
    v = torch.tensor(rng.integers(0, 50, n), device=dev)
    g = torch.tensor(rng.integers(0, 37, n), device=dev)
    for num_freq in (257, 1 << 20):
        vv = v if num_freq < 1 << 20 else torch.tensor(
            rng.integers(num_freq - 64, num_freq, n), device=dev)
        got = pb_cf.logcf(p[:300], vv[:300], num_freq=num_freq)
        want = pb_cf.logcf_plain(p[:300], vv[:300], num_freq)
        torch.testing.assert_close(got[0], want[0], atol=2e-3, rtol=0)
        assert _angle_err(got[1], want[1]) < 2e-3
    # windows of the k <= N/2 columns (a model rank's share): the whole
    # launch's bits, mirrored back; and against the plain window
    # (the plain comparison on 300 tuples, as above)
    for m, num_freq in ((n, 257), (n, 256), (300, 257)):
        whole = pb_cf.logcf(p[:m], v[:m], num_freq=num_freq)
        half = num_freq // 2 + 1
        parts = [pb_cf.logcf(p[:m], v[:m], num_freq=num_freq, freq_lo=lo,
                             freq_cnt=c)
                 for lo, c in ((0, 50), (50, half - 50))]
        got = pb_cf.mirror(torch.cat([x[0] for x in parts]),
                           torch.cat([x[1] for x in parts]), num_freq)
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    want = pb_cf.logcf_plain(p[:m], v[:m], num_freq, 50, half - 50)
    torch.testing.assert_close(parts[1][0], want[0], atol=2e-3, rtol=0)
    assert _angle_err(parts[1][1], want[1]) < 2e-3
    got = group_cf.group_logcf(p, v, g, num_groups=40, num_freq=256,
                               freq_lo=100, freq_cnt=90)
    want = group_cf.group_logcf_plain(p, v, g, 40, 256, 100, 90)
    torch.testing.assert_close(got[0], want[0], atol=1e-2, rtol=0)
    assert _angle_err(got[1], want[1]) < 1e-2
    # Cumulant sums are conditioning-limited in float32: bound the error by
    # the absolute-coefficient scale sum_d |c_jd| p^d |v|^j (per group).
    vf = v.float()
    got = cumulants.cumulant_sums(p, vf, orders=8)
    want = cumulants.cumulant_sums_plain(p, vf, 8)
    assert ((got - want).abs() / _abs_scale(p, vf, None, 1)[0]).max() < 1e-5
    got = group_cumulants.group_cumulant_sums(p, vf, g, num_groups=40)
    want = group_cumulants.group_cumulant_sums_plain(p, vf, g, 40)
    assert ((got - want).abs() / _abs_scale(p, vf, g, 40)).max() < 1e-5


@pytest.mark.cuda
def test_cuda_polymul_matches_plain(cuda_device):
    """The polynomial-product kernel against its plain version in float64
    on the card, relative to the per-output scale sum_u |a_u||b_{t-u}|
    (float32 accumulation over at most 3000 terms: ~1e-6), bit-equal on a
    rerun, and its launches counted (one per call).  The shapes include
    those at a tile or slice boundary of ``polymul.tiling`` and one past
    either side (tests/test_torch_polymul.py), and one of the two-launch
    route (8192 x 16,385)."""
    rng = np.random.default_rng(6)
    polymul.polymul.launches = 0
    shapes = [(1, 1), (128, 1024), (1024, 128), (1001, 1001), (3000, 257),
              (128, 256), (128, 257), (128, 258), (31, 1000), (32, 1000),
              (33, 1000), (959, 959), (960, 960), (961, 961), (2048, 2560),
              (2048, 2561), (2048, 2562), (8192, 16_385)]
    for na, nb in shapes:
        a = torch.tensor(rng.uniform(-1, 1, na), dtype=torch.float32,
                         device=cuda_device)
        b = torch.tensor(rng.uniform(0, 1, nb), dtype=torch.float32,
                         device=cuda_device)
        got = polymul.polymul(a, b)
        assert torch.equal(got.view(torch.int32),
                           polymul.polymul(a, b).view(torch.int32))
        want = polymul.polymul_plain(a.double(), b.double())
        scale = polymul.polymul_plain(a.double().abs(), b.double())
        assert float(((got.double() - want).abs()
                      / scale.clamp(min=1e-30)).max()) < 2e-5
    assert polymul.polymul.launches == 2 * len(shapes)
    with pytest.raises(ValueError):
        polymul.polymul(a.double(), b.double())


@pytest.mark.cuda
def test_cuda_polymul_several_chunks_per_slice(cuda_device):
    """The kernel's double-buffered walk over several chunks of a slice,
    which ``tiling`` picks only for the largest products, forced at a small
    shape through the C entry (slices of three 16-value chunks), on both
    routes (the fold kernel; clusters of 16), against the plain version in
    float64, the two routes bit-equal; a partition the entry does not take
    is refused."""
    from repro_torch.kernels import build
    rng = np.random.default_rng(7)
    na, nb = 200, 300
    a = torch.tensor(rng.uniform(-1, 1, na), dtype=torch.float32,
                     device=cuda_device)
    b = torch.tensor(rng.uniform(0, 1, nb), dtype=torch.float32,
                     device=cuda_device)
    partial = torch.empty(5 * 768, dtype=torch.float32, device=cuda_device)
    c = torch.empty(na + nb - 1, dtype=torch.float32, device=cuda_device)
    stream = build.stream_handle(cuda_device)
    want = polymul.polymul_plain(a.double(), b.double())
    scale = polymul.polymul_plain(a.double().abs(), b.double())
    got = []
    for cluster in (0, 16):
        build.launch("polymul_launch", a.data_ptr(), b.data_ptr(),
                     partial.data_ptr(), c.data_ptr(), na, nb, 32, 48, 16,
                     cluster, stream)
        assert float(((c.double() - want).abs() / scale).max()) < 2e-5
        got.append(c.clone())
    assert torch.equal(got[0].view(torch.int32), got[1].view(torch.int32))
    for slice_, cluster in ((40, 0), (48, 8), (48, 1)):
        with pytest.raises(RuntimeError):
            build.launch("polymul_launch", a.data_ptr(), b.data_ptr(),
                         partial.data_ptr(), c.data_ptr(), na, nb, 32,
                         slice_, 16, cluster, stream)


def _cumulant_rel_err(got, p, v, g, num_groups, orders):
    """Max error of cumulant sums against the plain version evaluated in
    float64 on the same inputs, over the absolute-coefficient scale
    (chip_smoke.py's measure, tolerance 1e-5), with NaN required exactly
    where the float32 plain version has it.  (The float32 plain version is
    no witness for large groups: its index_add_ adds a group's terms by
    float32 atomics, whose error at 10^5 tuples nears the tolerance.)"""
    def plain(pp, vv):
        if g is None:
            return cumulants.cumulant_sums_plain(pp, vv, orders)[None]
        return group_cumulants.group_cumulant_sums_plain(pp, vv, g,
                                                         num_groups, orders)
    nan = torch.isnan(plain(p, v))
    got = got.reshape(nan.shape)
    assert torch.equal(torch.isnan(got), nan)
    want = plain(p.double(), v.double())
    scale = _abs_scale(p, v, g, num_groups, orders).double()
    d = (got.double() - want).abs() / scale
    return float(d[~nan].max()) if (~nan).any() else 0.0


def _skewed_gids(rng, sizes, device):
    gids = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(gids)
    return torch.tensor(gids, device=device)


@pytest.mark.cuda
def test_cuda_cumulant_routes(cuda_device):
    """Both cumulant kernels against their plain versions at every order
    class: the scalar kernel and route (a) (G <= NO_SORT_MAX, no sort) on
    full, ragged and misaligned tiles; route (b) (sorted) from G =
    NO_SORT_MAX + 1 up; each bit-equal on a rerun (route (b) also through
    presorted operands), and one launch counted per call."""
    rng = np.random.default_rng(9)
    dev = cuda_device
    cumulants.cumulant_sums.launches = 0
    group_cumulants.group_cumulant_sums.launches = 0
    calls = gcalls = 0
    tile = cumulants.TILE
    for n in (1, 255, tile, tile + 1, 5 * tile - 3, 100_003):
        pr = rng.uniform(0.0, 1.0, n + 1)
        pr[::5] = 0.0
        p_all = torch.tensor(pr, dtype=torch.float32, device=dev)
        v_all = torch.tensor(rng.integers(0, 60, n + 1), dtype=torch.float32,
                             device=dev)
        for p, v in ((p_all[:n], v_all[:n]), (p_all[1:], v_all[1:])):
            for orders in (1, 3, 6, 8, 12):
                got = cumulants.cumulant_sums(p, v, orders=orders)
                assert torch.equal(_bits(got), _bits(cumulants.cumulant_sums(
                    p, v, orders=orders)))
                calls += 2
                err = _cumulant_rel_err(got, p, v, None, 1, orders)
                assert err <= 1e-5, (n, orders, err)
        p, v = p_all[:n], v_all[:n]
        for G in (1, 2, group_cumulants.NO_SORT_MAX,
                  group_cumulants.NO_SORT_MAX + 1, 40, 5000):
            g = torch.tensor(rng.integers(0, G, n), device=dev)
            for orders in (3, 8, 12):
                run = lambda **kw: group_cumulants.group_cumulant_sums(
                    p, v, g, num_groups=G, orders=orders, **kw)
                got = run()
                assert torch.equal(_bits(got), _bits(run()))
                err = _cumulant_rel_err(got, p, v, g, G, orders)
                assert err <= 1e-5, (n, G, orders, err)
                # presorted operands: route (b) sums them in the same
                # order; route (a) sums in the order it is given
                ops_ = group_cumulants.presort_operands(p, v, g)
                got_o = run(operands=ops_)
                if G > group_cumulants.NO_SORT_MAX:
                    assert torch.equal(_bits(got), _bits(got_o))
                err = _cumulant_rel_err(got_o, p, v, g, G, orders)
                assert err <= 1e-5, (n, G, orders, err)
                gcalls += 3
    assert cumulants.cumulant_sums.launches == calls
    assert group_cumulants.group_cumulant_sums.launches == gcalls


@pytest.mark.cuda
def test_cuda_group_cumulants_skew(cuda_device):
    """Route (b) over skewed groups -- empty, 1-tuple, SHORT_MAX and
    SHORT_MAX + 1, a 5,000-tuple group cut into pieces, 2 * PIECE + 3, a run
    of groups of exactly SLOT tuples -- and route (a) at G = NO_SORT_MAX with
    empty groups: within 1e-5 of the scale, empty rows exactly zero,
    bit-equal on a rerun."""
    rng = np.random.default_rng(10)
    dev = cuda_device
    short, piece = group_cumulants.SHORT_MAX, group_cumulants.PIECE
    cases = ([0, 1, 5000, 0, short, short + 1, 1, 4, 2 * piece + 3, 0, 3]
             + [group_cumulants.SLOT] * 40 + [0, 0],
             [short + 1] * 200, [0] * 50 + [70_000] + [0] * 20,
             [3, 0, 0, 9000, 0, 1, 0, 0])
    for sizes in cases:
        G = len(sizes)
        g = _skewed_gids(rng, sizes, dev)
        n = g.shape[0]
        pr = rng.uniform(0.0, 1.0, n)
        pr[::3] = 0.0
        p = torch.tensor(pr, dtype=torch.float32, device=dev)
        v = torch.tensor(rng.integers(1, 40, n), dtype=torch.float32,
                         device=dev)
        got = group_cumulants.group_cumulant_sums(p, v, g, num_groups=G)
        assert torch.equal(_bits(got), _bits(
            group_cumulants.group_cumulant_sums(p, v, g, num_groups=G)))
        err = _cumulant_rel_err(got, p, v, g, G, 8)
        assert err <= 1e-5, (sizes[:12], err)
        empty = torch.tensor([i for i, s in enumerate(sizes) if s == 0],
                             dtype=torch.int64, device=dev)
        assert torch.equal(_bits(got[empty]),
                           torch.zeros_like(_bits(got[empty])))


@pytest.mark.cuda
def test_cuda_cumulants_nan(cuda_device):
    """p = 0 tuples are not dropped: kappa_j(0) = 0, but 0 * v^j is NaN
    where v^j overflows float32 (v = 1e5 at orders 8), and the kernels give
    NaN exactly where the plain versions do -- in the scalar kernel, in
    route (a), and in route (b) in a short and in a long group."""
    rng = np.random.default_rng(11)
    dev = cuda_device
    n = 3000
    pr = rng.uniform(0.0, 1.0, n)
    vr = rng.integers(1, 30, n).astype(np.float64)
    pr[[7, 2500]] = 0.0
    vr[[7, 2500]] = 1e5
    p = torch.tensor(pr, dtype=torch.float32, device=dev)
    v = torch.tensor(vr, dtype=torch.float32, device=dev)
    got = cumulants.cumulant_sums(p, v, orders=8)
    assert bool(torch.isnan(got).any())
    _cumulant_rel_err(got, p, v, None, 1, 8)
    gl = np.full(n, 3)
    gl[7] = 1                       # a short group of one NaN tuple
    for G in (4, 20):               # route (a), route (b); 2500 in group 3
        g = torch.tensor(gl, device=dev)
        got = group_cumulants.group_cumulant_sums(p, v, g, num_groups=G)
        assert bool(torch.isnan(got[1]).any())
        assert bool(torch.isnan(got[3]).any())
        assert not bool(torch.isnan(got[0]).any())
        _cumulant_rel_err(got, p, v, g, G, 8)


@pytest.mark.cuda
def test_cuda_cumulants_no_host_sync(cuda_device):
    """Neither cumulant wrapper synchronises the host, on either grouped
    route, nor does polymul (its scratch comes from the caching allocator):
    run under torch.cuda.set_sync_debug_mode("error") after one warm-up
    call (which builds and loads the kernels)."""
    rng = np.random.default_rng(12)
    dev = cuda_device
    n = 50_000
    p = torch.tensor(rng.uniform(0, 1, n), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.integers(1, 50, n), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.integers(0, 3000, n), device=dev)
    g8 = g % 8
    calls = (lambda: cumulants.cumulant_sums(p, v, orders=8),
             lambda: group_cumulants.group_cumulant_sums(
                 p, v, g8, num_groups=8),
             lambda: group_cumulants.group_cumulant_sums(
                 p, v, g, num_groups=3000),
             lambda: polymul.polymul(p[:1001], v[:1001]))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


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
        yield path, x


def _assert_same_bits(ref, got):
    a, b = list(_leaves(ref)), list(_leaves(got))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, path
        if x.is_floating_point():
            bits = torch.int32 if x.dtype == torch.float32 else torch.int64
            x, y = x.view(bits), y.view(bits)
        assert torch.equal(x, y), path


def _streamed_queries(db, opts):
    """Every query in aggregate mode plus the two exact variants, with
    ``opts`` as plan_opts (None: resident)."""
    from repro_torch.db import tpch
    kw = dict(plan_opts=opts) if opts else {}
    return {
        "q1": lambda: tpch.q1(db, "aggregate", **kw),
        "q3": lambda: tpch.q3(db, "aggregate", max_groups=512, **kw),
        "q6": lambda: tpch.q6(db, "aggregate", **kw),
        "q6_exact": lambda: tpch.q6(db, "aggregate", num_freq=4096, **kw),
        "q18": lambda: tpch.q18(db, "aggregate", max_groups=2048, **kw),
        "q18_exact": lambda: tpch.q18(
            db, "aggregate", method="exact", max_groups=2048, num_freq=256,
            plan_opts=dict(opts or {}, cf_budget_elems=2 * 2048 * 100)),
        "q20": lambda: tpch.q20(db, "aggregate", max_groups=1024, **kw)}


#: lineitem (8000 rows, 1000 a chunk) streams; orders (2000) and partsupp
#: (800) stay resident; 3 chunks a wave leaves a ragged last wave.
STREAM_OPTS = dict(device_row_budget=2500, stream_wave_chunks=3)


@pytest.mark.cuda
def test_cuda_streamed_equals_resident(cuda_device):
    """Every query streamed from a pinned HostTable lineitem equals its
    resident run on the card bit for bit (the kernels run: 1000-tuple
    chunks, float32), with the double-buffered and the synchronous
    schedule, and launches each kernel as often as the resident run."""
    from repro_torch.db import tpch
    from repro_torch.db.table import HostTable
    db = tpch.generate(n_orders=2000, seed=0, device="cuda")
    host = tpch.TPCH(**dict(db.tables(),
                            lineitem=HostTable.from_table(db.lineitem)),
                     scale=db.scale)
    resident = _streamed_queries(db, None)
    for name, fn in _streamed_queries(host, STREAM_OPTS).items():
        ops.reset_launches()
        ref = resident[name]()
        want = ops.launches()
        ops.reset_launches()
        _assert_same_bits(ref, fn())
        assert ops.launches() == want, name
    sync = _streamed_queries(host, dict(STREAM_OPTS,
                                        stream_double_buffer=False))
    _assert_same_bits(resident["q1"](), sync["q1"]())


@pytest.mark.cuda
def test_cuda_streamed_rerun_after_empty_cache(cuda_device):
    """The side-stream slab copies leave no tensor in use past its event:
    with the caching allocator emptied between runs (so every block is
    allocated anew), a rerun is bit-equal."""
    from repro_torch.db import tpch
    from repro_torch.db.plans import compile_plan
    from repro_torch.db.table import HostTable
    db = tpch.generate(n_orders=2000, seed=0, device="cuda")
    host = dict(db.tables(), lineitem=HostTable.from_table(db.lineitem))
    fn = compile_plan(tpch.q1_plan(), device_row_budget=2500,
                      stream_wave_chunks=1)
    first = fn(host)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _assert_same_bits(first, fn(host))


@pytest.mark.cuda
def test_cuda_streamed_q6_exact_launches(cuda_device):
    """Streamed Q6 exact launches logcf once per canonical chunk, as often
    as the resident run (8), and agrees with it bit for bit."""
    from repro_torch.db import tpch
    from repro_torch.db.table import HostTable
    db = tpch.generate(n_orders=2000, seed=0, device="cuda")
    host = tpch.TPCH(**dict(db.tables(),
                            lineitem=HostTable.from_table(db.lineitem)),
                     scale=db.scale)
    pb_cf.logcf.launches = 0
    ref = tpch.q6(db, "aggregate", num_freq=4096)
    resident = pb_cf.logcf.launches
    pb_cf.logcf.launches = 0
    got = tpch.q6(host, "aggregate", num_freq=4096, plan_opts=STREAM_OPTS)
    assert pb_cf.logcf.launches == resident == 8
    _assert_same_bits(ref, got)
