"""The port's value type against the JAX package on the same numpy inputs:
every ``PGF`` method, ``mul_sum`` on both sides of ``FFT_THRESHOLD`` (with a
float32 case through the ``polymul`` wrapper's CPU route),
``fft_convolve``, ``convolve_batch``, ``product_tree`` with odd row counts
at several levels, the possible-worlds oracle, every ``compare`` function
and the monoids.  Float64 (x64 is on through tests/conftest.py) to
rtol=1e-9, atol=1e-12 unless a test says otherwise."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as japprox
from repro.core import compare as jcmp
from repro.core import monoids as jmon
from repro.core import pgf as jpgf
from repro_torch.core import approx as tapprox
from repro_torch.core import compare as tcmp
from repro_torch.core import monoids as tmon
from repro_torch.core import pgf as tpgf
from repro_torch.kernels import polymul

TOL = dict(rtol=1e-9, atol=1e-12)


def _close(got, want, **tol):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), **(tol or TOL))


def _pair(coeffs, offset=0, pos=0.0, neg=0.0):
    """The same PGF in both packages."""
    c = np.asarray(coeffs, np.float64)
    return (jpgf.PGF(jnp.asarray(c), offset, pos, neg),
            tpgf.PGF(torch.from_numpy(c.copy()), offset, pos, neg))


def _dist(rng, k, pos=0.1, neg=0.05):
    c = rng.uniform(0, 1, k)
    return c / c.sum() * (1.0 - pos - neg)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    return _pair(_dist(rng, 17), offset=-3, pos=0.1, neg=0.05)


@pytest.mark.parametrize("method", [
    "support", "total_mass", "normalize", "mean", "variance",
    "confidence_interval", "_survival", "to_numpy"])
def test_pgf_properties_match_jax(pair, method):
    jf, tf = pair
    if method == "support":
        np.testing.assert_array_equal(tf.support.numpy(),
                                      np.asarray(jf.support))
    elif method == "normalize":
        jg, tg = jf.normalize(), tf.normalize()
        _close(tg.coeffs, jg.coeffs)
        _close(tg.p_pos_inf, jg.p_pos_inf)
        _close(tg.p_neg_inf, jg.p_neg_inf)
    elif method == "confidence_interval":
        for gamma in (0.5, 0.9, 0.95):
            got, want = tf.normalize().confidence_interval(gamma), \
                jf.normalize().confidence_interval(gamma)
            assert [int(x) for x in got] == [int(x) for x in want]
    elif method == "to_numpy":
        got, want = tf.to_numpy(), jf.to_numpy()
        _close(got[0], want[0])
        assert got[1:] == want[1:]
    else:
        _close(getattr(tf, method)(), getattr(jf, method)())


@pytest.mark.parametrize("value", [-5, -3, 0, 4, 13, 14, 30])
def test_pgf_mass_at_and_cdf_match_jax(pair, value):
    jf, tf = pair
    _close(tf.mass_at(value), jf.mass_at(value))
    _close(tf.cdf(value), jf.cdf(value))


@pytest.mark.parametrize("monoid,value", [
    ("SUM", 4), ("SUM", -2), ("SUM", 0), ("COUNT", 7), ("MIN", 3),
    ("MAX", -1)])
def test_pgf_constructors_match_jax(monoid, value):
    jf = jpgf.PGF.bernoulli(0.3, value, monoid)
    tf = tpgf.PGF.bernoulli(0.3, value, monoid, dtype=torch.float64,
                            device="cpu")
    _close(tf.coeffs, jf.coeffs)
    assert tf.offset == jf.offset
    _close(tf.p_pos_inf, jf.p_pos_inf)
    _close(tf.p_neg_inf, jf.p_neg_inf)
    js = jpgf.PGF.from_scalar(value)
    ts = tpgf.PGF.from_scalar(value, dtype=torch.float64, device="cpu")
    _close(ts.coeffs, js.coeffs)
    assert ts.offset == js.offset and ts.coeffs.dtype == torch.float64


@pytest.mark.parametrize("op,arg", [
    ("truncate_smallest", 5), ("truncate_smallest", 40), ("stretch", 0),
    ("stretch", 1), ("stretch", 3)])
def test_pgf_reshaping_matches_jax(pair, op, arg):
    jf, tf = pair
    jg, tg = getattr(jf, op)(arg), getattr(tf, op)(arg)
    _close(tg.coeffs, jg.coeffs)
    assert tg.offset == jg.offset
    _close(tg.p_pos_inf, jg.p_pos_inf)
    _close(tg.p_neg_inf, jg.p_neg_inf)


def test_pgf_embed_matches_jax(pair):
    jf, tf = pair
    jg, tg = jpgf._embed(jf, -10, 20), tpgf._embed(tf, -10, 20)
    _close(tg.coeffs, jg.coeffs)
    assert tg.offset == jg.offset == -10


@pytest.mark.parametrize("k1,k2", [
    (5, 7),          # schoolbook, below the kernel's degree guard
    (1024, 1024),    # schoolbook at the threshold
    (200, 300),      # schoolbook, float64: the plain convolution
    (1025, 10),      # FFT: the longer factor is past FFT_THRESHOLD
    (1100, 1500)])   # FFT
def test_mul_sum_matches_jax(k1, k2):
    rng = np.random.default_rng(k1 + k2)
    ja, ta = _pair(_dist(rng, k1, 0, 0), offset=2)
    jb, tb = _pair(_dist(rng, k2, 0, 0), offset=-1)
    jc, tc = ja.mul_sum(jb), ta.mul_sum(tb)
    assert tc.offset == jc.offset == 1
    _close(tc.coeffs, jc.coeffs)
    _close(ta.mul(tb, "COUNT").coeffs, jc.coeffs)


def test_mul_sum_float32_takes_the_polymul_wrapper(monkeypatch):
    """Float32 factors of >= 128 coefficients below the threshold go to
    the polymul wrapper (its CPU route here: the plain version), smaller
    ones to the plain convolution.  Float32: rtol=1e-5, atol=1e-6."""
    calls = []
    wrapper = polymul.polymul
    monkeypatch.setattr(polymul, "polymul",
                        lambda a, b: calls.append(1) or wrapper(a, b))
    rng = np.random.default_rng(3)
    for (k1, k2), expect in (((150, 300), 1), ((100, 300), 1)):
        a, b = (_dist(rng, k, 0, 0).astype(np.float32) for k in (k1, k2))
        got = tpgf.PGF(torch.from_numpy(a)).mul_sum(
            tpgf.PGF(torch.from_numpy(b)))
        want = jpgf.PGF(jnp.asarray(a)).mul_sum(jpgf.PGF(jnp.asarray(b)))
        assert got.coeffs.dtype == torch.float32
        _close(got.coeffs, want.coeffs, rtol=1e-5, atol=1e-6)
        assert len(calls) == expect
    assert polymul.polymul.__name__ == "<lambda>"
    assert wrapper.launches == 0       # the CPU route launches nothing


@pytest.mark.parametrize("op", ["MIN", "MAX"])
def test_mul_min_max_match_jax(op):
    rng = np.random.default_rng(7)
    ja, ta = _pair(_dist(rng, 6, 0.2, 0.1), offset=3, pos=0.2, neg=0.1)
    jb, tb = _pair(_dist(rng, 9, 0.05, 0.15), offset=-2, pos=0.05, neg=0.15)
    jc, tc = ja.mul(jb, op), ta.mul(tb, op)
    assert tc.offset == jc.offset
    _close(tc.coeffs, jc.coeffs)
    _close(tc.p_pos_inf, jc.p_pos_inf)
    _close(tc.p_neg_inf, jc.p_neg_inf)


def test_fft_convolve_and_convolve_batch_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.uniform(0, 1, 37), rng.uniform(0, 1, 1000)
    _close(tpgf.fft_convolve(torch.from_numpy(a), torch.from_numpy(b)),
           jpgf.fft_convolve(jnp.asarray(a), jnp.asarray(b)))
    polys = rng.uniform(0, 1, (6, 33))
    _close(tpgf.convolve_batch(torch.from_numpy(polys)),
           jpgf.convolve_batch(jnp.asarray(polys)))


@pytest.mark.parametrize("rows", [1, 21])
def test_product_tree_matches_jax(rows):
    """21 rows are odd at three levels (21, 11, 3): the carried rows."""
    rng = np.random.default_rng(rows)
    factors = rng.uniform(0, 1, (rows, 3))
    offsets = list(rng.integers(-2, 3, rows))
    want = jax.jit(lambda f: jpgf.product_tree(f, offsets).coeffs)(factors)
    tf = tpgf.product_tree(torch.from_numpy(factors), offsets)
    assert tf.offset == sum(offsets)
    _close(tf.coeffs, want)


@pytest.mark.parametrize("monoid", ["SUM", "COUNT", "MIN", "MAX"])
def test_possible_worlds_matches_jax(monoid):
    rng = np.random.default_rng(2)
    p, v = rng.uniform(0, 1, 8), rng.integers(-3, 6, 8)
    got = tpgf.possible_worlds_pgf(p, v, monoid)
    want = jpgf.possible_worlds_pgf(p, v, monoid)
    assert sorted(got) == sorted(want)
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-12, abs_tol=1e-15)


@pytest.fixture(scope="module")
def pgfs():
    rng = np.random.default_rng(9)
    return (_pair(_dist(rng, 8, 0.1, 0.05), offset=2, pos=0.1, neg=0.05),
            _pair(_dist(rng, 11, 0.2, 0.0), offset=-1, pos=0.2))


@pytest.mark.parametrize("name", ["equal", "greater", "greater_eq", "less",
                                  "less_eq"])
def test_compare_vs_scalar_matches_jax(pgfs, name):
    (jf, tf), _ = pgfs
    for a in (-4, 2, 5, 9, 20):
        _close(getattr(tcmp, name)(tf, a), getattr(jcmp, name)(jf, a))


@pytest.mark.parametrize("name", ["equal_pgf", "greater_pgf",
                                  "greater_eq_pgf"])
def test_compare_pgf_vs_pgf_matches_jax(pgfs, name):
    (jf, tf), (jg, tg) = pgfs
    _close(getattr(tcmp, name)(tf, tg), getattr(jcmp, name)(jf, jg))
    _close(getattr(tcmp, name)(tg, tf), getattr(jcmp, name)(jg, jf))


@pytest.mark.parametrize("name", ["prob_greater", "prob_greater_eq",
                                  "prob_equal"])
def test_compare_generic_matches_jax(pgfs, name):
    (jf, tf), _ = pgfs
    jn, tn = japprox.NormalApprox(4.0, 1.5), tapprox.NormalApprox(4.0, 1.5)
    for a in (2, 4, 7):
        assert math.isclose(getattr(tcmp, name)(tn, a),
                            getattr(jcmp, name)(jn, a), rel_tol=1e-12)
        assert math.isclose(getattr(tcmp, name)(tf, a),
                            getattr(jcmp, name)(jf, a), rel_tol=1e-9,
                            abs_tol=1e-12)


@pytest.mark.parametrize("agg", ["SUM", "MIN", "MAX", "COUNT"])
def test_monoids_match_jax(agg):
    vals = np.array([1.5, math.inf, -math.inf, -2.0, 0.0])
    np.testing.assert_array_equal(tmon.translate(agg, vals).numpy(),
                                  np.asarray(jmon.translate(agg, vals)))
    m, jm = tmon.BY_NAME[agg], jmon.BY_NAME[agg]
    assert (m.name, m.neutral) == (jm.name, jm.neutral)
    assert m.fold([3.0, -1.0, 2.0]) == jm.fold([3.0, -1.0, 2.0])
