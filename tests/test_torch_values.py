"""The port's exact and approximate COUNT/SUM and the scalar UDA facade
against the JAX package on the same numpy inputs: ``count_pgf`` and
``sum_pgf`` in every method (also against the possible-worlds oracle),
the gamma-mixture fit on identical cumulants, ``fit_from_data`` /
``fit_normal``, every ``aggregates`` UDA, and the card as every ``init``'s
default device.  Float64 (x64 is on through tests/conftest.py) to
rtol=1e-9, atol=1e-12 unless a test says otherwise."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregates as jagg
from repro.core import approx as japprox
from repro.core import poisson_binomial as jpb
from repro_torch.core import aggregates as tagg
from repro_torch.core import approx as tapprox
from repro_torch.core import pgf as tpgf
from repro_torch.core import poisson_binomial as tpb
from repro_torch.core import uda as tuda

TOL = dict(rtol=1e-9, atol=1e-12)


def _close(got, want, **tol):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), **(tol or TOL))


def _oracle(probs, values, monoid, size):
    """Possible-worlds distribution as a dense vector over 0..size-1."""
    out = np.zeros(size)
    for k, pr in tpgf.possible_worlds_pgf(probs, values, monoid).items():
        out[int(k)] += pr
    return out


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(4)
    p = rng.uniform(0.05, 0.95, 11)
    v = np.array([0, 3, 1, 1, 3, 0, 1, 1, 3, 3, 1])
    return p, v


@pytest.mark.parametrize("method", ["cf", "tree", "auto"])
def test_count_pgf_matches_jax_and_oracle(small, method):
    p, _ = small
    got = tpb.count_pgf(torch.from_numpy(p), method=method)
    want = jax.jit(lambda q: jpb.count_pgf(q, method=method).coeffs)(p)
    _close(got.coeffs, want)
    _close(got.coeffs, _oracle(p, p, "COUNT", p.shape[0] + 1))
    assert tpb.TREE_THRESHOLD == jpb.TREE_THRESHOLD


@pytest.mark.parametrize("method", ["cf", "grouped", "auto"])
def test_sum_pgf_matches_jax_and_oracle(small, method):
    p, v = small
    got = tpb.sum_pgf(torch.from_numpy(p), torch.from_numpy(v),
                      method=method)
    if method == "grouped":      # a host loop over the distinct values
        want = jpb.sum_pgf(jnp.asarray(p), jnp.asarray(v),
                           method=method).coeffs
    else:
        want = jax.jit(lambda a, b: jpb.sum_pgf(
            a, b, max_sum=int(v.sum()), method=method).coeffs)(p, v)
    assert got.offset == 0
    _close(got.coeffs, want)
    _close(got.coeffs, _oracle(p, v, "SUM", got.coeffs.shape[0]))


def test_count_and_sum_agree_across_methods_at_300_tuples():
    """cf against tree / grouped past the oracle's reach, and the JAX cf."""
    rng = np.random.default_rng(8)
    p = torch.from_numpy(rng.uniform(0, 1, 300))
    v = torch.from_numpy(rng.integers(0, 6, 300))
    cf = tpb.count_pgf(p, method="cf")
    _close(tpb.count_pgf(p, method="tree").coeffs, cf.coeffs)
    _close(cf.coeffs, jax.jit(lambda q: jpb.count_pgf(
        q, method="cf").coeffs)(p.numpy()))
    _close(tpb.sum_pgf(p, v, method="grouped").coeffs,
           tpb.sum_pgf(p, v, method="cf").coeffs)


def test_logcf_terms_and_finalize_match_jax(small):
    p, v = small
    la, an = tpb.logcf_terms(torch.from_numpy(p), torch.from_numpy(v), 24)
    jla, jan = jpb.logcf_terms(jnp.asarray(p), jnp.asarray(v, jnp.float64),
                               24)
    _close(la, jla)
    _close(an, jan)
    _close(tpb.logcf_finalize(la, an), jpb.logcf_finalize(jla, jan))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(6)
    return rng.uniform(0, 1, 500), rng.integers(1, 10, 500).astype(float)


def test_gamma_mixture_fit_on_identical_kappas(data):
    """The host solve is a copy: equal within 1e-12 on the same input."""
    p, v = data
    kappas = np.asarray(japprox.cumulant_terms(jnp.asarray(p),
                                               jnp.asarray(v), orders=6))
    got = tapprox.fit_gamma_mixture(kappas, p=3)
    want = japprox.fit_gamma_mixture(kappas, p=3)
    for f in ("pis", "mus", "lam", "loc", "scale", "shift"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=1e-12)
    s = np.linspace(want.loc - 3 * want.scale, want.loc + 3 * want.scale, 7)
    np.testing.assert_allclose(got.cdf(s), want.cdf(s), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got.confidence_interval(0.95),
                               want.confidence_interval(0.95), rtol=1e-12)
    assert math.isclose(got.mean(), want.mean(), rel_tol=1e-12)
    with pytest.raises(ValueError):
        tapprox.fit_gamma_mixture(kappas[:4], p=3)


def test_fit_from_data_and_fit_normal_match_jax(data):
    """The JAX side's fit_from_data / fit_normal, with its device sums
    compiled once."""
    p, v = data
    tp, tv = torch.from_numpy(p), torch.from_numpy(v)
    kappas = jax.jit(lambda a, b: japprox.cumulant_terms(a, b, 6))(p, v)
    _close(tapprox.cumulant_terms(tp, tv, 6), kappas)
    got, want = tapprox.fit_from_data(tp, tv), japprox.fit_gamma_mixture(
        np.asarray(kappas), p=3)
    np.testing.assert_allclose(got.pis, want.pis, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.mus, want.mus, rtol=1e-9)
    assert math.isclose(got.lam, want.lam, rel_tol=1e-9)
    t = np.asarray(jax.jit(japprox.normal_terms)(p, v))
    _close(tapprox.normal_terms(tp, tv), t)
    got = tapprox.fit_normal(tp, tv)
    want = japprox.NormalApprox(float(t[0]), math.sqrt(max(float(t[1]), 0)))
    assert math.isclose(got.mu, want.mu, rel_tol=1e-9)
    assert math.isclose(got.sigma, want.sigma, rel_tol=1e-9)
    np.testing.assert_allclose(got.mass_at([10, 20]), want.mass_at([10, 20]),
                               rtol=1e-9)
    np.testing.assert_allclose(got.confidence_interval(),
                               want.confidence_interval(), rtol=1e-9)


@pytest.fixture(scope="module")
def stream():
    """Two tuple batches and a mask, as both packages' tensors."""
    rng = np.random.default_rng(12)
    p, v = rng.uniform(0, 1, 40), rng.integers(0, 6, 40)
    mask = rng.uniform(0, 1, 40) < 0.8
    return p, v, mask


def _drive(uda, init, p, v, mask, with_values):
    """Two masked accumulates of the stream's halves, each from a fresh
    init, merged."""
    halves = (slice(0, 25), slice(25, None))
    states = [uda.accumulate(init(), p[s], *((v[s],) if with_values else ()),
                             mask=mask[s]) for s in halves]
    return uda.merge(*states)


@pytest.mark.parametrize("name", ["atleastone", "count_cf", "sum_cf",
                                  "cumulants", "normal"])
def test_aggregates_facade_matches_jax(stream, name):
    p, v, mask = stream
    make = {"atleastone": lambda m: m.AtLeastOne,
            "count_cf": lambda m: m.CountCF(40),
            "sum_cf": lambda m: m.SumCF(200),
            "cumulants": lambda m: m.SumCumulants(3),
            "normal": lambda m: m.SumNormal}[name]
    with_values = name not in ("atleastone", "count_cf")
    ju, tu = make(jagg), make(tagg)
    jst = jax.jit(lambda *a: _drive(ju, ju.init, *a, with_values))(
        p, v, mask)
    tst = _drive(tu, lambda: tu.init(dtype=torch.float64, device="cpu"),
                 *(torch.from_numpy(x) for x in (p, v, mask)), with_values)
    for a, b in zip(tst, jst):
        _close(a, b)
    jres, tres = ju.finalize(jst), tu.finalize(tst)
    if name in ("count_cf", "sum_cf"):
        _close(tres.coeffs, jres.coeffs)
    elif name == "atleastone":
        _close(tres, jres)
    elif name == "cumulants":
        np.testing.assert_allclose(tres.pis, jres.pis, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tres.mus, jres.mus, rtol=1e-9)
    else:
        assert math.isclose(tres.mu, jres.mu, rel_tol=1e-9)
        assert math.isclose(tres.sigma, jres.sigma, rel_tol=1e-9)


def test_min_max_uda_facade_matches_jax(stream):
    """MIN with kappa = 3, below the 6 distinct values: truncation is live.
    (MAX is the same code with sign -1: tests/test_torch_minmax.py.)"""
    sign = 1.0
    p, v, mask = stream
    v = v.astype(float)
    halves = (slice(0, 25), slice(25, None))

    def drive(m, init, p, v, mask):
        st = m.merge(*(m.accumulate(init(), p[s], v[s], mask[s])
                       for s in halves))
        return st, m.finalize(st), m.p_empty(st), m.to_pgf(st, -1, 7)

    jm, tm = jagg.MinUDA(3, sign), tagg.MinUDA(3, sign)
    want = jax.jit(lambda *a: drive(jm, jm.init, *a))(p, v, mask)
    got = drive(tm, lambda: tm.init(dtype=torch.float64, device="cpu"),
                *(torch.from_numpy(x) for x in (p, v, mask)))
    np.testing.assert_array_equal(got[0].values.numpy(),
                                  np.asarray(want[0].values))
    for a, b in zip(got[0][1:] + got[1] + (got[2],),
                    want[0][1:] + want[1] + (want[2],)):
        _close(a, b)
    for f in ("coeffs", "p_pos_inf", "p_neg_inf"):
        _close(getattr(got[3], f), getattr(want[3], f))
    assert got[3].offset == -1
    assert tagg.MaxUDA(3) == tagg.MinUDA(3, -1.0)


@pytest.mark.parametrize("make", [
    lambda: tuda.AtLeastOne().init(4), lambda: tuda.SumNormal().init(4),
    lambda: tuda.SumCumulants().init(4), lambda: tuda.SumCF(16).init(4),
    lambda: tuda.MinMax(4).init(4), lambda: tagg.AtLeastOne.init(),
    lambda: tagg.SumCF(8).init(), lambda: tagg.SumCumulants().init(),
    lambda: tagg.SumNormal.init(), lambda: tagg.MinUDA(4).init(),
    lambda: tpgf.PGF.from_scalar(3), lambda: tpgf.PGF.bernoulli(0.5, 2)])
def test_init_defaults_to_the_card(make):
    """Every init and constructor allocates on the card by default: on a
    host without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        out = make()
        first = out.coeffs if isinstance(out, tpgf.PGF) else out[0]
        assert first.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
