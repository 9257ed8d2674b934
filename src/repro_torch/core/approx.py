"""Approximate SUM/COUNT distributions (paper §V-C.3; port of
``repro.core.approx``).

* **Normal** — match mean and variance of the Poisson-binomial-weighted
  sum, with the paper's variance erratum fixed: sigma^2 = sum v^2 p (1-p).
* **Moment-based** — Lindsay's gamma-mixture method: match the first 2p raw
  moments of the standardised sum (shifted by the paper's 10 sigma) with a
  p-component gamma mixture sharing a dispersion parameter lambda.  The
  moments come from exact cumulants kappa_j(sum_i v_i B_i) =
  sum_i v_i^j kappa_j(B_i), with the Bernoulli cumulants of the recursion
  kappa_{j+1} = p q d kappa_j / dp as exact integer-coefficient
  polynomials in p.

The cumulant and (mean, variance) sums run on the tensors' device through
:mod:`repro_torch.core.uda` (the cumulants on the ``cumulant_sums``
kernel); the O(p^3) mixture solve runs on the host in numpy/scipy, as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
from scipy import optimize, special

MAX_ORDER = 12  # supports mixtures with up to p = 6 components


# --------------------------------------------------------------- cumulants
@lru_cache(maxsize=None)
def _bernoulli_cumulant_polys(max_order: int = MAX_ORDER) -> np.ndarray:
    """Coefficient table C[j] for kappa_j(p) = sum_d C[j, d] p^d."""
    table = np.zeros((max_order + 1, max_order + 1))
    table[1, 1] = 1.0  # kappa_1 = p
    for j in range(1, max_order):
        deriv = np.polynomial.polynomial.polyder(table[j])
        # multiply by (p - p^2)
        nxt = np.polynomial.polynomial.polymul(deriv, np.array([0.0, 1.0, -1.0]))
        table[j + 1, : len(nxt)] = nxt[: max_order + 1]
    return table


def cumulant_terms(probs, values, orders: int = 8):
    """Streaming partial sums s_j = sum_i v_i^j kappa_j(p_i), j = 1..orders,
    shape (orders,): the scalar view of
    :class:`repro_torch.core.uda.SumCumulants`."""
    from . import uda
    st = uda.accumulate({"cum": uda.SumCumulants(orders)}, probs, values,
                        None, max_groups=1)["cum"]
    return st.terms[0]


def moments_from_cumulants(kappas: np.ndarray) -> np.ndarray:
    """Raw moments m_1..m_R from cumulants kappa_1..kappa_R.

    m_n = sum_{k=0}^{n-1} C(n-1, k) kappa_{k+1} m_{n-1-k},  m_0 = 1.
    """
    r = len(kappas)
    m = np.zeros(r + 1)
    m[0] = 1.0
    for n in range(1, r + 1):
        m[n] = sum(math.comb(n - 1, k) * kappas[k] * m[n - 1 - k]
                   for k in range(n))
    return m[1:]


def standardized_cumulants(kappas: np.ndarray, shift: float = 10.0) -> np.ndarray:
    """Cumulants of Z = (A - kappa_1)/sqrt(kappa_2) + shift (paper's 10-sigma)."""
    out = np.array(kappas, dtype=np.float64)
    sigma = math.sqrt(max(out[1], 1e-300))
    for j in range(len(out)):
        out[j] = out[j] / sigma ** (j + 1)
    out[0] = shift  # kappa_1(Z)
    return out


# --------------------------------------------------------- Lindsay mixture
@dataclasses.dataclass
class GammaMixture:
    """Mixture of p gammas with common shape alpha = 1/lambda (paper Eq. 5-6),
    fitted in standardised coordinates; (loc, scale) map back to the sum."""

    pis: np.ndarray
    mus: np.ndarray      # component means (standardised coords)
    lam: float
    loc: float           # A = (Z - shift) * scale + loc
    scale: float
    shift: float = 10.0

    @property
    def alpha(self) -> float:
        return 1.0 / self.lam

    def cdf_std(self, z):
        z = np.maximum(np.asarray(z, np.float64), 0.0)
        thetas = self.mus * self.lam          # scale_j = mu_j / alpha
        return sum(pi * special.gammainc(self.alpha, z / th)
                   for pi, th in zip(self.pis, thetas))

    def cdf(self, s):
        z = (np.asarray(s, np.float64) - self.loc) / self.scale + self.shift
        return self.cdf_std(z)

    def mass_at(self, s):
        """P(A = s) ~= integral of the pdf over [s - 1/2, s + 1/2] (§VII-D)."""
        s = np.asarray(s, np.float64)
        return self.cdf(s + 0.5) - self.cdf(s - 0.5)

    def mean(self):
        return self.loc + (float(np.dot(self.pis, self.mus)) - self.shift) * self.scale

    def confidence_interval(self, gamma: float = 0.95):
        tail = (1.0 - gamma) / 2.0
        lo = self._ppf(tail)
        hi = self._ppf(1.0 - tail)
        return lo, hi

    def _ppf(self, q):
        f = lambda s: self.cdf(s) - q
        lo = self.loc - 12 * self.scale
        hi = self.loc + 12 * self.scale
        return optimize.brentq(f, lo, hi, xtol=1e-12 * max(1.0, abs(hi)))


def _delta(ms: np.ndarray, r: int, lam: float) -> float:
    """delta*_r(lambda) = m_r / prod_{i=1}^{r-1} (1 + i lambda)  (paper Eq. 7).
    Convention m_0 = 1 => delta_0 = 1, delta_1 = m_1."""
    if r == 0:
        return 1.0
    denom = 1.0
    for i in range(1, r):
        denom *= 1.0 + i * lam
    return ms[r - 1] / denom


def _det_delta(ms: np.ndarray, k: int, lam: float) -> float:
    """det of the (k+1)x(k+1) pseudo-moment Hankel matrix Delta_k (Eq. 8)."""
    mat = np.array([[_delta(ms, j + l, lam) for l in range(k + 1)]
                    for j in range(k + 1)])
    return float(np.linalg.det(mat))


def fit_gamma_mixture(kappas: np.ndarray, p: int = 3,
                      shift: float = 10.0) -> GammaMixture:
    """Lindsay's moment-matching algorithm (paper §V-C.3 steps 1-3)."""
    kappas = np.asarray(kappas, np.float64)
    if len(kappas) < 2 * p:
        raise ValueError(f"need 2p = {2 * p} cumulants, got {len(kappas)}")
    loc = kappas[0]
    scale = math.sqrt(max(kappas[1], 1e-300))
    kz = standardized_cumulants(kappas, shift)[: 2 * p]
    ms = moments_from_cumulants(kz)

    # Step 1: nested roots lambda_1 > lambda_2 > ... > lambda_p >= 0.
    lam_prev = None
    for k in range(1, p + 1):
        f = lambda l: _det_delta(ms, k, l)
        if k == 1:
            # det Delta_1 = delta_2 - delta_1^2 = m2/(1+lam) - m1^2 = 0
            lam = ms[1] / ms[0] ** 2 - 1.0
        else:
            hi = lam_prev * (1 - 1e-12)
            lo = 0.0
            flo, fhi = f(lo), f(hi)
            if flo * fhi > 0:  # root guaranteed by theory; guard numerics
                grid = np.linspace(lo, hi, 4097)
                vals = np.array([f(g) for g in grid])
                sgn = np.signbit(vals)
                idx = np.nonzero(sgn[:-1] != sgn[1:])[0]
                if len(idx) == 0:
                    lam = lo  # degenerate: fall back to smaller dispersion
                else:
                    lo, hi = grid[idx[-1]], grid[idx[-1] + 1]
                    lam = optimize.brentq(f, lo, hi, xtol=1e-15)
            else:
                lam = optimize.brentq(f, lo, hi, xtol=1e-15)
        lam_prev = lam
    lam = max(lam_prev, 1e-12)

    # Step 2: mu_j = roots of the polynomial whose coefficients are the last
    # row of Delta_p(lam)^{-1} (via eigendecomposition, as in the paper).
    mat = np.array([[_delta(ms, j + l, lam) for l in range(p + 1)]
                    for j in range(p + 1)])
    w, v = np.linalg.eigh(mat)
    inv = (v / w) @ v.T
    coeffs = inv[-1]            # c_0 + c_1 x + ... + c_p x^p
    mus = np.roots(coeffs[::-1])
    mus = np.real(mus[np.isreal(mus) | (np.abs(mus.imag) < 1e-9 * np.abs(mus.real))])
    mus = np.sort(mus)[:p]
    if len(mus) < p:            # degenerate fit: pad with the moment mean
        mus = np.concatenate([mus, np.full(p - len(mus), ms[0])])

    # Step 3: Vandermonde system for the mixing weights (paper step 3).
    vand = np.vander(mus, p, increasing=True).T
    rhs = np.array([_delta(ms, r, lam) for r in range(p)])
    pis, *_ = np.linalg.lstsq(vand, rhs, rcond=None)
    pis = np.clip(pis, 0.0, None)
    pis = pis / pis.sum()
    return GammaMixture(pis, np.maximum(mus, 1e-9), lam, loc, scale, shift)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def fit_from_data(probs, values, p: int = 3) -> GammaMixture:
    """End-to-end moment approximation of the SUM distribution: the 2p
    cumulant sums on the tensors' device, the fit on the host."""
    return fit_gamma_mixture(_host(cumulant_terms(probs, values,
                                                  orders=2 * p)), p=p)


# ------------------------------------------------------------------ normal
@dataclasses.dataclass
class NormalApprox:
    mu: float
    sigma: float

    def cdf(self, s):
        z = (np.asarray(s, np.float64) - self.mu) / max(self.sigma, 1e-300)
        return 0.5 * (1.0 + special.erf(z / math.sqrt(2.0)))

    def mass_at(self, s):
        s = np.asarray(s, np.float64)
        return self.cdf(s + 0.5) - self.cdf(s - 0.5)

    def mean(self):
        return self.mu

    def confidence_interval(self, gamma: float = 0.95):
        from scipy.stats import norm
        tail = (1.0 - gamma) / 2.0
        return (norm.ppf(tail, self.mu, self.sigma),
                norm.ppf(1 - tail, self.mu, self.sigma))


def normal_terms(probs, values):
    """Streaming (mean, var) partial sums (paper-erratum variance fix):
    the scalar view of :class:`repro_torch.core.uda.SumNormal`."""
    from . import uda
    st = uda.accumulate({"n": uda.SumNormal()}, probs, values, None,
                        max_groups=1)["n"]
    return st.terms[0]


def fit_normal(probs, values) -> NormalApprox:
    t = _host(normal_terms(probs, values))
    return NormalApprox(float(t[0]), math.sqrt(max(float(t[1]), 0.0)))
