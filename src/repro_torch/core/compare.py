"""PGF ADT comparison operations (paper Fig. 5 and §VII-A; port of
``repro.core.compare``), for dense PGFs and for the approximation objects
(anything with ``cdf`` / ``mass_at``):

    Equal / Greater / GreaterEq   vs scalar
    Equal / Greater / GreaterEq   vs another independent PGF

Scalar comparisons on a dense PGF reduce to prefix sums of the coefficient
vector; PGF-vs-PGF comparisons iterate one distribution and accumulate the
other's cdf/survival — the paper's §VII-A algorithm, vectorised.
"""
from __future__ import annotations

import torch

from .pgf import PGF


# -------------------------------------------------------------- vs scalar
def equal(f: PGF, a):
    return f.mass_at(a)


def greater(f: PGF, a):
    """P(F > a).  +inf mass counts as greater; cdf excludes it already."""
    return 1.0 - f.cdf(a)


def greater_eq(f: PGF, a):
    return 1.0 - f.cdf(a) + f.mass_at(a)


def less(f: PGF, a):
    return f.cdf(a) - f.mass_at(a)


def less_eq(f: PGF, a):
    return f.cdf(a)


# ------------------------------------------------------------- vs PGF
def _aligned(f: PGF, g: PGF):
    _, fa, ga = f._union_grid(g)
    return fa.coeffs, ga.coeffs


def equal_pgf(f: PGF, g: PGF):
    """P(F = G) = sum_v P(F=v) P(G=v) over the shared domain (§VII-A),
    assuming independence (enforced by the hierarchical-query
    restriction)."""
    fa, ga = _aligned(f, g)
    return (torch.sum(fa * ga) + f.p_pos_inf * g.p_pos_inf
            + f.p_neg_inf * g.p_neg_inf)


def greater_pgf(f: PGF, g: PGF):
    """P(F > G) = sum_v P(G=v) P(F > v), ties at +/-inf excluded
    (§VII-A)."""
    fa, ga = _aligned(f, g)
    surv_f_finite = fa.sum() - torch.cumsum(fa, 0)  # P(F > v, F finite)
    finite = torch.sum(ga * surv_f_finite)
    return (finite
            + f.p_pos_inf * (1.0 - g.p_pos_inf)   # F=+inf beats all but G=+inf
            + fa.sum() * g.p_neg_inf)             # F finite beats G=-inf


def greater_eq_pgf(f: PGF, g: PGF):
    return greater_pgf(f, g) + equal_pgf(f, g)


# ------------------------------------------------ generic (approx objects)
def prob_greater(dist, a) -> float:
    """P(D > a) for any object exposing cdf (NormalApprox, GammaMixture)."""
    return float(1.0 - dist.cdf(a))


def prob_greater_eq(dist, a) -> float:
    if hasattr(dist, "mass_at"):
        return float(1.0 - dist.cdf(a) + dist.mass_at(a))
    return float(1.0 - dist.cdf(a))


def prob_equal(dist, a) -> float:
    return float(dist.mass_at(a))
