"""Bernoulli cumulant polynomials (paper §V-C.3), the part of
``repro.core.approx`` the cumulant UDA and kernels need.

kappa_1 = p and kappa_{j+1} = p(1-p) d kappa_j / dp, as exact
integer-coefficient polynomials in p.  The gamma-mixture fit that consumes
the cumulant sums is not ported yet: ``SumCumulants.finalize`` returns the
raw sums.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

MAX_ORDER = 12  # supports mixtures with up to p = 6 components


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
