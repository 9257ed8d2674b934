"""Exact COUNT / SUM distributions via log-domain characteristic functions
(port of ``repro.core.poisson_binomial``).

The COUNT PGF Q(X) = prod_i (q_i + p_i X) (paper Eq. 4) is evaluated at
the N-th roots of unity, N = n + 1, as a sum of complex logs

    log Q(w^k) = sum_i log(q_i + p_i w^k)

followed by one length-N FFT: coeffs = FFT(exp(logQ)) / N.  SUM with
nonnegative integer values a_i (§V-C.2) is the same with w^{k a_i}.  The
paper-faithful alternatives are the pairwise FFT product tree
(:func:`count_pgf_tree`) and the group-by-value / stretch / product path
(:func:`sum_pgf_grouped`); all are exact.

Integer-typed values (and COUNT's all-ones column) take the ``logcf``
kernel under the ``kernels/ops.py`` guards, as in :func:`uda.accumulate`.
"""
from __future__ import annotations

import torch

from . import uda
from .pgf import PGF, product_tree


def logcf_terms(probs, values, num_freq: int, block: int = 4096):
    """Accumulated (sum over tuples) log CF at the num_freq DFT
    frequencies: (log_abs_sum, angle_sum), each (num_freq,) — the scalar
    view of :class:`repro_torch.core.uda.SumCF`.  ``values`` None means
    all-ones (COUNT)."""
    st = uda.accumulate({"cf": uda.SumCF(num_freq)}, probs, values, None,
                        max_groups=1, block=block)["cf"]
    return st.log_abs[0], st.angle[0]


def sharded_logcf(probs, values, num_freq: int, ax):
    """This rank's tuples accumulated, then one psum per output over the
    ranks of ``ax`` (a :class:`~repro_torch.launch.mesh.MeshAxis`): the
    summed log CF of the union.  A float psum adds in the backend's
    order, so it agrees with the one-device sum to rounding."""
    from ..db.distributed import psum
    la, an = logcf_terms(probs, values, num_freq)
    return psum(la, ax), psum(an, ax)


def logcf_finalize(log_abs, angle):
    """exp + FFT: recover the coefficient vector from summed log CF."""
    return uda.SumCF(log_abs.shape[-1]).finalize(
        uda.CFState(log_abs[None], angle[None]))[0]


# Above this size the O(n log^2 n) FFT product tree beats the O(n*F)
# log-CF evaluation on a single device (the paper's §VII-B dispatch, one
# level up).
TREE_THRESHOLD = 8192


def count_pgf_tree(probs) -> PGF:
    """Exact COUNT via the paper-faithful pairwise FFT product tree."""
    factors = torch.stack([1.0 - probs, probs], dim=1)    # (n, 2) rows
    f = product_tree(factors)
    return PGF(f.coeffs[: probs.shape[0] + 1], 0)


def count_pgf(probs, block: int = 4096, method: str = "auto") -> PGF:
    """Exact Poisson-binomial COUNT distribution (paper Eq. 4).

    method: 'cf' (log-CF + FFT), 'tree' (pairwise FFT product tree), or
    'auto' (the tree from TREE_THRESHOLD tuples on)."""
    n = probs.shape[0]
    if method == "tree" or (method == "auto" and n >= TREE_THRESHOLD):
        return count_pgf_tree(probs)
    la, an = logcf_terms(probs, None, n + 1, block)
    return PGF(logcf_finalize(la, an), 0)


def sum_pgf(probs, values, max_sum: int | None = None, block: int = 4096,
            method: str = "auto") -> PGF:
    """Exact SUM distribution for nonnegative-integer values (§V-C.2).

    method 'auto' routes inputs of TREE_THRESHOLD tuples or more to the
    grouped/stretch/FFT path (O(sum log^2) instead of O(n * sum)); 'cf'
    forces the log-CF path."""
    if method == "grouped" or (method == "auto"
                               and probs.shape[0] >= TREE_THRESHOLD):
        return sum_pgf_grouped(probs, values)
    if max_sum is None:
        max_sum = int(torch.sum(values))
    la, an = logcf_terms(probs, values, max_sum + 1, block)
    return PGF(logcf_finalize(la, an), 0)


def sum_pgf_grouped(probs, values) -> PGF:
    """Paper-faithful SUM: group tuples by value, COUNT-PGF per group,
    'evaluate at X^{alpha_k}' by coefficient stretching, and fold the
    factors with ``mul_sum`` left to right in ascending value order
    (§V-C general case + §VII-D); value-0 tuples do not move the sum."""
    acc = None
    for alpha in torch.unique(values).tolist():
        if int(alpha) == 0:
            continue
        f = count_pgf(probs[values == alpha]).stretch(int(alpha))
        acc = f if acc is None else acc.mul_sum(f)
    if acc is None:
        return PGF(torch.ones((1,), dtype=probs.dtype, device=probs.device),
                   0)
    return acc
