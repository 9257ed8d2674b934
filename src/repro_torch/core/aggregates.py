"""Scalar UDA facade (paper §VI-A; port of ``repro.core.aggregates``):
Initialize / Accumulate / Merge / Finalize over one stream of tuples.

The aggregate math lives once in :mod:`repro_torch.core.uda`, vectorised
over groups; this module is its scalar (max_groups == 1) view: lift the
scalar state to one group, run the canonical accumulation loop, drop the
group axis again.  Every UDA accepts a ``mask``: a masked-out tuple is a
p = 0 tuple for SUM/COUNT/AtLeastOne and "not in the list" for MIN/MAX.

    CountCF / SumCF         exact distributions via log-CF          (§V-A/C)
    SumCumulants            moment terms for the gamma mixture      (§V-C.3)
    SumNormal               mean/variance terms                     (§V-C.3)
    MinUDA / MaxUDA         top-kappa (value, AtLeastOne) list      (§V-B, §VII-C)
    AtLeastOne              the projection/group-confidence UDA     (§VI row V)

``init`` allocates on ``device`` (the card by default); every other
method follows the tensors it is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from . import approx, uda
from .pgf import PGF


def _run(u: uda.UDA, state, probs, values=None, mask=None):
    """One-group accumulate through the canonical loop in core/uda.py.
    ``values`` is passed uncast: the loop casts to the probs dtype itself
    and uses the original dtype for the CF kernel's eligibility."""
    return uda.accumulate({"u": u}, uda.masked_probs(probs, mask), values,
                          None, max_groups=1, states={"u": state})["u"]


# ------------------------------------------------------------- AtLeastOne
class AtLeastOneState(NamedTuple):
    log_none: torch.Tensor  # sum of log(1 - p) over accumulated tuples


class AtLeastOne:
    """P(at least one tuple present) = 1 - prod (1 - p_i)  (§VI row V)."""

    _U = uda.AtLeastOne()

    @staticmethod
    def init(dtype=None, device="cuda") -> AtLeastOneState:
        return AtLeastOneState(
            AtLeastOne._U.init(1, dtype, device).log_none[0])

    @staticmethod
    def accumulate(state: AtLeastOneState, probs, mask=None):
        st = _run(AtLeastOne._U, uda.AtLeastOneState(state.log_none[None]),
                  probs, mask=mask)
        return AtLeastOneState(st.log_none[0])

    @staticmethod
    def merge(a: AtLeastOneState, b: AtLeastOneState) -> AtLeastOneState:
        return AtLeastOneState(a.log_none + b.log_none)

    @staticmethod
    def finalize(state: AtLeastOneState):
        return 1.0 - torch.exp(state.log_none)


# ------------------------------------------------------------ CF exact UDAs
class CFState(NamedTuple):
    log_abs: torch.Tensor  # (num_freq,)
    angle: torch.Tensor    # (num_freq,)


class SumCF:
    """Exact SUM (and COUNT, with values == 1) over integer values via the
    log characteristic function; ``num_freq`` = max_sum + 1 is the static
    distribution capacity, fixed at Initialize time."""

    def __init__(self, num_freq: int):
        self.num_freq = int(num_freq)
        self._u = uda.SumCF(self.num_freq)

    def init(self, dtype=None, device="cuda") -> CFState:
        st = self._u.init(1, dtype, device)
        return CFState(st.log_abs[0], st.angle[0])

    def accumulate(self, state: CFState, probs, values=None,
                   mask=None) -> CFState:
        st = _run(self._u, uda.CFState(state.log_abs[None], state.angle[None]),
                  probs, values, mask)
        return CFState(st.log_abs[0], st.angle[0])

    @staticmethod
    def merge(a: CFState, b: CFState) -> CFState:
        return CFState(a.log_abs + b.log_abs, a.angle + b.angle)

    @staticmethod
    def psum_merge(state: CFState, ax) -> CFState:
        """Merge the ranks of ``ax`` (a MeshAxis): one psum per field."""
        from ..db.distributed import psum
        return CFState(psum(state.log_abs, ax), psum(state.angle, ax))

    def finalize(self, state: CFState) -> PGF:
        coeffs = self._u.finalize(uda.CFState(state.log_abs[None],
                                              state.angle[None]))
        return PGF(coeffs[0], 0)


def CountCF(capacity: int) -> SumCF:
    """COUNT = SUM of T_COUNT-translated values (all ones), §IV-F step 1."""
    return SumCF(capacity + 1)


# ------------------------------------------------------- moment-based UDAs
class CumulantState(NamedTuple):
    terms: torch.Tensor  # (2p,) partial cumulant sums


class SumCumulants:
    """Streaming cumulants for Lindsay's gamma-mixture approximation."""

    def __init__(self, p_components: int = 3):
        self.p = int(p_components)
        self._u = uda.SumCumulants(2 * self.p)

    def init(self, dtype=None, device="cuda") -> CumulantState:
        return CumulantState(self._u.init(1, dtype, device).terms[0])

    def accumulate(self, state, probs, values=None, mask=None):
        st = _run(self._u, uda.CumulantState(state.terms[None]),
                  probs, values, mask)
        return CumulantState(st.terms[0])

    @staticmethod
    def merge(a, b) -> CumulantState:
        return CumulantState(a.terms + b.terms)

    @staticmethod
    def psum_merge(state, ax) -> CumulantState:
        from ..db.distributed import psum
        return CumulantState(psum(state.terms, ax))

    def finalize(self, state) -> approx.GammaMixture:
        return approx.fit_gamma_mixture(approx._host(state.terms), p=self.p)


class NormalState(NamedTuple):
    terms: torch.Tensor  # (2,) = (mean, variance) partial sums


class SumNormal:
    _U = uda.SumNormal()

    @staticmethod
    def init(dtype=None, device="cuda") -> NormalState:
        return NormalState(SumNormal._U.init(1, dtype, device).terms[0])

    @staticmethod
    def accumulate(state, probs, values=None, mask=None) -> NormalState:
        st = _run(SumNormal._U, uda.NormalState(state.terms[None]),
                  probs, values, mask)
        return NormalState(st.terms[0])

    @staticmethod
    def merge(a, b) -> NormalState:
        return NormalState(a.terms + b.terms)

    @staticmethod
    def psum_merge(state, ax) -> NormalState:
        from ..db.distributed import psum
        return NormalState(psum(state.terms, ax))

    @staticmethod
    def finalize(state) -> approx.NormalApprox:
        t = approx._host(state.terms)
        return approx.NormalApprox(float(t[0]),
                                   math.sqrt(max(float(t[1]), 0.0)))


# ------------------------------------------------------------- MIN / MAX
class MinMaxState(NamedTuple):
    values: torch.Tensor    # (kappa,) distinct values, sorted best-first; pad=+inf
    log_none: torch.Tensor  # (kappa,) sum log(1-p) of tuples at that value
    tail_log_none: torch.Tensor   # () log prod(1-p) over *evicted* values
    total_log_none: torch.Tensor  # () log prod(1-p) over all tuples seen


def _lift_minmax(s: MinMaxState) -> uda.MinMaxState:
    return uda.MinMaxState(s.values[None], s.log_none[None],
                           s.tail_log_none[None], s.total_log_none[None])


def _drop_minmax(s: uda.MinMaxState) -> MinMaxState:
    return MinMaxState(s.values[0], s.log_none[0],
                       s.tail_log_none[0], s.total_log_none[0])


@dataclasses.dataclass(frozen=True)
class MinUDA:
    """The paper's ordered (value, AtLeastOne) list with capacity kappa
    (§VII-C); the scalar view of :class:`repro_torch.core.uda.MinMax`.
    ``sign`` = +1 for MIN (keep smallest), -1 for MAX (keep largest, stored
    negated so the merge logic is shared)."""

    kappa: int = 64
    sign: float = 1.0

    @property
    def _u(self) -> uda.MinMax:
        return uda.MinMax(kappa=self.kappa, sign=self.sign)

    def init(self, dtype=None, device="cuda") -> MinMaxState:
        return _drop_minmax(self._u.init(1, dtype, device))

    def accumulate(self, state, probs, values, mask=None) -> MinMaxState:
        dtype = state.values.dtype
        p = uda.masked_probs(probs.to(dtype), mask)
        st = uda.accumulate({"u": self._u}, p, values.to(dtype), None,
                            max_groups=1, states={"u": _lift_minmax(state)})
        return _drop_minmax(st["u"])

    def merge(self, a: MinMaxState, b: MinMaxState) -> MinMaxState:
        return _drop_minmax(self._u.merge(_lift_minmax(a), _lift_minmax(b)))

    def finalize(self, state: MinMaxState):
        """Per-value masses and the beyond-support tail (§V-B.1/.2); see
        :meth:`repro_torch.core.uda.MinMax.finalize`."""
        values, mass, p_tail = self._u.finalize(_lift_minmax(state))
        return values[0], mass[0], p_tail[0]

    def p_empty(self, state: MinMaxState):
        """Exact P(aggregate undefined) = prod over all tuples of (1-p)."""
        return self._u.p_empty(_lift_minmax(state))[0]

    def to_pgf(self, state: MinMaxState, lo: int, hi: int) -> PGF:
        """Densify onto the integer grid [lo, hi); the truncation tail
        becomes the infinity mass."""
        values, mass, p_tail = self.finalize(state)
        k = hi - lo
        finite = torch.isfinite(values)
        idx = torch.clamp((torch.where(finite, values, lo) - lo)
                          .to(torch.int32), 0, k - 1).to(torch.int64)
        coeffs = uda.segment_sum(torch.where(finite, mass, 0.0), idx, k)
        if self.sign > 0:
            return PGF(coeffs, lo, p_pos_inf=p_tail)
        return PGF(coeffs, lo, p_neg_inf=p_tail)


def MaxUDA(kappa: int = 64) -> MinUDA:
    return MinUDA(kappa=kappa, sign=-1.0)
