"""Aggregation monoids (paper §IV-F, Proposition 2; port of
``repro.core.monoids``):

    SUM : (R, +,   0)
    MIN : (R, min, +inf)
    MAX : (R, max, -inf)
    COUNT = SUM after the translation T_COUNT(X^a) = X^1.

The PGF of the monoid-sum is the product of per-tuple PGFs where exponent
addition is the monoid operation (Theorem 1); the neutral element is the
exponent an absent tuple contributes.  Plain metadata, no tensor state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Monoid:
    """An aggregation monoid (R, op, neutral)."""

    name: str
    op: Callable  # binary, elementwise on tensors and on Python floats
    neutral: float

    def fold(self, values):
        """Reference fold of a 1-D sequence in this monoid (host oracle)."""
        acc = self.neutral
        for v in values:
            acc = float(self.op(acc, v))
        return acc


def _elementwise(fn):
    return lambda a, b: fn(torch.as_tensor(a), torch.as_tensor(b))


SUM = Monoid("SUM", lambda a, b: a + b, 0.0)
MIN = Monoid("MIN", _elementwise(torch.minimum), math.inf)
MAX = Monoid("MAX", _elementwise(torch.maximum), -math.inf)
# COUNT is SUM over the translated values T_COUNT(a) = 1 (paper §IV-F step 1).
COUNT = Monoid("COUNT", lambda a, b: a + b, 0.0)

BY_NAME = {m.name: m for m in (SUM, MIN, MAX, COUNT)}


def translate(agg: str, values):
    """T_AGG from paper §IV-F: put tuple values in the aggregate's monoid.

    COUNT maps every value to 1.  SUM after MIN/MAX maps ±inf (the previous
    monoid's neutral) to 0; MIN after MAX maps -inf to +inf and vice versa.
    For plain scalar attributes this is the identity (COUNT aside).
    """
    values = torch.as_tensor(values)
    if agg == "COUNT":
        return torch.ones_like(values)
    target = BY_NAME[agg]
    # Re-map foreign neutral elements onto this monoid's neutral element.
    is_foreign_neutral = torch.isinf(values) & (values != target.neutral)
    return torch.where(is_foreign_neutral,
                       torch.full_like(values, target.neutral), values)
