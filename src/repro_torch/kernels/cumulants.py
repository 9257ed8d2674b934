"""Scalar one-pass cumulant sums (the port of ``repro.kernels.cumulants``):
the wrapper of ``csrc/cumulants.cu`` and its plain PyTorch version.

    s_j = sum_i v_i^j * kappa_j(p_i),      j = 1..orders  (orders <= 12)

with kappa_j the Bernoulli cumulant polynomials of
:func:`repro_torch.core.approx._bernoulli_cumulant_polys`.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.approx import MAX_ORDER, _bernoulli_cumulant_polys
from . import build, ref

TILE = 1024             # csrc/cumulants.cu kTile


@lru_cache(maxsize=None)
def coefficients(orders: int, device: torch.device):
    """The (orders, orders + 1) float32 coefficient table on ``device``
    (deg kappa_j = j <= orders, so the table truncates exactly there)."""
    table = np.asarray(_bernoulli_cumulant_polys()[1:orders + 1,
                                                   :orders + 1], np.float32)
    return torch.as_tensor(table, device=device).contiguous()


def check_orders(orders: int) -> None:
    if not 1 <= orders <= MAX_ORDER:
        raise ValueError(f"orders must be in [1, {MAX_ORDER}], got {orders}")


def cumulant_sums_plain(probs, values, orders: int = 8):
    """The plain PyTorch version: (orders, n) rows and one sum."""
    return ref.cumulants_ref(probs, values, orders)


def cumulant_sums(probs, values, *, orders: int = 8):
    """One-pass partial cumulant sums, (orders,).  A CUDA tensor launches
    ``csrc/cumulants.cu``; a CPU tensor computes
    :func:`cumulant_sums_plain`."""
    check_orders(orders)
    if probs.device.type == "cpu":
        return cumulant_sums_plain(probs, values, orders)
    n = probs.shape[0]
    v = values.to(torch.float32).contiguous()
    build.check_operand("cumulant_sums probs", probs, torch.float32)
    build.check_operand("cumulant_sums values", v, torch.float32, n)
    dev = probs.device
    blocks = max(1, -(-n // TILE))
    part = torch.empty((blocks, orders), dtype=torch.float32, device=dev)
    out = torch.empty((orders,), dtype=torch.float32, device=dev)
    build.launch("cumulant_sums_launch", probs.data_ptr(), v.data_ptr(),
                 coefficients(orders, dev).data_ptr(), part.data_ptr(),
                 out.data_ptr(), n, orders, build.stream_handle(dev))
    cumulant_sums.launches += 1
    return out


cumulant_sums.launches = 0
