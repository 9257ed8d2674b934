"""Plain PyTorch versions of the five kernels (the port of
``repro.kernels.ref``).

Each function computes exactly what its kernel computes, unblocked: a
whole (frequency, tuple) or (order, tuple) tile and one reduction, or
for the polynomial product a loop over the shorter factor.  The
kernel wrappers use them for CPU tensors, the tests hold them against the
JAX package, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.approx import _bernoulli_cumulant_polys


def _tiny(dtype) -> float:
    """Log-underflow guard."""
    return 1e-30 if dtype == torch.float32 else 1e-300


def _cf_terms(probs, values, k, num_freq):
    """Per-(frequency, tuple) log-abs and angle of (1-p) + p w^{k v} on a
    broadcastable (k, values, probs) grid.

    The phase (k*v) mod N runs in float64, exact for integer values
    pre-reduced mod N (the product stays below 2^53 for any N the kernels
    accept); only the trig epilogue drops to the probs dtype, as the
    kernels' float32 theta does."""
    dtype = probs.dtype
    if not values.is_floating_point():
        values = torch.remainder(values, num_freq)
    phase = torch.remainder(k.to(torch.float64) * values.to(torch.float64),
                            num_freq)
    theta = ((2.0 * math.pi / num_freq) * phase).to(dtype)
    q = 1.0 - probs
    re = q + probs * torch.cos(theta)
    im = probs * torch.sin(theta)
    la = 0.5 * torch.log(torch.clamp(re * re + im * im, min=_tiny(dtype)))
    return la, torch.atan2(im, re)


def logcf_ref(probs, values, num_freq: int, freq_lo: int = 0,
              freq_cnt: int | None = None):
    """Summed log characteristic function of sum_i a_i * Bernoulli(p_i) at
    frequencies [freq_lo, freq_lo + freq_cnt) (default all num_freq):
    (log_abs, angle).  The angle is the sum of per-factor principal
    arguments (branch offsets cancel at exp() time)."""
    f = num_freq - freq_lo if freq_cnt is None else freq_cnt
    k = freq_lo + torch.arange(f, dtype=torch.float64, device=probs.device)
    la, an = _cf_terms(probs[None, :], values[None, :], k[:, None], num_freq)
    return la.sum(-1), an.sum(-1)


def segment_sum(data, ids, num_segments: int):
    """Rows of ``data`` summed per segment id, (num_segments, ...) — an
    unblocked reduction independent of the UDA layer's scatter."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids.long(), data)


def group_logcf_ref(probs, values, gids, num_groups: int, num_freq: int,
                    freq_lo: int = 0, freq_cnt: int | None = None):
    """Grouped summed log CF over frequencies [freq_lo, freq_lo+freq_cnt):
    (log_abs, angle), each (num_groups, freq_cnt)."""
    f = num_freq - freq_lo if freq_cnt is None else freq_cnt
    k = freq_lo + torch.arange(f, dtype=torch.float64, device=probs.device)
    la, an = _cf_terms(probs[:, None], values[:, None], k[None, :], num_freq)
    return (segment_sum(la, gids, num_groups),
            segment_sum(an, gids, num_groups))


def _cumulant_rows(probs, values, orders: int):
    """Per-tuple kappa_j(p_i) and v_i^j rows, j = 1..orders, each
    (orders, n).  deg(kappa_j) = j <= orders, so the table truncates
    exactly at degree ``orders``."""
    dtype = probs.dtype
    table = torch.as_tensor(
        np.asarray(_bernoulli_cumulant_polys())[1:orders + 1, :orders + 1],
        dtype=dtype, device=probs.device)
    powers = probs[None, :] ** torch.arange(orders + 1, dtype=dtype,
                                            device=probs.device)[:, None]
    kappas = table @ powers                      # (orders, n)
    vpow = values[None, :] ** torch.arange(1, orders + 1, dtype=dtype,
                                           device=probs.device)[:, None]
    return kappas, vpow


def cumulants_ref(probs, values, orders: int = 8):
    """Partial cumulant sums s_j = sum_i v_i^j kappa_j(p_i), (orders,)."""
    kappas, vpow = _cumulant_rows(probs, values.to(probs.dtype), orders)
    return torch.sum(kappas * vpow, dim=-1)


def group_cumulants_ref(probs, values, gids, num_groups: int,
                        orders: int = 8):
    """Grouped partial cumulant sums s[g, j], (num_groups, orders)."""
    kappas, vpow = _cumulant_rows(probs, values.to(probs.dtype), orders)
    return segment_sum((kappas * vpow).T, gids, num_groups)


def atleastone_ref(probs, segment_ids, num_segments: int):
    """Per-group 1 - prod(1 - p) (paper Table I row V), as a direct
    product -- independent of the log-domain accumulation in
    ``core/uda.py``."""
    q = torch.ones((num_segments,), dtype=probs.dtype, device=probs.device)
    q = q.scatter_reduce(0, segment_ids, 1.0 - probs, "prod")
    return 1.0 - q


def polymul_ref(a, b):
    """Full linear convolution c[t] = sum_{i+j=t} a[i] b[j] (schoolbook),
    straight from the definition: one shifted axpy per coefficient of the
    shorter factor, in increasing order.  (Not ``conv1d``: cuDNN runs a
    float32 convolution in TF32 by default.)"""
    s, l = (a, b) if a.shape[0] <= b.shape[0] else (b, a)
    c = torch.zeros((a.shape[0] + b.shape[0] - 1,),
                    dtype=torch.result_type(a, b), device=a.device)
    n = l.shape[0]
    for u in range(s.shape[0]):
        c[u:u + n] += s[u] * l
    return c
