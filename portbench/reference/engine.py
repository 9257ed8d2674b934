"""A plain relational engine for the reference: tuple-independent tables
as dicts of tensors, and the aggregates of the paper computed directly.

It imports nothing of the program.  A table is ``{"columns": {name:
tensor}, "prob": tensor, "valid": tensor}``; every operator returns a new
one.  Semantics (the paper's Table I):

* selection keeps p and clears ``valid`` where the condition fails;
* a many-to-one join looks each probe key up in the build side (keys
  unique among valid build rows), p = p_probe * p_build, a miss is
  invalid;
* GROUP BY assigns the ``max_groups`` lexicographically smallest live key
  tuples to slots 0, 1, ... in order (rows of later tuples are lost);
* per group: confidence 1 - prod(1 - p); SUM's (mean, variance)
  (sum v p, sum v^2 p (1 - p)); cumulant sums sum v^j kappa_j(p); the
  exact distribution of SUM mod N.

``dt`` is the precision the aggregates accumulate in: float64 for the
reference, bfloat16 for the control (whose finalisation then runs in
float32).  Each aggregate also returns the scale its rounding is judged
against, in float64: the sum of the absolute values of its terms.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

#: key packing of GROUP BY: each later key below 2**20
_KEY_BITS = 20


def table(columns: dict, prob, valid) -> dict:
    return {"columns": dict(columns), "prob": prob, "valid": valid}


def select(t: dict, mask) -> dict:
    return table(t["columns"], t["prob"], t["valid"] & mask)


def fk_join(left: dict, lkey: str, right: dict, rkey: str,
            cols=()) -> dict:
    """Many-to-one join through a dense key -> row map of the build side."""
    lk, rk = left["columns"][lkey], right["columns"][rkey]
    size = int(max(int(lk.max()), int(rk.max()))) + 1
    where = torch.full((size,), -1, dtype=torch.int64, device=lk.device)
    rows = torch.arange(rk.shape[0], device=lk.device)
    where[rk[right["valid"]]] = rows[right["valid"]]
    pos = where[lk]
    hit = left["valid"] & (pos >= 0)
    pos = pos.clamp(min=0)
    out = dict(left["columns"])
    for c in cols:
        out[c] = torch.where(hit, right["columns"][c][pos], 0)
    prob = torch.where(hit, left["prob"] * right["prob"][pos], 0.0)
    return table(out, prob, hit)


def group(t: dict, keys, max_groups: int) -> dict:
    """Slots of GROUP BY ``keys``: ``gid`` of each row (-1: dead or
    lost), ``n`` groups, ``valid`` (max_groups,), each key's value a
    slot, and ``lost`` live rows past ``max_groups``."""
    dev = t["valid"].device
    code = torch.zeros(t["valid"].shape, dtype=torch.int64, device=dev)
    for k in keys:
        code = (code << _KEY_BITS) + t["columns"][k]
    live = t["valid"]
    kept = torch.unique(code[live], sorted=True)[:max_groups]
    n = int(kept.shape[0])
    pos = torch.searchsorted(kept, code).clamp(max=max(n - 1, 0))
    found = live & (kept[pos] == code) if n else torch.zeros_like(live)
    gid = torch.where(found, pos, -1)
    valid = torch.zeros((max_groups,), dtype=torch.bool, device=dev)
    valid[:n] = True
    keyvals = {}
    for k in keys:
        col = t["columns"][k]
        kv = torch.zeros((max_groups,), dtype=col.dtype, device=dev)
        kv[gid[found]] = col[found]
        keyvals[k] = kv
    return dict(gid=gid, n=n, valid=valid, keys=keyvals,
                lost=int((live & ~found).sum()))


def _seg(values, gid, groups: int):
    """Per-group sums of ``values`` (rows with gid -1 dropped)."""
    ok = gid >= 0
    out = torch.zeros((groups,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, gid[ok], values[ok])


def confidence(p, gid, groups: int, dt):
    """1 - prod(1 - p) a group, through the sum of log(1 - p)."""
    fin = fin_dtype(dt)
    s = _seg(torch.log1p(-p.to(dt)), gid, groups)
    return 1.0 - torch.exp(s.to(fin))


def normal(p, v, gid, groups: int, dt) -> tuple:
    """((mean, variance), (their scales))."""
    p, v = p.to(dt), v.to(dt)
    mu = _seg(v * p, gid, groups)
    var = _seg(v * v * p * (1 - p), gid, groups)
    p64, v64 = p.double(), v.double()
    smu = _seg(v64.abs() * p64, gid, groups)
    svar = _seg(v64 * v64 * p64 * (1 - p64), gid, groups)
    return (mu, var), (smu, svar)


@lru_cache(maxsize=None)
def _kappa_table(orders: int) -> np.ndarray:
    """C[j - 1, d]: kappa_j(p) = sum_d C[j - 1, d] p^d, j = 1..orders (the
    Bernoulli cumulants: kappa_1 = p, kappa_{j+1} = p (1 - p) kappa_j')."""
    table = np.zeros((orders + 1, orders + 1))
    table[1, 1] = 1.0
    for j in range(1, orders):
        nxt = np.polynomial.polynomial.polymul(
            np.polynomial.polynomial.polyder(table[j]), [0.0, 1.0, -1.0])
        table[j + 1, :len(nxt)] = nxt[:orders + 1]
    return table[1:]


def cumulants(p, v, gid, groups: int, dt, orders: int = 8,
              block: int = 1 << 22) -> tuple:
    """(cumulant sums (groups, orders), their scales
    sum |v|^j sum_d |C_jd| p^d)."""
    dev = p.device
    c = torch.as_tensor(_kappa_table(orders), device=dev)
    out = torch.zeros((groups, orders), dtype=dt, device=dev)
    scale = torch.zeros((groups, orders), dtype=torch.float64, device=dev)
    jj = torch.arange(orders + 1, device=dev, dtype=torch.float64)
    for lo in range(0, p.shape[0], block):
        sl = slice(lo, lo + block)
        g = gid[sl]
        pw = p[sl].double()[:, None] ** jj[None, :]          # (n, O + 1)
        vp = v[sl].double()[:, None] ** jj[None, 1:]         # (n, O)
        if dt == torch.float64:
            terms = (pw @ c.T) * vp
        else:
            terms = (pw.to(dt) @ c.T.to(dt)) * vp.to(dt)
        out += _seg(terms, g, groups)
        scale += _seg((pw @ c.abs().T) * vp.abs(), g, groups)
    return out, scale


def scalar_cf_coeffs(p, v, num_freq: int, dt, block: int = 4096):
    """The distribution of SUM(v) mod N over all live rows (one group):
    the log characteristic function summed over the tuples at k <= N/2,
    mirrored, then one FFT; negative round-off clamped to 0."""
    dev = p.device
    live = p > 0
    p, v = p[live], v[live].to(torch.int64)
    half = num_freq // 2 + 1
    k = torch.arange(half, device=dev, dtype=torch.int64)
    la = torch.zeros((half,), dtype=dt, device=dev)
    an = torch.zeros((half,), dtype=dt, device=dev)
    for lo in range(0, p.shape[0], block):
        pb = p[lo:lo + block].to(dt)[:, None]
        phase = torch.remainder(v[lo:lo + block, None] * k[None, :],
                                num_freq)
        theta = (2 * math.pi / num_freq) * phase.to(dt)
        re = 1 - pb + pb * torch.cos(theta)
        im = pb * torch.sin(theta)
        la += (0.5 * torch.log(re * re + im * im)).sum(0)
        an += torch.atan2(im, re).sum(0)
    fin = fin_dtype(dt)
    la, an = la.to(fin), an.to(fin)
    la = torch.cat([la, la[1:num_freq - half + 1].flip(0)])
    an = torch.cat([an, -an[1:num_freq - half + 1].flip(0)])
    q = torch.polar(torch.exp(la), an)
    return torch.clamp(torch.fft.fft(q).real / num_freq, min=0.0)


def grouped_distribution(p, v, gid, slots, num_freq: int, dt):
    """The distribution of SUM(v) mod N of each group in ``slots``
    (len(slots), N): each row's Bernoulli(p) term convolved in, row by
    row within its group (no transform)."""
    dev = p.device
    m = slots.shape[0]
    where = torch.full((int(gid.max()) + 2,), -1, dtype=torch.int64,
                       device=dev)
    where[slots] = torch.arange(m, device=dev)
    row_slot = torch.where(gid >= 0, where[gid.clamp(min=0)], -1)
    rows = torch.nonzero(row_slot >= 0).squeeze(1)
    s = row_slot[rows]
    order = torch.argsort(s, stable=True)
    rows, s = rows[order], s[order]
    start = torch.searchsorted(s, s)                      # first row of s
    rank = torch.arange(s.shape[0], device=dev) - start
    dist = torch.zeros((m, num_freq), dtype=dt, device=dev)
    dist[:, 0] = 1
    ar = torch.arange(num_freq, device=dev)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        at = rank == r
        g, pr = s[at], p[rows[at]].to(dt)[:, None]
        shift = torch.remainder(v[rows[at]].to(torch.int64), num_freq)
        d = dist[g]
        moved = d.gather(1, torch.remainder(ar[None, :] - shift[:, None],
                                            num_freq))
        dist[g] = (1 - pr) * d + pr * moved
    return dist.to(fin_dtype(dt))


def normal_greater(mu, var, thr):
    """P(N(mu, var) > thr)."""
    sigma = torch.sqrt(torch.clamp(var, min=1e-30))
    return 0.5 * torch.special.erfc((thr - mu) / sigma / math.sqrt(2.0))


def fin_dtype(dt):
    """Where transcendental finalisation runs: float64, or float32 for a
    lower-precision state."""
    return torch.float64 if dt == torch.float64 else torch.float32
