"""Dense PGF value type and exact polynomial products (paper §IV-B..D, §V;
port of ``repro.core.pgf``).

A PGF over an integer support grid is stored densely:

    ``coeffs[k] = P(A = offset + k)``            (k = 0..K-1)
    ``p_pos_inf = P(A = +inf)``  (MIN neutral)   ``p_neg_inf = P(A = -inf)``

Products:
  * :meth:`PGF.mul_sum`  — exponent addition = coefficient convolution:
                           schoolbook below FFT_THRESHOLD (the ``polymul``
                           kernel for float32 factors of 128 or more
                           coefficients), else FFT — the paper's §VII-B
                           dispatch.
  * :meth:`PGF.mul_min` / :meth:`PGF.mul_max` — the ×_MIN / ×_MAX products
                           of §V-B via prefix/suffix survival sums, O(K).
  * :func:`product_tree` — the paper's divide-and-conquer product, each tree
                           level one batched FFT over a (B, K) tensor.

The FFT products run in float64 whatever the coefficients' type (see
:func:`_spectrum`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .config import default_float, resolve_device

# Paper §VII-B: "classical O(n^2) method for polynomials of degree smaller
# than [5000] and the O(n log^2 n) algorithm for larger".  The JAX
# package's crossover, kept so both packages take the same branch.
FFT_THRESHOLD = 1024


@dataclasses.dataclass
class PGF:
    """A probability generating function on an integer grid.

    ``coeffs`` is a tensor; ``offset`` a Python int.  Coefficients sum to 1
    together with the two infinity masses (polynomial-monoid membership,
    Proposition 1).
    """

    coeffs: torch.Tensor
    offset: int = 0
    p_pos_inf: torch.Tensor | float = 0.0
    p_neg_inf: torch.Tensor | float = 0.0

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_scalar(cls, value: int, dtype=None, device="cuda"):
        """gamma(a) = X^a — the deterministic embedding (paper §IV-E)."""
        return cls(torch.ones((1,), dtype=dtype or default_float(),
                              device=resolve_device(device)), int(value))

    @classmethod
    def bernoulli(cls, p, value: int, monoid_name: str = "SUM", dtype=None,
                  device="cuda"):
        """(1-p)·X^neutral + p·X^value — one tuple's PGF (paper §IV-F
        step 2)."""
        dtype = dtype or default_float()
        p = torch.as_tensor(p, dtype=dtype, device=resolve_device(device))
        if monoid_name in ("SUM", "COUNT"):
            value = 1 if monoid_name == "COUNT" else int(value)
            lo, hi = min(0, value), max(0, value)
            coeffs = torch.zeros((hi - lo + 1,), dtype=dtype, device=p.device)
            coeffs[0 - lo] += 1 - p
            coeffs[value - lo] += p
            return cls(coeffs, lo)
        if monoid_name == "MIN":   # absent tuple contributes X^{+inf}
            return cls(p.reshape(1), int(value), p_pos_inf=1 - p)
        if monoid_name == "MAX":
            return cls(p.reshape(1), int(value), p_neg_inf=1 - p)
        raise ValueError(monoid_name)

    # -- basic properties ---------------------------------------------------
    @property
    def support(self) -> torch.Tensor:
        return self.offset + torch.arange(self.coeffs.shape[0],
                                          device=self.coeffs.device)

    def total_mass(self):
        return self.coeffs.sum() + self.p_pos_inf + self.p_neg_inf

    def normalize(self) -> "PGF":
        z = self.total_mass()
        return PGF(self.coeffs / z, self.offset, self.p_pos_inf / z,
                   self.p_neg_inf / z)

    def _index(self, value):
        return torch.as_tensor(value, device=self.coeffs.device) - self.offset

    def mass_at(self, value):
        """P(A = value); handles out-of-support gracefully."""
        idx = self._index(value)
        k = self.coeffs.shape[0]
        ok = (idx >= 0) & (idx < k)
        return torch.where(ok, self.coeffs[torch.clamp(idx, 0, k - 1)], 0.0)

    def cdf(self, value):
        """P(A <= value) over the finite support plus -inf mass."""
        idx = self._index(value)
        cum = torch.cumsum(self.coeffs, 0)
        k = self.coeffs.shape[0]
        val = cum[torch.clamp(idx, 0, k - 1)]
        return self.p_neg_inf + torch.where(
            idx < 0, 0.0, torch.where(idx >= k, cum[-1], val))

    def mean(self):
        return torch.sum(self.coeffs * self.support.to(self.coeffs.dtype))

    def variance(self):
        s = self.support.to(self.coeffs.dtype)
        return torch.sum(self.coeffs * (s - self.mean()) ** 2)

    def confidence_interval(self, gamma: float = 0.95):
        """Central interval [lo, hi] with P(lo <= A <= hi) >= gamma (Fig. 5
        ADT)."""
        tail = (1.0 - gamma) / 2.0
        cum = torch.cumsum(self.coeffs, 0)
        q = torch.tensor([tail, 1.0 - tail], dtype=cum.dtype,
                         device=cum.device)
        lo, hi = torch.searchsorted(cum, q)
        return (self.offset + lo,
                self.offset + torch.clamp(hi, max=self.coeffs.shape[0] - 1))

    # -- products (Theorem 1 in each monoid) --------------------------------
    def mul_sum(self, other: "PGF") -> "PGF":
        """PGF of A + B: exponents add => coefficient convolution
        (§V-A/C)."""
        from ..kernels import ops, polymul
        k1, k2 = self.coeffs.shape[0], other.coeffs.shape[0]
        if min(k1, k2) * max(k1, k2) <= FFT_THRESHOLD ** 2 \
                and max(k1, k2) <= FFT_THRESHOLD:          # schoolbook
            a, b = self.coeffs.contiguous(), other.coeffs.contiguous()
            if ops.polymul_eligible(a, b):
                out = polymul.polymul(a, b)
            else:
                out = polymul.polymul_plain(a, b)
        else:
            out = fft_convolve(self.coeffs, other.coeffs)  # paper's FFTW path
        return PGF(out, self.offset + other.offset)

    def _survival(self):
        """P(A >= s_k) including +inf mass, aligned with self.support."""
        rev = torch.flip(torch.cumsum(torch.flip(self.coeffs, (0,)), 0),
                         (0,))
        return rev + self.p_pos_inf

    def _union_grid(self, other: "PGF"):
        lo = min(self.offset, other.offset)
        hi = max(self.offset + self.coeffs.shape[0],
                 other.offset + other.coeffs.shape[0])
        return lo, _embed(self, lo, hi), _embed(other, lo, hi)

    def mul_min(self, other: "PGF") -> "PGF":
        """×_MIN of §V-B: P(min=k) = P(A=k)P(B>=k) + P(A>k)P(B=k), with
        suffix survival sums, O(K) on the union grid."""
        lo, a, b = self._union_grid(other)
        sa, sb = a._survival(), b._survival()
        # P(A > k) = P(A >= k) - P(A = k)
        out = a.coeffs * sb + (sa - a.coeffs) * b.coeffs
        return PGF(out, lo, p_pos_inf=self.p_pos_inf * other.p_pos_inf)

    def mul_max(self, other: "PGF") -> "PGF":
        lo, a, b = self._union_grid(other)
        ca = torch.cumsum(a.coeffs, 0) + a.p_neg_inf     # P(A <= k)
        cb = torch.cumsum(b.coeffs, 0) + b.p_neg_inf
        out = a.coeffs * cb + (ca - a.coeffs) * b.coeffs
        return PGF(out, lo, p_neg_inf=self.p_neg_inf * other.p_neg_inf)

    def mul(self, other: "PGF", monoid_name: str = "SUM") -> "PGF":
        if monoid_name in ("SUM", "COUNT"):
            return self.mul_sum(other)
        if monoid_name == "MIN":
            return self.mul_min(other)
        if monoid_name == "MAX":
            return self.mul_max(other)
        raise ValueError(monoid_name)

    # -- §V-B.2 truncation ---------------------------------------------------
    def truncate_smallest(self, kappa: int) -> "PGF":
        """Keep the kappa smallest support values (MIN approximation
        §V-B.2); the dropped mass is reported as the +inf tail, not
        renormalised."""
        k = min(kappa, self.coeffs.shape[0])
        dropped = self.coeffs[k:].sum()
        return PGF(self.coeffs[:k], self.offset,
                   p_pos_inf=self.p_pos_inf + dropped,
                   p_neg_inf=self.p_neg_inf)

    def stretch(self, factor: int) -> "PGF":
        """Evaluate at X^factor: spread coefficients ``factor`` apart
        (§VII-D), e.g. 0.2z² + 0.3z + 0.5 -> 0.2z⁶ + 0.3z³ + 0.5."""
        factor = int(factor)
        if factor < 0:
            raise ValueError(f"stretch needs a nonnegative factor, got "
                             f"{factor}")
        c = self.coeffs
        if factor == 0:
            return PGF(c.sum().reshape(1), 0, self.p_pos_inf, self.p_neg_inf)
        out = torch.zeros(((c.shape[0] - 1) * factor + 1,), dtype=c.dtype,
                          device=c.device)
        out[::factor] = c
        return PGF(out, self.offset * factor, self.p_pos_inf, self.p_neg_inf)

    def to_numpy(self):
        return (self.coeffs.cpu().numpy(), self.offset, float(self.p_pos_inf),
                float(self.p_neg_inf))


def _embed(f: PGF, lo: int, hi: int) -> PGF:
    """Re-grid a PGF onto [lo, hi)."""
    pad_l = f.offset - lo
    pad_r = (hi - lo) - pad_l - f.coeffs.shape[0]
    return PGF(F.pad(f.coeffs, (pad_l, pad_r)), lo, f.p_pos_inf, f.p_neg_inf)


def _nfft(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def _spectrum(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Real FFT along the last axis, in float64 whatever the input type:
    float32 round-off in the FFT products biases their mass — a product
    tree over 10^8 float32 Bernoulli rows keeps under a fifth of the mass,
    and clipped float32 noise floors swamp the tails — so the products
    round to the input type only at the end."""
    return torch.fft.rfft(x.to(torch.float64), nfft, dim=-1)


def fft_convolve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real FFT linear convolution — the paper's FFTW product."""
    n = a.shape[0] + b.shape[0] - 1
    nfft = _nfft(n)
    out = torch.fft.irfft(_spectrum(a, nfft) * _spectrum(b, nfft), nfft)[:n]
    # Convolutions of probability vectors are nonnegative; clamp FFT noise.
    return torch.clamp(out, min=0.0).to(torch.result_type(a, b))


def convolve_batch(polys: torch.Tensor) -> torch.Tensor:
    """One divide-and-conquer tree level: multiply polys[2i] by
    polys[2i+1].  polys: (B, K) with B even; returns (B//2, 2K-1), as one
    batched FFT."""
    n = 2 * polys.shape[1] - 1
    nfft = _nfft(n)
    f = _spectrum(polys, nfft)
    out = torch.fft.irfft(f[0::2] * f[1::2], nfft, dim=-1)[:, :n]
    return torch.clamp(out, min=0.0).to(polys.dtype)


def product_tree(factors: torch.Tensor,
                 offsets: Sequence[int] | None = None) -> PGF:
    """Exact product of many small PGFs (paper §VII-B 'two by two ... until
    we get a single polynomial').

    factors: (B, K) equal-width coefficient rows.  Rows are multiplied
    pairwise level by level, each level one (B, K) tensor; with an odd row
    count the last row is carried to the next level, zero-padded to the
    merged width — the JAX package's pairing, row for row.  The levels
    run in float64 (see :func:`_spectrum`); the result has the factors'
    type.  Total work O(n log² n).
    """
    offset = 0 if offsets is None else sum(int(o) for o in offsets)
    rows = factors.to(torch.float64)
    while rows.shape[0] > 1:
        carry = None
        if rows.shape[0] % 2 == 1:
            carry, rows = rows[-1], rows[:-1]
        rows = convolve_batch(rows)
        if carry is not None:
            carry = F.pad(carry, (0, rows.shape[1] - carry.shape[0]))
            rows = torch.cat([rows, carry[None]])
    return PGF(rows[0].to(factors.dtype), offset)


def possible_worlds_pgf(probs, values, monoid_name: str = "SUM") -> dict:
    """Brute-force 2^n possible-worlds oracle (Fig. 2 semantics).
    Host-side, n <= ~20.  Returns {outcome: probability} including
    math.inf / -math.inf."""
    from . import monoids as M
    probs = np.asarray(probs, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    m = M.BY_NAME[monoid_name]
    n = len(probs)
    out: dict = {}
    for world in range(1 << n):
        pr, acc = 1.0, m.neutral
        for i in range(n):
            if world >> i & 1:
                pr *= probs[i]
                v = 1.0 if monoid_name == "COUNT" else values[i]
                acc = acc + v if m.name in ("SUM", "COUNT") else (
                    min(acc, v) if m.name == "MIN" else max(acc, v))
            else:
                pr *= 1.0 - probs[i]
        out[acc] = out.get(acc, 0.0) + pr
    return out
