"""Scalar summed log CF (the port of ``repro.kernels.pb_cf``): the wrapper
of the CUDA kernel ``csrc/logcf.cu`` and its plain PyTorch version.

For the Poisson-binomial product Q(X) = prod_i (q_i + p_i X^{a_i}):

    log_abs[k] = sum_i 0.5*log|q_i + p_i w^{k a_i}|^2
    angle[k]   = sum_i arg (q_i + p_i w^{k a_i}),     w = exp(2 pi i / N)

for every DFT frequency k < N.  The phase (k*a) mod N is integer-exact
through the split-modmult: k = k_hi*2^S + k_lo and a2 = (a << S) mod N,
so k_hi*a2 + k_lo*a < 2^32 for N <= 2^20, and one Barrett step with
:func:`barrett_magic` reduces it mod N on the card (``csrc/cf.cuh``).
The kernel computes k <= N/2 only and mirrors the rest (conjugate
symmetry: log_abs[N-k] = log_abs[k], angle[N-k] = -angle[k]), and so does
the plain version.  A window of those N/2 + 1 frequencies (a model rank's
share) gives each frequency the bits of the whole call; :func:`mirror`
completes the gathered half.
"""
from __future__ import annotations

import torch

from ..core.config import on_card
from . import build, ref

#: tuple splits are sized so about this many (split, frequency block) work
#: items share the resident blocks: several per block, so the items of the
#: last frequency block (one frequency at N = 4096) and the data-dependent
#: ones balance out.
TARGET_ITEMS = 4096
#: fewest tuples per split: a small column (the value layer's 400- and
#: 1,000-tuple COUNTs) still spreads over tens of blocks.
MIN_SPLIT = 32
FREQ_THREADS = 256      # csrc/cf.cuh kCfThreads
#: largest N whose twiddle table logcf copies into shared memory (32 KB);
#: above it the kernel reads the table from device memory (csrc/cf.cuh).
DIRECT_TABLE_MAX = 4096
#: float operations a (tuple, frequency) pair costs (the bound's count:
#: re = q + p cos, im = p sin, |.|^2, the clamp, log, atan2 and the two
#: accumulating adds; a transcendental counts one).
OPS_PER_PAIR = 11


def cost(n: int, num_freq: int, freq_cnt: int | None = None) -> tuple:
    """(float operations, bytes) of one launch at its bound: every tuple
    live at the N/2 + 1 computed frequencies (or the window's
    ``freq_cnt``); probs and values read once, the two output rows
    written once."""
    _, cnt, whole = _window(num_freq, 0, freq_cnt)
    return n * cnt * OPS_PER_PAIR, n * 8 + 2 * (num_freq if whole else cnt) * 4


def phase_shift(num_freq: int) -> int:
    """The split-modmult shift S for an N-point grid."""
    return max(1, (num_freq - 1).bit_length() // 2 + 1)


def barrett_magic(num_freq: int) -> int:
    """floor(2^32 / N), the kernels' reciprocal for x mod N with x < 2^32
    (0 for N = 1, whose phase is always 0)."""
    return (1 << 32) // num_freq if num_freq > 1 else 0


def reduced_values(values, num_freq: int):
    """a = values mod N as int32: reduced in the SOURCE integer dtype first
    (a 64-bit value narrowed first would wrap mod 2^32)."""
    n = num_freq
    if n > 1 << 20:
        raise ValueError(f"num_freq {n} > 2^20 overflows the exact phase")
    v = values
    if not v.is_floating_point():
        return torch.remainder(v, n).to(torch.int32).contiguous()
    return torch.remainder(v.to(torch.int32), n).contiguous()


def split_modmult_operands(values, num_freq: int):
    """Exact int32 phase operands of the CF kernels: a = values mod N
    (:func:`reduced_values`) and a2 = (a << S) mod N, computed in int64.
    Returns (a, a2, shift)."""
    a = reduced_values(values, num_freq)
    shift = phase_shift(num_freq)
    a2 = torch.remainder(a.to(torch.int64) << shift, num_freq)
    return a, a2.to(torch.int32).contiguous(), shift


def mirror(la, an, num_freq: int):
    """The N-point grid (last axis) from its N/2 + 1 columns k <= N/2:
    la[N-k] = la[k] and an[N-k] = -an[k]."""
    tail = slice(1, num_freq - la.shape[-1] + 1)
    return (torch.cat([la, la[..., tail].flip(-1)], -1),
            torch.cat([an, -an[..., tail].flip(-1)], -1))


def _window(num_freq: int, freq_lo: int, freq_cnt: int | None) -> tuple:
    """(lo, cnt, whole) of a window of the k <= N/2 frequencies; None is
    all of them, mirrored to the N-point grid."""
    half = num_freq // 2 + 1
    if freq_cnt is None:
        return 0, half, True
    if freq_lo < 0 or freq_cnt < 1 or freq_lo + freq_cnt > half:
        raise ValueError(f"logcf window [{freq_lo}, {freq_lo + freq_cnt}) "
                         f"is not inside [0, {half})")
    return freq_lo, freq_cnt, False


def logcf_plain(probs, values, num_freq: int, freq_lo: int = 0,
                freq_cnt: int | None = None):
    """The plain PyTorch version: one (K, n) tile over the kernel's
    frequencies and one sum, mirrored as the kernel mirrors."""
    lo, cnt, whole = _window(num_freq, freq_lo, freq_cnt)
    la, an = ref.logcf_ref(probs, values, num_freq, lo, cnt)
    return mirror(la, an, num_freq) if whole else (la, an)


def splits_for(n: int, num_freq: int) -> int:
    """Tuple splits of one launch over the N/2 + 1 computed frequencies:
    about TARGET_ITEMS work items, never fewer than MIN_SPLIT tuples per
    split."""
    fblocks = -(-(num_freq // 2 + 1) // FREQ_THREADS)
    return max(1, min(-(-n // MIN_SPLIT), -(-TARGET_ITEMS // fblocks)))


def logcf(probs, values, *, num_freq: int, freq_lo: int = 0,
          freq_cnt: int | None = None):
    """Summed log CF at ``num_freq`` frequencies: (log_abs, angle), each
    (num_freq,); with ``freq_cnt`` only the window [freq_lo, freq_lo +
    freq_cnt) of the k <= N/2 frequencies, each (freq_cnt,), unmirrored.
    A CUDA tensor launches ``csrc/logcf.cu``; a CPU tensor computes
    :func:`logcf_plain`."""
    if probs.device.type == "cpu" and not on_card(probs):
        return logcf_plain(probs, values, num_freq, freq_lo, freq_cnt)
    fake = build.faked(probs, "logcf",
                       *cost(probs.shape[0], num_freq, freq_cnt))
    lo, cnt, whole = _window(num_freq, freq_lo, freq_cnt)
    n = probs.shape[0]
    build.check_operand("logcf probs", probs, torch.float32)
    a, a2, shift = split_modmult_operands(values, num_freq)
    build.check_operand("logcf values", a, torch.int32, n)
    splits = splits_for(n, num_freq)
    dev = probs.device
    # one allocation: the twiddle table (N float2), then the partial rows
    buf = torch.empty((2 * num_freq + 2 * splits * cnt,),
                      dtype=torch.float32, device=dev)
    part = buf[2 * num_freq:].view(2, splits, cnt)
    out = torch.empty((2, num_freq if whole else cnt), dtype=torch.float32,
                      device=dev)
    if not fake:
        build.launch("logcf_launch", probs.data_ptr(), a.data_ptr(),
                     a2.data_ptr(), buf.data_ptr(), part[0].data_ptr(),
                     part[1].data_ptr(), out[0].data_ptr(),
                     out[1].data_ptr(), n, num_freq, shift,
                     barrett_magic(num_freq),
                     int(num_freq <= DIRECT_TABLE_MAX), splits, lo, cnt,
                     build.stream_handle(dev))
    logcf.launches += 1
    return out[0], out[1]


logcf.launches = 0
