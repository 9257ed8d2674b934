"""Scalar summed log CF (the port of ``repro.kernels.pb_cf``): the wrapper
of the CUDA kernel ``csrc/logcf.cu`` and its plain PyTorch version.

For the Poisson-binomial product Q(X) = prod_i (q_i + p_i X^{a_i}):

    log_abs[k] = sum_i 0.5*log|q_i + p_i w^{k a_i}|^2
    angle[k]   = sum_i arg (q_i + p_i w^{k a_i}),     w = exp(2 pi i / N)

for every DFT frequency k < N.  The phase (k*a) mod N is integer-exact
through the int32 split-modmult: k = k_hi*2^S + k_lo and a2 = (a << S)
mod N, so (k*a) mod N = ((k_hi*a2) mod N + (k_lo*a) mod N) mod N with both
products below 2^31 for N <= 2^20.
"""
from __future__ import annotations

import torch

from . import build, ref

#: tuple splits are sized so about this many blocks fill the card.
TARGET_BLOCKS = 2048
FREQ_THREADS = 256      # csrc/logcf.cu kFreqThreads
TUPLE_TILE = 1024       # csrc/logcf.cu kTupleTile


def phase_shift(num_freq: int) -> int:
    """The split-modmult shift S for an N-point grid."""
    return max(1, (num_freq - 1).bit_length() // 2 + 1)


def split_modmult_operands(values, num_freq: int):
    """Exact int32 phase operands shared by the CF kernels: reduce
    ``values`` mod N in the SOURCE integer dtype (a 64-bit value narrowed
    first would wrap mod 2^32), narrow to int32, and build a2 = (a << S)
    mod N by repeated doubling (every intermediate < 2N).  Returns
    (a, a2, shift)."""
    n = num_freq
    if n > 1 << 20:
        raise ValueError(f"num_freq {n} > 2^20 overflows the exact phase")
    shift = phase_shift(n)
    v = values
    if not v.is_floating_point():
        v = torch.remainder(v, n)
    a = torch.remainder(v.to(torch.int32), n)
    a2 = a
    for _ in range(shift):
        a2 = torch.remainder(a2 * 2, n)
    return a.contiguous(), a2.contiguous(), shift


def logcf_plain(probs, values, num_freq: int):
    """The plain PyTorch version: one (N, n) tile and one sum."""
    return ref.logcf_ref(probs, values, num_freq)


def splits_for(n: int, num_freq: int) -> int:
    """Tuple splits of one launch: enough blocks to fill the card, never
    fewer than one tuple tile per split."""
    fblocks = -(-num_freq // FREQ_THREADS)
    return max(1, min(-(-n // TUPLE_TILE), -(-TARGET_BLOCKS // fblocks)))


def logcf(probs, values, *, num_freq: int):
    """Summed log CF at ``num_freq`` frequencies: (log_abs, angle), each
    (num_freq,).  A CUDA tensor launches ``csrc/logcf.cu``; a CPU tensor
    computes :func:`logcf_plain`."""
    if probs.device.type == "cpu":
        return logcf_plain(probs, values, num_freq)
    n = probs.shape[0]
    build.check_operand("logcf probs", probs, torch.float32)
    a, a2, shift = split_modmult_operands(values, num_freq)
    build.check_operand("logcf values", a, torch.int32, n)
    splits = splits_for(n, num_freq)
    dev = probs.device
    part = torch.empty((2, splits, num_freq), dtype=torch.float32, device=dev)
    out = torch.empty((2, num_freq), dtype=torch.float32, device=dev)
    build.launch("logcf_launch", probs.data_ptr(), a.data_ptr(),
                 a2.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), n, num_freq, shift,
                 splits, build.stream_handle(dev))
    logcf.launches += 1
    return out[0], out[1]


logcf.launches = 0
