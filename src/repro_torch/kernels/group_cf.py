"""Grouped summed log CF over a frequency window (the port of
``repro.kernels.group_cf``): the wrapper of ``csrc/group_logcf.cu`` and its
plain PyTorch version.

    log_abs[g, f] = sum_{i : gid_i = g} 0.5*log|q_i + p_i w^{k a_i}|^2
    angle[g, f]   = sum_{i : gid_i = g} arg (q_i + p_i w^{k a_i})

with k = freq_lo + f over the window [freq_lo, freq_lo + freq_cnt) of the
N-point grid and the split-modmult phase of :mod:`.pb_cf`.  Tuples are
sorted by group id first (:func:`presort_operands`, hoisted by the planner
above its frequency-slab loop).
"""
from __future__ import annotations

import torch

from . import build, ref, segments
from .pb_cf import phase_shift, split_modmult_operands

PIECE = 1024            # csrc/group_logcf.cu kPiece


def presort_operands(probs, values, gids, num_freq: int):
    """The argsort(gids) + split-modmult operand prep of
    :func:`group_logcf`, run once and reused across frequency slabs.
    Returns ``(p_sorted, a, a2, g_sorted)``."""
    order = torch.argsort(gids, stable=True)
    a, a2, _ = split_modmult_operands(values[order], num_freq)
    return (probs[order].contiguous(), a, a2,
            gids[order].to(torch.int32).contiguous())


def group_logcf_plain(probs, values, gids, num_groups: int, num_freq: int,
                      freq_lo: int = 0, freq_cnt: int | None = None):
    """The plain PyTorch version: one (n, cnt) tile and a segment sum."""
    return ref.group_logcf_ref(probs, values, gids, num_groups, num_freq,
                               freq_lo, freq_cnt)


def group_logcf(probs, values, gids, *, num_groups: int, num_freq: int,
                freq_lo: int = 0, freq_cnt: int | None = None,
                operands=None):
    """Per-group summed log CF: (log_abs, angle), each (num_groups,
    freq_cnt).  ``operands`` (from :func:`presort_operands`) replace
    probs/values/gids.  A CUDA tensor launches ``csrc/group_logcf.cu``; a
    CPU tensor computes :func:`group_logcf_plain`."""
    if freq_cnt is None:
        freq_cnt = num_freq - freq_lo
    if not (0 <= freq_lo and freq_lo + freq_cnt <= num_freq):
        raise ValueError(f"window [{freq_lo}, {freq_lo + freq_cnt}) "
                         f"outside [0, {num_freq})")
    if probs.device.type == "cpu":
        if operands is not None:
            probs, values, _, gids = operands
        return group_logcf_plain(probs, values, gids, num_groups, num_freq,
                                 freq_lo, freq_cnt)
    if operands is None:
        operands = presort_operands(probs, values, gids, num_freq)
    p, a, a2, g = operands
    n = p.shape[0]
    build.check_operand("group_logcf probs", p, torch.float32)
    for name, t in (("a", a), ("a2", a2), ("gids", g)):
        build.check_operand(f"group_logcf {name}", t, torch.int32, n)
    start, end, first = segments.pieces(g, num_groups, PIECE)
    dev = p.device
    part = torch.empty((2, start.shape[0], freq_cnt), dtype=torch.float32,
                       device=dev)
    out = torch.empty((2, num_groups, freq_cnt), dtype=torch.float32,
                      device=dev)
    build.launch("group_logcf_launch", p.data_ptr(), a.data_ptr(),
                 a2.data_ptr(), start.data_ptr(), end.data_ptr(),
                 first.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), start.shape[0],
                 num_groups, num_freq, phase_shift(num_freq), freq_lo,
                 freq_cnt, build.stream_handle(dev))
    group_logcf.launches += 1
    return out[0], out[1]


group_logcf.launches = 0
