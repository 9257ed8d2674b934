"""Grouped summed log CF over a frequency window (the port of
``repro.kernels.group_cf``): the wrapper of ``csrc/group_logcf.cu`` and its
plain PyTorch version.

    log_abs[g, f] = sum_{i : gid_i = g} 0.5*log|q_i + p_i w^{k a_i}|^2
    angle[g, f]   = sum_{i : gid_i = g} arg (q_i + p_i w^{k a_i})

with k = freq_lo + f over the window [freq_lo, freq_lo + freq_cnt) of the
N-point grid and the exact phase of :mod:`.pb_cf`.  Tuples are sorted by
group id first, and the group bounds and the piece table of the long
groups built with them (:func:`presort_operands`, hoisted by the planner
above its frequency-slab loop).
"""
from __future__ import annotations

import torch

from ..core.config import on_card
from . import build, ref, segments
from .pb_cf import (OPS_PER_PAIR, barrett_magic, phase_shift,
                    split_modmult_operands)

PIECE = 1024            # tuples per piece of a long group
#: groups of at most this many tuples are summed directly in the kernel's
#: output pass; longer ones go through pieces of at most PIECE tuples.
SHORT_MAX = 32


def presort_operands(probs, values, gids, num_freq: int, num_groups: int):
    """The argsort(gids), phase-operand and group-table prep of
    :func:`group_logcf`, run once and reused across frequency slabs.
    Returns ``(p_sorted, a, a2, g_sorted, bounds, piece_first,
    piece_start, piece_end)`` (one host sync, for the piece count)."""
    order = torch.argsort(gids, stable=True)
    a, a2, _ = split_modmult_operands(values[order], num_freq)
    g = gids[order].to(torch.int32).contiguous()
    bounds = segments.group_bounds(g, num_groups)
    start, end, first = segments.pieces(bounds, PIECE, SHORT_MAX)
    return (probs[order].contiguous(), a, a2, g,
            bounds.to(torch.int32).contiguous(), first, start, end)


def cost(n: int, num_groups: int, freq_cnt: int) -> tuple:
    """(float operations, bytes) of one launch at its bound: every tuple
    at every frequency of the window; probs, a and gids read once, the
    (num_groups, freq_cnt) rows written once."""
    return (n * freq_cnt * OPS_PER_PAIR,
            n * 12 + 2 * num_groups * freq_cnt * 4)


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
    if operands is not None:
        probs, values, _, gids = operands[:4]
    if probs.device.type == "cpu" and not on_card(probs):
        return group_logcf_plain(probs, values, gids, num_groups, num_freq,
                                 freq_lo, freq_cnt)
    if num_groups * freq_cnt and build.faked(
            probs, "group_logcf",
            *cost(probs.shape[0], num_groups, freq_cnt)):
        # the presort's piece table needs the data: the dry-run records
        # the launch and its outputs only
        out = torch.empty((2, num_groups, freq_cnt), dtype=torch.float32,
                          device=probs.device)
        group_logcf.launches += 1
        return out[0], out[1]
    if operands is None:
        operands = presort_operands(probs, values, gids, num_freq,
                                    num_groups)
    p, a, a2, g, bounds, first, start, end = operands
    n = p.shape[0]
    build.check_operand("group_logcf probs", p, torch.float32)
    for name, t in (("a", a), ("a2", a2), ("gids", g)):
        build.check_operand(f"group_logcf {name}", t, torch.int32, n)
    for name, t in (("bounds", bounds), ("piece_first", first)):
        build.check_operand(f"group_logcf {name}", t, torch.int32,
                            num_groups + 1)
    dev = p.device
    n_pieces = start.shape[0]
    # one allocation: the twiddle table (N float2), then the piece rows
    buf = torch.empty((2 * num_freq + 2 * n_pieces * freq_cnt,),
                      dtype=torch.float32, device=dev)
    part = buf[2 * num_freq:].view(2, n_pieces, freq_cnt)
    out = torch.empty((2, num_groups, freq_cnt), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:            # nothing to launch
        return out[0], out[1]
    build.launch("group_logcf_launch", p.data_ptr(), a.data_ptr(),
                 a2.data_ptr(), bounds.data_ptr(), first.data_ptr(),
                 start.data_ptr(), end.data_ptr(), buf.data_ptr(),
                 part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), n_pieces, num_groups, num_freq,
                 phase_shift(num_freq), barrett_magic(num_freq), SHORT_MAX,
                 freq_lo, freq_cnt, build.stream_handle(dev))
    group_logcf.launches += 1
    return out[0], out[1]


group_logcf.launches = 0
