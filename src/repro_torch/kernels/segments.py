"""The group tables of the grouped kernels (``csrc/group_logcf.cu``,
``csrc/group_cumulants.cu``).

Tuples sorted by group id form one contiguous range per group
(:func:`group_bounds`).  :func:`pieces` cuts ranges into pieces of at most
``max_len`` tuples; a kernel block reduces one piece into a partial row,
and a second pass adds each group's pieces in order, so the work is the
tuple count whatever the group skew.  With ``short_max`` the groups of at
most that many tuples get no piece: the grouped kernels sum them directly
in their output pass.

:func:`pieces` counts the pieces on the host (one sync).  The grouped
cumulant kernel needs no count: :func:`slot_pieces` is its table, written
in PyTorch for the CPU tests.
"""
from __future__ import annotations

import torch


def group_bounds(g_sorted, num_groups: int):
    """bounds[g] = first sorted tuple of group g, bounds[num_groups] = n."""
    return torch.searchsorted(
        g_sorted, torch.arange(num_groups + 1, dtype=g_sorted.dtype,
                               device=g_sorted.device))


def pieces(bounds, max_len: int, short_max: int = 0):
    """(piece_start, piece_end, group_first) as int32 tensors on the
    device of ``bounds`` (from :func:`group_bounds`): piece r covers sorted
    tuples [start[r], end[r]) and group g owns pieces [group_first[g],
    group_first[g + 1]) -- none when the group has at most ``short_max``
    tuples.  Reads the piece count back to the host (one sync)."""
    dev = bounds.device
    num_groups = bounds.shape[0] - 1
    bounds = bounds.to(torch.int64)
    counts = bounds[1:] - bounds[:-1]
    npieces = torch.where(counts > short_max,
                          (counts + max_len - 1) // max_len,
                          torch.zeros_like(counts))
    first = torch.zeros(num_groups + 1, dtype=torch.int64, device=dev)
    torch.cumsum(npieces, 0, out=first[1:])
    total = int(first[-1])
    owner = torch.repeat_interleave(
        torch.arange(num_groups, device=dev), npieces, output_size=total)
    j = torch.arange(total, device=dev) - first[owner]
    start = bounds[owner] + j * max_len
    end = torch.minimum(start + max_len, bounds[owner + 1])
    return (start.to(torch.int32).contiguous(),
            end.to(torch.int32).contiguous(),
            first.to(torch.int32).contiguous())


def slot_pieces(g_sorted, bounds, max_len: int, short_max: int):
    """(start, end) of each piece slot s < n // (short_max + 1), as
    ``csrc/group_cumulants.cu`` finds them on the device, with no count and
    no scan: piece j of a group of more than ``short_max`` tuples starting
    at sorted tuple lo sits in slot lo // (short_max + 1) + j, and the
    owner of slot s is the group of tuple (short_max + 1) * s + short_max.
    A slot that no piece owns has start = end = 0.  Listed in slot order,
    the live slots are :func:`pieces` in order."""
    span = short_max + 1
    slots = g_sorted.shape[0] // span
    s = torch.arange(slots, device=g_sorted.device)
    g = g_sorted[s * span + short_max].long()
    bounds = bounds.long()
    lo, hi = bounds[g], bounds[g + 1]
    j = s - lo // span
    npieces = torch.where(hi - lo > short_max,
                          (hi - lo + max_len - 1) // max_len,
                          torch.zeros_like(lo))
    live = (j >= 0) & (j < npieces)
    start = torch.where(live, lo + j * max_len, torch.zeros_like(lo))
    end = torch.where(live, torch.minimum(start + max_len, hi), start)
    return start, end
