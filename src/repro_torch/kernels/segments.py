"""The piece table of the grouped kernels (``csrc/group_logcf.cu``,
``csrc/group_cumulants.cu``).

Tuples sorted by group id form one contiguous range per group; every range
is cut into pieces of at most ``max_len`` tuples.  A kernel block reduces
one piece into a partial row, and a second pass adds each group's pieces
in order, so the work is the tuple count whatever the group skew.
"""
from __future__ import annotations

import torch


def pieces(g_sorted, num_groups: int, max_len: int):
    """(piece_start, piece_end, group_first) as int32 tensors on the
    device of ``g_sorted``: piece r covers sorted tuples [start[r], end[r])
    and group g owns pieces [group_first[g], group_first[g + 1])."""
    dev = g_sorted.device
    bounds = torch.searchsorted(
        g_sorted, torch.arange(num_groups + 1, dtype=g_sorted.dtype,
                               device=dev))
    counts = bounds[1:] - bounds[:-1]
    npieces = (counts + max_len - 1) // max_len
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
