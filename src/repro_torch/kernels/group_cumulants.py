"""Grouped one-pass cumulant sums (the port of
``repro.kernels.group_cumulants``): the wrapper of
``csrc/group_cumulants.cu`` and its plain PyTorch version.

    s[g, j] = sum_{i : gid_i = g} v_i^j * kappa_j(p_i),   j = 1..orders

Tuples are sorted by group id first (:func:`presort_operands`).
"""
from __future__ import annotations

import torch

from . import build, ref, segments
from .cumulants import check_orders, coefficients

PIECE = 1024            # tuples per piece of a group's sorted range


def presort_operands(probs, values, gids):
    """The argsort(gids) operand prep of :func:`group_cumulant_sums`.
    Returns ``(p_sorted, v_sorted, g_sorted)``."""
    order = torch.argsort(gids, stable=True)
    return (probs[order].contiguous(), values[order].contiguous(),
            gids[order].to(torch.int32).contiguous())


def group_cumulant_sums_plain(probs, values, gids, num_groups: int,
                              orders: int = 8):
    """The plain PyTorch version: (orders, n) rows and a segment sum."""
    return ref.group_cumulants_ref(probs, values, gids, num_groups, orders)


def group_cumulant_sums(probs, values, gids, *, num_groups: int,
                        orders: int = 8, operands=None):
    """Per-group partial cumulant sums, (num_groups, orders).
    ``operands`` (from :func:`presort_operands`) replace probs/values/gids.
    A CUDA tensor launches ``csrc/group_cumulants.cu``; a CPU tensor
    computes :func:`group_cumulant_sums_plain`."""
    check_orders(orders)
    if probs.device.type == "cpu":
        if operands is not None:
            probs, values, gids = operands
        return group_cumulant_sums_plain(probs, values, gids, num_groups,
                                         orders)
    if operands is None:
        operands = presort_operands(probs, values, gids)
    p, v, g = operands
    n = p.shape[0]
    v = v.to(torch.float32).contiguous()
    build.check_operand("group_cumulant_sums probs", p, torch.float32)
    build.check_operand("group_cumulant_sums values", v, torch.float32, n)
    build.check_operand("group_cumulant_sums gids", g, torch.int32, n)
    start, end, first = segments.pieces(
        segments.group_bounds(g, num_groups), PIECE)
    dev = p.device
    part = torch.empty((start.shape[0], orders), dtype=torch.float32,
                       device=dev)
    out = torch.empty((num_groups, orders), dtype=torch.float32, device=dev)
    build.launch("group_cumulant_sums_launch", p.data_ptr(), v.data_ptr(),
                 coefficients(orders, dev).data_ptr(), start.data_ptr(),
                 end.data_ptr(), first.data_ptr(), part.data_ptr(),
                 out.data_ptr(), start.shape[0], num_groups, orders,
                 build.stream_handle(dev))
    group_cumulant_sums.launches += 1
    return out


group_cumulant_sums.launches = 0
