"""Grouped one-pass cumulant sums (the port of
``repro.kernels.group_cumulants``): the wrapper of its two CUDA routes and
its plain PyTorch version.

    s[g, j] = sum_{i : gid_i = g} v_i^j * kappa_j(p_i),   j = 1..orders

The route is chosen by ``num_groups`` alone:

* (a) at most :data:`NO_SORT_MAX` groups: ``csrc/cumulants.cu`` streams the
  unsorted column and adds every tuple into per-group register
  accumulators -- no sort, no gathers, no group table;
* (b) more groups: the tuples are sorted by group id (stable,
  :func:`presort_operands`) and ``csrc/group_cumulants.cu`` sums short
  groups directly and long ones through fixed piece slots
  (:func:`.segments.slot_pieces`), with no host sync.
"""
from __future__ import annotations

import torch

from ..core.config import on_card
from . import build, ref
from .cumulants import check_orders, launch_tiles, ops_per_tuple

#: route (a) up to this many groups (csrc/cumulants.cu kMaxTileGroups).
NO_SORT_MAX = 8
#: route (b): a group of at most SHORT_MAX tuples is summed directly by the
#: thread that writes it; a longer one in pieces of at most PIECE tuples,
#: its piece j in slot first // SLOT + j (csrc/group_cumulants.cu).
SHORT_MAX = 32
PIECE = 1024
SLOT = SHORT_MAX + 1


def cost(n: int, num_groups: int, orders: int) -> tuple:
    """(float operations, bytes) of one call at its bound, either route:
    16 bytes a tuple (p, v and a group id read, as sorted or not) and the
    (num_groups, orders) sums written once."""
    return n * ops_per_tuple(orders), n * 16 + num_groups * orders * 4


def slot_count(n: int) -> int:
    """Piece slots of route (b) for n sorted tuples: sized from n alone."""
    return n // SLOT


def presort_operands(probs, values, gids):
    """The stable sort by gid of route (b), on int32 keys.  Returns
    ``(p_sorted, v_sorted, g_sorted)``."""
    g_sorted, order = torch.sort(gids.to(torch.int32), stable=True)
    return probs[order].contiguous(), values[order].contiguous(), g_sorted


def group_cumulant_sums_plain(probs, values, gids, num_groups: int,
                              orders: int = 8):
    """The plain PyTorch version: (orders, n) rows and a segment sum."""
    return ref.group_cumulants_ref(probs, values, gids, num_groups, orders)


def group_cumulant_sums(probs, values, gids, *, num_groups: int,
                        orders: int = 8, operands=None):
    """Per-group partial cumulant sums, (num_groups, orders).
    ``operands`` (from :func:`presort_operands`) replace probs/values/gids.
    A CUDA tensor launches route (a) or (b) (module docstring); a CPU
    tensor computes :func:`group_cumulant_sums_plain`."""
    check_orders(orders)
    if operands is not None:
        probs, values, gids = operands
    if probs.device.type == "cpu" and not on_card(probs):
        return group_cumulant_sums_plain(probs, values, gids, num_groups,
                                         orders)
    n = probs.shape[0]
    fake = build.faked(probs, "group_cumulant_sums",
                       *cost(n, num_groups, orders))
    v = values.to(torch.float32).contiguous()
    build.check_operand("group_cumulant_sums probs", probs, torch.float32)
    build.check_operand("group_cumulant_sums values", v, torch.float32, n)
    if num_groups <= NO_SORT_MAX:
        g = gids.to(torch.int64).contiguous()
        build.check_operand("group_cumulant_sums gids", g, torch.int64, n)
        out = launch_tiles(probs, v, g, num_groups, orders, fake)[
            :num_groups * orders].view(num_groups, orders)
    else:
        out = _launch_sorted(probs, v, gids, num_groups, orders,
                             presorted=operands is not None, fake=fake)
    group_cumulant_sums.launches += 1
    return out


def _launch_sorted(p, v, gids, num_groups: int, orders: int,
                   presorted: bool, fake: bool = False):
    """Route (b): sort unless presorted, launch csrc/group_cumulants.cu
    (with ``fake``, the dry-run: only the outputs)."""
    if not presorted:
        p, v, gids = presort_operands(p, v, gids)
    g = gids.to(torch.int32).contiguous()
    n = p.shape[0]
    build.check_operand("group_cumulant_sums gids", g, torch.int32, n)
    slots = slot_count(n)
    # one allocation: the sums, the slot rows, then the group bounds
    width = num_groups * orders
    buf = torch.empty((width + slots * orders + num_groups + 1,),
                      dtype=torch.float32, device=p.device)
    if not fake:
        out = buf.data_ptr()
        build.launch("group_cumulant_sums_launch", p.data_ptr(),
                     v.data_ptr(), g.data_ptr(),
                     out + 4 * (width + slots * orders), out + 4 * width,
                     out, n, slots, num_groups, orders,
                     build.stream_handle(p.device))
    return buf[:width].view(num_groups, orders)


group_cumulant_sums.launches = 0
