"""Scalar one-pass cumulant sums (the port of ``repro.kernels.cumulants``):
the wrapper of ``csrc/cumulants.cu`` and its plain PyTorch version.

    s_j = sum_i v_i^j * kappa_j(p_i),      j = 1..orders  (orders <= 12)

with kappa_j the Bernoulli cumulant polynomials of
:func:`repro_torch.core.approx._bernoulli_cumulant_polys`.
"""
from __future__ import annotations

import torch

from ..core.approx import MAX_ORDER
from ..core.config import on_card
from . import build, ref

#: tuples per block of ``csrc/cumulants.cu`` (kTile): the split of a column
#: into blocks depends on its length alone.
TILE = 4096


def tile_count(n: int) -> int:
    """Blocks (tiles of :data:`TILE` tuples) of an n-tuple launch."""
    return -(-n // TILE)


def ops_per_tuple(orders: int) -> int:
    """Float operations a tuple costs: Horner over each kappa_j's own
    degree j (j FMAs, 2 ops each), v^j (orders - 1 multiplies) and the
    accumulating FMAs (2 * orders)."""
    return orders * orders + 4 * orders - 1


def cost(n: int, orders: int) -> tuple:
    """(float operations, bytes) of one launch at its bound: p and v read
    once, the ``orders`` sums written once."""
    return n * ops_per_tuple(orders), n * 8 + orders * 4


def check_orders(orders: int) -> None:
    if not 1 <= orders <= MAX_ORDER:
        raise ValueError(f"orders must be in [1, {MAX_ORDER}], got {orders}")


def cumulant_sums_plain(probs, values, orders: int = 8):
    """The plain PyTorch version: (orders, n) rows and one sum."""
    return ref.cumulants_ref(probs, values, orders)


def cumulant_sums(probs, values, *, orders: int = 8):
    """One-pass partial cumulant sums, (orders,).  A CUDA tensor launches
    ``csrc/cumulants.cu``; a CPU tensor computes
    :func:`cumulant_sums_plain`."""
    check_orders(orders)
    if probs.device.type == "cpu" and not on_card(probs):
        return cumulant_sums_plain(probs, values, orders)
    fake = build.faked(probs, "cumulant_sums",
                       *cost(probs.shape[0], orders))
    v = values.to(torch.float32).contiguous()
    build.check_operand("cumulant_sums probs", probs, torch.float32)
    build.check_operand("cumulant_sums values", v, torch.float32,
                        probs.shape[0])
    out = launch_tiles(probs, v, None, 1, orders, fake)[:orders]
    cumulant_sums.launches += 1
    return out


def launch_tiles(p, v, gids, num_groups: int, orders: int,
                 fake: bool = False):
    """Launch ``csrc/cumulants.cu`` for the scalar kernel (num_groups = 1,
    no gids) or route (a) of the grouped one (at most 8 groups, int64
    ``gids``); with ``fake`` (the dry-run) only the outputs.  Returns a
    buffer that starts with the (num_groups, orders) sums, row by row.
    Operands checked by the caller; no host sync."""
    n = p.shape[0]
    tiles = tile_count(n)
    width = num_groups * orders
    # one allocation: the sums, then the tiles' partial sums
    buf = torch.empty((width * (1 + tiles),), dtype=torch.float32,
                      device=p.device)
    if not fake:
        out = buf.data_ptr()
        build.launch("cumulant_sums_launch", p.data_ptr(), v.data_ptr(),
                     0 if gids is None else gids.data_ptr(),
                     out + 4 * width, out, n, tiles, num_groups, orders,
                     build.stream_handle(p.device))
    return buf


cumulant_sums.launches = 0
