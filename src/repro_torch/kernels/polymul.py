"""Schoolbook polynomial product (the port of ``repro.kernels.polymul``):
the wrapper of ``csrc/polymul.cu`` and its plain PyTorch version.

    c[t] = sum_u a[u] * b[t - u]          (the linear convolution a * b)

``PGF.mul_sum`` reaches it in its schoolbook branch for float32 factors
of at least ``ops.MIN_KERNEL_DEGREE`` coefficients.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import on_card
from . import build, ref

#: consecutive outputs per thread (``kRows`` in csrc/polymul.cu).
ROWS = 12
#: largest chunk of u values a block stages at once (``kMaxChunk``).
MAX_CHUNK = 512
#: a slice is a whole number of 16-value steps (``kStep``).
STEP = 16
#: at most this many slices per output: bounds the scratch to this many
#: copies of the output.
MAX_SLICES = 64
#: the blocks of a thread block cluster (``kMaxCluster``): a small product
#: takes at most this many slices and folds them inside one cluster, in
#: one launch.  A cluster always has this many blocks, those past the
#: tile's slices idle, so that the fold of a tile's outputs is split over
#: sixteen blocks (smaller clusters ran slower on the H100).
MAX_CLUSTER = 16
#: products of at least this many multiply-adds take 128-thread blocks and
#: two launches (partial sums to a scratch, then the fold kernel); smaller
#: ones 32-thread blocks (more blocks, shorter per-thread work) and one
#: launch of clusters.  On the H100 the cluster route is the faster up to
#: 8192 x 8192 and the two-launch route at 16,384 x 16,384 (chip_smoke.py
#: times both).
WIDE_BLOCKS_FROM = 1 << 27
#: the (tile, slice) pairs of the band aimed at.
TARGET_BLOCKS = 512
#: the shortest slice: shorter ones buy little and lengthen the fold.
MIN_SLICE = 32
#: the kernel indexes outputs in int32, with room past the last one for
#: the padding of the last tile and its staged b window.
MAX_OUTPUT = (1 << 31) - 1 - 4 * ROWS * 256 - MAX_CHUNK


class Tiling(NamedTuple):
    """How ``csrc/polymul.cu`` cuts a product of sizes (na, nb): u runs
    over the shorter factor (``swap``: b is shorter), ``threads`` per
    block own ``tile = ROWS * threads`` consecutive outputs, and u is cut
    into ``n_slices`` slices of ``slice`` values, staged ``chunk`` at a
    time.  Block (i, s) of the band sums its pairs; a tile's slices are
    added in increasing s, by the blocks of one cluster of ``cluster``
    blocks (one launch), or, where ``cluster`` is 0, by the fold kernel
    from rows s of a scratch of ``n_slices * pitch`` floats."""
    swap: bool
    threads: int
    tile: int
    slice: int
    chunk: int
    n_tiles: int
    n_slices: int
    pitch: int
    cluster: int


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def tiling(na: int, nb: int) -> Tiling:
    """The kernel's partition of an (na, nb) product, from the sizes alone
    (never from the card): enough (tile, slice) pairs of the band to keep
    the card busy, each slice at least ``MIN_SLICE`` long, at most
    ``MAX_SLICES`` of them (``MAX_CLUSTER`` for a small product)."""
    nu, nw = min(na, nb), max(na, nb)
    nc = na + nb - 1
    wide = nu * nw >= WIDE_BLOCKS_FROM
    threads = 128 if wide else 32
    tile = ROWS * threads
    n_tiles = _cdiv(nc, tile)
    # the u ranges of all tiles' bands, summed (about): the band's nu * nw
    # pairs over the tile width, plus the ragged ends.
    band_u = _cdiv(nu * nw, tile) + nu
    slice_ = max(_cdiv(band_u, TARGET_BLOCKS),
                 _cdiv(nu, MAX_SLICES if wide else MAX_CLUSTER), MIN_SLICE)
    slice_ = _cdiv(min(slice_, nu), STEP) * STEP
    chunk = slice_
    if slice_ > MAX_CHUNK:
        chunk = MAX_CHUNK
        slice_ = _cdiv(slice_, MAX_CHUNK) * MAX_CHUNK
    n_slices = _cdiv(nu, slice_)
    return Tiling(swap=na > nb, threads=threads, tile=tile, slice=slice_,
                  chunk=chunk, n_tiles=n_tiles, n_slices=n_slices,
                  pitch=n_tiles * tile, cluster=0 if wide else MAX_CLUSTER)


def cost(na: int, nb: int) -> tuple:
    """(float operations, bytes) of one product at its bound: a
    multiply-add a pair, both factors read once, the product written
    once."""
    return 2 * na * nb, 4 * (2 * na + 2 * nb - 1)


def polymul_plain(a, b):
    """The plain PyTorch version: a loop over the shorter factor."""
    return ref.polymul_ref(a, b)


def polymul(a, b):
    """Linear convolution of two 1-D coefficient vectors, (na + nb - 1,).
    A CUDA tensor launches ``csrc/polymul.cu`` (float32 only); a CPU tensor
    computes :func:`polymul_plain`."""
    if a.device.type == "cpu" and not on_card(a):
        return polymul_plain(a, b)
    na, nb = a.shape[0], b.shape[0]
    if na < 1 or nb < 1:
        raise ValueError(f"polymul: empty factor ({na}, {nb})")
    nc = na + nb - 1
    if nc > MAX_OUTPUT:
        raise ValueError(f"polymul: output length {nc} exceeds the kernel's "
                         f"int32 indexing ({MAX_OUTPUT})")
    fake = build.faked(a, "polymul", *cost(na, nb))
    build.check_operand("polymul a", a, torch.float32)
    build.check_operand("polymul b", b, torch.float32)
    if b.device != a.device:
        raise ValueError(f"polymul: factors on {a.device} and {b.device}")
    tl = tiling(na, nb)
    if tl.swap:
        a, b, na, nb = b, a, nb, na
    partial = None if tl.cluster else torch.empty(
        (tl.n_slices * tl.pitch,), dtype=torch.float32, device=a.device)
    c = torch.empty((nc,), dtype=torch.float32, device=a.device)
    if not fake:
        build.launch("polymul_launch", a.data_ptr(), b.data_ptr(),
                     None if partial is None else partial.data_ptr(),
                     c.data_ptr(), na, nb, tl.threads, tl.slice, tl.chunk,
                     tl.cluster, build.stream_handle(a.device))
    polymul.launches += 1
    return c


polymul.launches = 0
