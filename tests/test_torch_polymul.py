"""The partition of the port's polymul kernel (``csrc/polymul.cu``) on the
CPU: ``polymul.tiling`` is a function of the sizes alone, and a PyTorch
twin that walks the kernel's (tile, slice, chunk) blocks in the kernel's
order covers every pair of the band 0 <= t - u < nb exactly once and
equals the plain version in float64.  The kernel itself runs only on a
card (tests/test_torch_cuda.py, ``chip_smoke.py``).  No JAX here."""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import polymul

SOURCE = (pathlib.Path(polymul.__file__).parent / "csrc" / "polymul.cu")

# Shapes at a tile or slice boundary of ``tiling`` and one past either
# side: the 384-output tiles of the cluster route (nc = 383, 384, 385, and
# 768), the 1536-output tiles of the two-launch route (nc = 4607, 4608,
# 4609, also 12 tiles of 384), and slices of 32 (the shorter factor 31, 32,
# 33) and of 64 (959, 960, 961).
TILE_SHAPES = [(128, 256), (128, 257), (128, 258), (200, 569)]
WIDE_TILE_SHAPES = [(2048, 2560), (2048, 2561), (2048, 2562)]
SLICE_SHAPES = [(31, 1000), (32, 1000), (33, 1000), (959, 959), (960, 960),
                (961, 961)]
BOUNDARY_SHAPES = TILE_SHAPES + WIDE_TILE_SHAPES + SLICE_SHAPES
EDGE_SHAPES = [(1, 1), (1, 16_384), (16_384, 1), (1024, 128), (128, 1024),
               (16_384, 128), (3000, 257), (1001, 1001), (401, 801)]




def _routes(monkeypatch):
    """``tiling`` as it chooses, then forced onto the two-launch route (its
    128-thread tiles and up to MAX_SLICES slices) at every size."""
    yield "as chosen"
    monkeypatch.setattr(polymul, "WIDE_BLOCKS_FROM", 0)
    yield "two launches"
    monkeypatch.undo()


def _band(t0, tile, nu, nw):
    """The u range [lo, hi] of a tile that meets the band (``band``)."""
    return max(0, t0 - (nw - 1)), min(nu - 1, t0 + tile - 1)


def band_indicator(na, nb):
    """1 where 0 <= t - u < max(na, nb) for u over the shorter factor."""
    t = np.arange(na + nb - 1)[:, None]
    u = np.arange(min(na, nb))[None, :]
    return ((t - u >= 0) & (t - u < max(na, nb))).astype(np.int32)


def twin(a, b, tl=None):
    """The kernel's partition evaluated tile by tile, slice by slice and
    chunk by chunk: each slice sums its pairs in increasing u, the fold
    adds the slices of a tile in increasing order.  Returns c and the
    count of each (t, u) pair the blocks evaluate with real coefficients
    (u over the shorter factor; counted in numpy, which keeps the large
    index arrays out of torch's thread pool)."""
    tl = tl or polymul.tiling(a.shape[0], b.shape[0])
    if tl.swap:
        a, b = b, a
    nu, nw = a.shape[0], b.shape[0]
    nc = nu + nw - 1
    c = torch.zeros(nc, dtype=a.dtype)
    counts = np.zeros((nc, nu), dtype=np.int32)
    for i in range(tl.n_tiles):
        t0 = i * tl.tile
        t = t0 + torch.arange(tl.tile)
        lo, hi = _band(t0, tl.tile, nu, nw)
        folded = torch.zeros(tl.tile, dtype=a.dtype)
        for s in range(lo // tl.slice, hi // tl.slice + 1):
            us = s * tl.slice
            acc = torch.zeros(tl.tile, dtype=a.dtype)
            for ch in range((max(us, lo) - us) // tl.chunk,
                            (min(us + tl.slice - 1, hi) - us) // tl.chunk + 1):
                u = us + ch * tl.chunk + torch.arange(tl.chunk)
                j = t[:, None] - u[None, :]
                real = (u[None, :] < nu) & (j >= 0) & (j < nw) \
                    & (t[:, None] < nc)
                rows, cols = np.nonzero(real.numpy())
                # (t, u) pairs are distinct within a block
                counts[t.numpy()[rows], u.numpy()[cols]] += 1
                terms = torch.where(real, a[u.clamp(max=nu - 1)][None, :]
                                    * b[j.clamp(0, nw - 1)], 0.0)
                for k in range(tl.chunk):          # increasing u
                    acc += terms[:, k]
            folded += acc                          # increasing s
        keep = t < nc
        c[t[keep]] = folded[keep]
    return c, counts


def test_tiling_is_a_function_of_the_sizes(monkeypatch):
    """The same sizes give the same partition, swapped sizes the same one
    with ``swap`` flipped, and nothing asks the card; every field is what
    the C entry accepts and the slices cover the shorter factor."""
    for name in ("is_available", "device_count", "get_device_properties"):
        monkeypatch.setattr(torch.cuda, name, None)
    for na, nb in EDGE_SHAPES + BOUNDARY_SHAPES + [(8192, 16_384),
                                                   (16_384, 16_384)]:
        tl = polymul.tiling(na, nb)
        assert tl == polymul.tiling(na, nb)
        assert tl._replace(swap=not tl.swap) == polymul.tiling(nb, na) \
            or na == nb
        assert tl.swap == (na > nb)
        nu, nc = min(na, nb), na + nb - 1
        assert tl.threads % 32 == 0 and 32 <= tl.threads <= 256
        assert tl.tile == polymul.ROWS * tl.threads
        assert tl.chunk % polymul.STEP == 0 and tl.chunk <= polymul.MAX_CHUNK
        assert tl.slice % tl.chunk == 0
        assert tl.n_slices == -(-nu // tl.slice)
        assert tl.n_slices <= polymul.MAX_SLICES
        assert tl.n_tiles == -(-nc // tl.tile)
        assert tl.pitch == tl.n_tiles * tl.tile
        if nu * (na + nb - nu) >= polymul.WIDE_BLOCKS_FROM:
            assert tl.cluster == 0 and tl.threads == 128
        else:    # one launch: a cluster holds the tile's slices
            assert tl.n_slices <= tl.cluster == polymul.MAX_CLUSTER
            assert tl.threads == 32


def test_boundary_shapes_sit_at_a_boundary(monkeypatch):
    """Each tile-boundary shape's output ends one before, at, or one past a
    multiple of its tile width (the wide ones on both routes), and each
    slice-boundary shape's shorter factor one before, at or one past a
    multiple of its slice."""
    for na, nb in TILE_SHAPES + WIDE_TILE_SHAPES:
        tl = polymul.tiling(na, nb)
        assert tl.tile == polymul.ROWS * 32
        assert (na + nb - 1) % tl.tile in (tl.tile - 1, 0, 1)
    for na, nb in SLICE_SHAPES:
        tl = polymul.tiling(na, nb)
        assert min(na, nb) % tl.slice in (tl.slice - 1, 0, 1)
    monkeypatch.setattr(polymul, "WIDE_BLOCKS_FROM", 0)
    for na, nb in WIDE_TILE_SHAPES:
        tl = polymul.tiling(na, nb)
        assert tl.tile == polymul.ROWS * 128
        assert (na + nb - 1) % tl.tile in (tl.tile - 1, 0, 1)


@pytest.mark.parametrize("na,nb", EDGE_SHAPES + BOUNDARY_SHAPES)
def test_partition_covers_the_band_once_and_matches_plain(na, nb,
                                                          monkeypatch):
    """On either route the twin's count matrix equals the band indicator
    (every pair once, none outside), and its float64 result equals the
    plain version to 1e-12 of the per-output scale sum_u |a_u||b_{t-u}|."""
    rng = np.random.default_rng(na * 7919 + nb)
    a = torch.from_numpy(rng.uniform(-1, 1, na))
    b = torch.from_numpy(rng.uniform(-1, 1, nb))
    want = polymul.polymul_plain(a, b)
    scale = polymul.polymul_plain(a.abs(), b.abs())
    for route in _routes(monkeypatch):
        got, counts = twin(a, b)
        assert np.array_equal(counts, band_indicator(na, nb)), route
        assert float(((got - want).abs() / scale.clamp(min=1e-300)).max()) \
            <= 1e-12, route


def test_partition_with_several_chunks_per_slice():
    """Slices of several chunks (the kernel's double-buffered walk, which
    ``tiling`` picks only for the largest products, about 20,000 x 20,000
    and up) cover the band once: the same twin with a tiling forced to
    slices of three 16-value chunks."""
    na, nb = 200, 300
    tl = polymul.Tiling(swap=False, threads=32, tile=384, slice=48, chunk=16,
                        n_tiles=2, n_slices=5, pitch=768, cluster=16)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(-1, 1, na))
    b = torch.from_numpy(rng.uniform(-1, 1, nb))
    got, counts = twin(a, b, tl)
    assert np.array_equal(counts, band_indicator(na, nb))
    torch.testing.assert_close(got, polymul.polymul_plain(a, b), rtol=0,
                               atol=1e-12)


def test_source_constants_match_the_tiling():
    """``tiling`` and csrc/polymul.cu agree on the outputs per thread, the
    unrolled step, the largest chunk and the cluster size."""
    text = SOURCE.read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    assert int(const["kRows"]) == polymul.ROWS
    assert int(const["kMaxChunk"]) == polymul.MAX_CHUNK
    assert int(const["kMaxCluster"]) == polymul.MAX_CLUSTER
    assert 4 * (polymul.ROWS // 4 + 1) == polymul.STEP
    assert const["kStep"] == "4 * kRuns" and \
        const["kRuns"] == "kRows / 4 + 1"
