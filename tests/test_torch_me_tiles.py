"""The launch geometry of the SAD-search kernel (K2) and the row-pool map
kernel (K3), walked on the CPU as the kernels walk it: every (offset, MB)
of the (2s+1)^2 x nMB map gets exactly one key or map entry, each key's
offset index is `me.offset_table(s)`'s row of its (dy, dx), and the
geometry fits the kernels' limits."""

import numpy as np
import pytest

from p64tpu_torch.kernels import me, me_cuda, me_variants_cuda

SHAPES = {"48x64": (48, 64), "qcif": (144, 176), "cif": (288, 352),
          "one_mb_row": (16, 64)}
SEARCHES = [0, 1, 4, 7, 15]


def search_keys(height, width, search):
    """Every key the search kernel forms, as the kernel forms it: (block,
    thread, offset index o, MB), o = (dy + s)(2s + 1) + (dx + s), MB in
    raster order.  Padding dx and dy beyond the search and MBs past a
    ragged tile make no key."""
    tl = me_cuda.search_tiles(height, width, search)
    side, mb_cols = 2 * search + 1, width // 16
    for block in range(tl.tiles_per_row * (height // 16)):
        mb_row, tile = divmod(block, tl.tiles_per_row)
        mc0 = tile * tl.mb_tile
        n_here = min(tl.mb_tile, mb_cols - mc0)
        for tid in range(tl.threads):
            m = (tid // tl.n_dxg) % tl.mb_tile
            t = tid // (tl.n_dxg * tl.mb_tile)
            g = tl.g_lo + tid % tl.n_dxg
            for i in range(me_cuda.TILE_DY):
                for j in range(4):
                    di, dx = me_cuda.TILE_DY * t + i, 4 * g + j - 16
                    if m < n_here and di < side and abs(dx) <= search:
                        yield (block, tid, di * side + dx + search,
                               mb_row * mb_cols + mc0 + m)


def rp_keys(height, width, search):
    """Every map entry the rp kernel writes, as the kernel writes it:
    ((dy group, MB row), thread, offset index o, MB).  Per dy of the
    block's loop, the lane that leads each MB's 4 column words writes
    every dx of the search; a dy whose rows leave the picture is written
    whole by the block."""
    dpb, threads = me_variants_cuda.rp_geometry(width)
    side, mb_cols = 2 * search + 1, width // 16
    for group in range(-(-side // dpb)):
        for mb_row in range(height // 16):
            y0 = mb_row * 16
            for dyi in range(group * dpb, min(side, (group + 1) * dpb)):
                if y0 + dyi - search < 0 or y0 + dyi - search + 16 > height:
                    for i in range(side * mb_cols):
                        yield ((group, mb_row), i % threads,
                               dyi * side + i // mb_cols,
                               mb_row * mb_cols + i % mb_cols)
                    continue
                for k in range(0, width // 4, 4):
                    for dx in range(-15, 16):  # the kernel computes all 31
                        if abs(dx) <= search:
                            yield ((group, mb_row), k,
                                   dyi * side + dx + search,
                                   mb_row * mb_cols + k // 4)


def _coverage(keys, side, n_mb):
    """(side^2, nMB) count of the keys' (o, MB)."""
    count = np.zeros((side * side, n_mb), np.int64)
    for _, _, o, mb in keys:
        assert 0 <= o < side * side and 0 <= mb < n_mb
        count[o, mb] += 1
    return count


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_search_tiles_cover_every_offset_and_mb_once(shape, search):
    h, w = SHAPES[shape]
    side, n_mb = 2 * search + 1, (h // 16) * (w // 16)
    keys = list(search_keys(h, w, search))
    assert (_coverage(keys, side, n_mb) == 1).all()


@pytest.mark.parametrize("search", SEARCHES)
def test_search_key_index_is_the_offset_table_row(search):
    """The thread's (t, i, g, j) give (dy, dx); the key's o is the row of
    that (dy, dx) in the scan-order offset table."""
    h, w = SHAPES["cif"]
    tl = me_cuda.search_tiles(h, w, search)
    table = me.offset_table(search)
    seen = 0
    for tid in range(tl.threads):
        t = tid // (tl.n_dxg * tl.mb_tile)
        g = tl.g_lo + tid % tl.n_dxg
        for i in range(me_cuda.TILE_DY):
            for j in range(4):
                dy = me_cuda.TILE_DY * t + i - search
                dx = 4 * g + j - 16
                if abs(dy) > search or abs(dx) > search:
                    continue
                o = (dy + search) * (2 * search + 1) + dx + search
                assert tuple(table[o]) == (dy, dx)
                seen += 1
    assert seen == (2 * search + 1) ** 2 * tl.mb_tile


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_search_tiles_fit_the_kernel(shape, search):
    h, w = SHAPES[shape]
    tl = me_cuda.search_tiles(h, w, search)
    mb_cols = w // 16
    assert 1 <= tl.threads <= me_cuda.THREADS
    assert tl.g_lo >= 0 and tl.g_lo + tl.n_dxg <= 8
    assert 4 * tl.g_lo <= 16 - search and 4 * (tl.g_lo + tl.n_dxg) > \
        16 + search
    assert me_cuda.TILE_DY * tl.n_dyt >= 2 * search + 1
    assert tl.tiles_per_row * tl.mb_tile >= mb_cols
    assert (tl.tiles_per_row - 1) * tl.mb_tile < mb_cols
    for with_map in (False, True):
        assert tl.smem_bytes(search, with_map) <= me_cuda.SMEM_LIMIT


def test_search_tiles_at_the_headline_shape():
    """CIF at search 15: 8 dx groups x 4 dy tiles of 8 dy per MB, 8 MBs per
    256-thread block, 3 tiles per MB row of 22 (the last holds 6)."""
    tl = me_cuda.search_tiles(288, 352, 15)
    assert (tl.n_dxg, tl.n_dyt, tl.mb_tile, tl.threads) == (8, 4, 8, 256)
    assert tl.tiles_per_row == 3 and 22 - 2 * tl.mb_tile == 6
    assert me_cuda.search_tiles(144, 176, 15).tiles_per_row == 2


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rp_geometry_covers_every_offset_and_mb_once(shape, search):
    h, w = SHAPES[shape]
    side, n_mb = 2 * search + 1, (h // 16) * (w // 16)
    keys = list(rp_keys(h, w, search))
    assert (_coverage(keys, side, n_mb) == 1).all()
    dpb, threads = me_variants_cuda.rp_geometry(w)
    assert threads % 32 == 0 and w // 4 <= threads <= 128
    # the block's staged rows: 16 current, dy_per_block + 15 reference,
    # each reference row with a 16-byte halo on both sides
    assert 16 * w + (dpb + 15) * (w + 32) <= me_cuda.SMEM_LIMIT
