"""The launch geometry of the SAD-search kernel (K2), the row-pool map
kernel (K3) and the tiled f32, int8 and SWAR map kernels (K1, K4, K5),
walked on the CPU as the kernels walk it: every (offset, MB) of the
(2s+1)^2 x nMB map gets exactly one key or map entry, each key's offset
index is `me.offset_table(s)`'s row of its (dy, dx), and the geometry fits
the kernels' limits.  K5's 16-bit field arithmetic is checked
exhaustively, and its field-word staging against the pixels the loop
pairs; K4's int8 bias for every byte pair, its worst MB sums, and its
pool's walk over the window copies."""

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


# ----------------------------------------------- K1 and K5: tiled maps

def map_tile_entries(height, width, search,
                     tiles=me_variants_cuda.map_tiles):
    """Every map entry K1 and K5 (K4 with tiles=i8_tiles) write, as they
    write it: each thread puts its in-search (offset, MB) into the tile's
    staged map, (block, thread, o, MB); then the block stores the tile as
    runs of consecutive MBs, (block, "store", o, MB)."""
    tl = tiles(height, width, search)
    side, mb_cols = 2 * search + 1, width // 16
    n_off = side * side
    for block in range(tl.tiles_per_row * (height // 16)):
        mb_row, tile = divmod(block, tl.tiles_per_row)
        mc0 = tile * tl.mb_tile
        n_here = min(tl.mb_tile, mb_cols - mc0)
        staged = {}
        for tid in range(tl.threads):
            m = (tid // tl.n_dxg) % tl.mb_tile
            t = tid // (tl.n_dxg * tl.mb_tile)
            g = tl.g_lo + tid % tl.n_dxg
            for i in range(me_cuda.TILE_DY):
                for j in range(4):
                    di, dx = me_cuda.TILE_DY * t + i, 4 * g + j - 16
                    if m < n_here and di < side and abs(dx) <= search:
                        o = di * side + dx + search
                        at = o * tl.mb_tile + m
                        assert at not in staged
                        staged[at] = o
                        yield (block, tid, o, mb_row * mb_cols + mc0 + m)
        for i in range(n_off * n_here):
            o, mm = divmod(i, n_here)
            assert staged[o * tl.mb_tile + mm] == o
            yield (block, "store", o, mb_row * mb_cols + mc0 + mm)


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_map_tiles_cover_every_offset_and_mb_once(shape, search):
    h, w = SHAPES[shape]
    side, n_mb = 2 * search + 1, (h // 16) * (w // 16)
    entries = list(map_tile_entries(h, w, search))
    written = [e for e in entries if e[1] != "store"]
    stored = [e for e in entries if e[1] == "store"]
    assert (_coverage(written, side, n_mb) == 1).all()
    assert (_coverage(stored, side, n_mb) == 1).all()


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_map_tiles_fit_the_kernels(shape, search):
    """Threads, shared memory and every shared load inside its region: the
    20 window elements a thread loads per row and its current rows."""
    h, w = SHAPES[shape]
    tl = me_variants_cuda.map_tiles(h, w, search)
    mb_cols = w // 16
    assert 1 <= tl.threads <= me_cuda.THREADS
    assert tl.g_lo >= 0 and tl.g_lo + tl.n_dxg <= 8
    assert 4 * tl.g_lo <= 16 - search and 16 + search < 4 * (tl.g_lo
                                                             + tl.n_dxg)
    assert me_cuda.TILE_DY * tl.n_dyt >= 2 * search + 1
    assert (tl.tiles_per_row - 1) * tl.mb_tile < mb_cols \
        <= tl.tiles_per_row * tl.mb_tile
    assert me_variants_cuda.map_tile_smem_bytes(tl, search) \
        <= me_cuda.SMEM_LIMIT
    rows = me_cuda.TILE_DY * tl.n_dyt + 15
    row = 16 * tl.mb_tile + 32
    last_g = tl.g_lo + tl.n_dxg - 1
    # window row 8 t + q, elements 16 m + 4 g .. + 19, all 16-byte aligned
    assert me_cuda.TILE_DY * (tl.n_dyt - 1) + me_cuda.TILE_DY + 14 < rows
    assert 16 * (tl.mb_tile - 1) + 4 * last_g + 19 < row
    # the loop reads pixel x of the MB at byte column 16 m + 16 + dx + x
    # (K5: field words of x and x + 2 for x = 0, 1, 4, 5, .., 13), all
    # inside the staged row
    assert 16 * (tl.mb_tile - 1) + 16 + search + 15 < row


def test_map_tiles_at_the_headline_shape():
    """CIF at search 15: the search's 8 MBs of 32 threads per block, 3
    tiles per MB row of 22, 48,512 bytes of shared memory."""
    tl = me_variants_cuda.map_tiles(288, 352, 15)
    assert tl == me_cuda.search_tiles(288, 352, 15)
    assert me_variants_cuda.map_tile_smem_bytes(tl, 15) == 48_512


M00FF = 0x00FF00FF
BIAS = 0x01000100


def viaddmax_u16x2(a, b, c):
    """Hopper's VIADDMNMX.U16x2 max form: per 16-bit field, max of the
    field sum a + b mod 2^16 and c (uint32 arrays)."""
    lo = np.maximum((a + b) & 0xFFFF, c & 0xFFFF)
    hi = np.maximum(((a >> 16) + (b >> 16)) & 0xFFFF, c >> 16)
    return (lo | (hi << 16)).astype(np.uint32)


def swar_term(cur_fields, ref_fields):
    """K5's per-word term, as the kernel computes it in uint32: cb and kc
    staged from the current fields, d1 = cb - ref, then one add-max."""
    cb = (cur_fields + np.uint32(BIAS)).astype(np.uint32)
    kc = (np.uint32(BIAS) - cur_fields).astype(np.uint32)
    d1 = (cb - ref_fields).astype(np.uint32)
    return viaddmax_u16x2(kc, ref_fields, d1)


def test_swar_field_term_exact_for_every_byte_pair():
    """All 65,536 (u, v) byte pairs in the low field and, in another order,
    in the high field: each field of the term is 256 + |u - v|, and d1's
    32-bit subtract borrows nothing across the fields."""
    u, v = (a.ravel().astype(np.uint32) for a in
            np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    u2, v2 = u[::-1], np.roll(v, 12345)
    cur = u | (u2 << 16)
    ref = v | (v2 << 16)
    term = swar_term(cur, ref)
    want_lo = 256 + np.abs(u.astype(np.int64) - v)
    want_hi = 256 + np.abs(u2.astype(np.int64) - v2)
    np.testing.assert_array_equal(term & 0xFFFF, want_lo)
    np.testing.assert_array_equal(term >> 16, want_hi)
    d1 = (cur + np.uint32(BIAS) - ref).astype(np.uint32)
    np.testing.assert_array_equal(d1 & 0xFFFF, 256 + u.astype(np.int64) - v)
    np.testing.assert_array_equal(d1 >> 16, 256 + u2.astype(np.int64) - v2)


@pytest.mark.parametrize("cur_byte,ref_byte", [(255, 0), (0, 255), (7, 7)])
def test_swar_accumulation_stays_below_a_field(cur_byte, ref_byte):
    """A whole MB of one accumulator: 128 packed terms, summed in uint32 as
    the kernel does.  Each field stays below 2^16 (65,408 at worst), and
    the two fields less 2 x 128 x 256 are the SAD."""
    word = np.uint32(cur_byte | cur_byte << 16)
    rword = np.uint32(ref_byte | ref_byte << 16)
    acc = np.uint32(0)
    for _ in range(128):
        acc = np.uint32((int(acc) + int(swar_term(word, rword))) & 0xFFFFFFFF)
        assert int(acc) & 0xFFFF < 1 << 16 and int(acc) >> 16 < 1 << 16
    lo, hi = int(acc) & 0xFFFF, int(acc) >> 16
    assert lo == hi == 128 * (256 + abs(cur_byte - ref_byte))
    assert lo + hi - 2 * 128 * 256 == 256 * abs(cur_byte - ref_byte)
    if cur_byte != ref_byte:
        assert lo == 65_408


def test_swar_field_words_pair_each_pixel_with_its_reference_byte():
    """K5's staging and loop indexing: window element b is the field word of
    bytes b and b + 2 (a funnel shift of two staged words), current word k
    holds pixels x_k and x_k + 2 for x_k = 0, 1, 4, 5, .., 13, and the loop
    pairs word k with window element j + x_k, so under dx offset j every
    pixel x of an MB row meets window byte j + x exactly once."""
    raw = np.random.default_rng(6).integers(0, 256, 64).astype(np.uint8)
    words = raw.view("<u4").astype(np.uint64)
    pairs = words | np.append(words[1:], np.uint64(0)) << np.uint64(32)
    win = np.stack([(pairs >> np.uint64(8 * k)) & np.uint64(M00FF)
                    for k in range(4)], axis=1).ravel().astype(np.int64)
    cur = raw[:16].view("<u4").astype(np.int64)
    fields = np.stack([cur & M00FF, (cur >> 8) & M00FF], axis=1).ravel()
    xk = [4 * (k >> 1) + (k & 1) for k in range(8)]
    for j in range(4):
        met = []
        for k, x in enumerate(xk):
            assert (fields[k] & 0xFFFF, fields[k] >> 16) == (raw[x],
                                                            raw[x + 2])
            v = win[j + x]
            assert (v & 0xFFFF, v >> 16) == (raw[j + x], raw[j + x + 2])
            met += [x, x + 2]
        assert sorted(met) == list(range(16))


# -------------------------------- K4: the biased int8 pool in K2's tiles

I8_BIAS, I8_EXCESS = 0x80, 128 * 256


def biased_absdiff(a, b):
    """K4's per-byte term: VABSDIFF4 then XOR 0x80, read as int8."""
    ad = np.abs(a.astype(np.int16) - b.astype(np.int16)).astype(np.uint8)
    return (ad ^ np.uint8(I8_BIAS)).view(np.int8)


def test_i8_bias_exact_for_every_byte_pair():
    """All 65,536 (u, v) byte pairs: |u - v| ^ 0x80 read as int8 is
    |u - v| - 128."""
    u, v = (a.ravel().astype(np.uint8) for a in
            np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    want = np.abs(u.astype(np.int64) - v) - 128
    np.testing.assert_array_equal(biased_absdiff(u, v).astype(np.int64),
                                  want)


@pytest.mark.parametrize("ad", [0, 255, 1, 254])
def test_i8_mb_sum_undoes_the_bias(ad):
    """One MB of equal abs-diffs pooled as the kernel pools it, 64 signed
    dp4a steps of 4 biased bytes each into an int32 accumulator: the
    worst cases are -32,768 (all 0) and 32,512 (all 255), and + 32,768
    gives back the SAD."""
    cur = np.full(256, ad, np.uint8)
    ref = np.zeros(256, np.uint8)
    words = biased_absdiff(cur, ref).reshape(64, 4)
    acc = np.int32(0)
    for w in words:  # __dp4a(word, 0x01010101, acc)
        acc = np.int32(acc + int(w.astype(np.int32).sum()))
    assert -32_768 <= int(acc) <= 32_512
    if ad in (0, 255):
        assert int(acc) == {0: -32_768, 255: 32_512}[ad]
    assert int(acc) + I8_EXCESS == 256 * ad


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_i8_tiles_cover_every_offset_and_mb_once(shape, search):
    h, w = SHAPES[shape]
    side, n_mb = 2 * search + 1, (h // 16) * (w // 16)
    entries = list(map_tile_entries(h, w, search, me_variants_cuda.i8_tiles))
    written = [e for e in entries if e[1] != "store"]
    stored = [e for e in entries if e[1] == "store"]
    assert (_coverage(written, side, n_mb) == 1).all()
    assert (_coverage(stored, side, n_mb) == 1).all()


def i8_pool_walk(tl, m, t, g):
    """K4's loop for thread (dx group g - g_lo, MB m, dy tile t), as the
    kernel runs it: per window row q, the 4 words of each byte alignment
    j; per dy i with current row r = q - i inside the MB, 4 dp4a steps
    into acc[i][j].  Yields (i, j, r, k, shared word index)."""
    win_words = 4 * tl.mb_tile + 8
    copy_words = (me_cuda.TILE_DY * tl.n_dyt + 15) * win_words
    base = me_cuda.TILE_DY * t * win_words + 4 * m + g
    for q in range(me_cuda.TILE_DY + 15):
        for i in range(me_cuda.TILE_DY):
            r = q - i
            if not 0 <= r < 16:
                continue
            for j in range(4):
                for k in range(4):
                    yield i, j, r, k, base + j * copy_words + q * win_words + k


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_i8_pool_takes_each_pixel_word_once_inside_its_region(shape,
                                                              search):
    """Each (dy, dx) accumulator of a thread pools each of its MB's 64
    pixel words (current row r, word k) exactly once, against window row
    8 t + i + r, byte column 4 (4 m + g + k) + j = 16 m + 16 + dx + 4 k:
    the reference pixels of MB m under (dy, dx).  Every shared load lies
    in its copy of the window and never reads a row's last word (copies
    1..3 wrap it into the next row); the current rows, the staged map and
    the window fit the block's shared memory."""
    h, w = SHAPES[shape]
    tl = me_variants_cuda.i8_tiles(h, w, search)
    win_words = 4 * tl.mb_tile + 8
    win_rows = me_cuda.TILE_DY * tl.n_dyt + 15
    copy_words = win_rows * win_words
    for m in range(tl.mb_tile):
        for t in range(tl.n_dyt):
            for g in range(tl.g_lo, tl.g_lo + tl.n_dxg):
                seen = {}
                for i, j, r, k, at in i8_pool_walk(tl, m, t, g):
                    seen.setdefault((i, j), []).append((r, k))
                    copy, word = divmod(at, copy_words)
                    row, col = divmod(word, win_words)
                    assert copy == j and row == me_cuda.TILE_DY * t + i + r
                    assert col < win_words - 1
                    dx = 4 * g + j - 16
                    assert 4 * col + j == 16 * m + 16 + dx + 4 * k
                assert len(seen) == 4 * me_cuda.TILE_DY
                for pairs in seen.values():
                    assert sorted(pairs) == [(r, k) for r in range(16)
                                             for k in range(4)]
    side = 2 * search + 1
    smem = tl.aligned_smem_bytes(search, True)
    assert smem <= me_cuda.SMEM_LIMIT
    assert smem == 4 * max(4 * copy_words,
                           4 * -(-side * side * tl.mb_tile // 4)) \
        + 4 * 16 * 4 * tl.mb_tile
    assert 1 <= tl.threads <= me_cuda.THREADS
    assert (tl.tiles_per_row - 1) * tl.mb_tile < w // 16 \
        <= tl.tiles_per_row * tl.mb_tile


def test_i8_tiles_at_the_headline_shape():
    """CIF at search 15: the search's tiles, 8 MBs of 32 threads per
    block, 3 tiles per MB row; 32,800 bytes of shared memory (the search's
    map mode less its keys)."""
    tl = me_variants_cuda.i8_tiles(288, 352, 15)
    assert tl == me_cuda.search_tiles(288, 352, 15)
    assert tl.aligned_smem_bytes(15, True) == 32_800
    assert tl.smem_bytes(15, True) == 32_800 + 8 * tl.threads
