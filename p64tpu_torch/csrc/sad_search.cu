// SAD kernels for H.261 motion estimation (sm_90a): the fused full search
// of the encoder's path and four dense-map formulations for the parity gate.
//
// Each replaces a TPU kernel of p64tpu/kernels/me_pallas.py:
//   p64_sad_search    <- _sad_kernel_bf16 / sad_map_pallas_bf16, together
//                        with the argmin that me.py::full_search ran on it
//   p64_sad_map_f32   <- _sad_kernel / sad_map_pallas           (f32 pools)
//   p64_sad_map_rp    <- _sad_kernel_rp / sad_map_pallas_rp     (rows first)
//   p64_sad_map_i8    <- _sad_kernel_i8 / sad_map_pallas_i8     (int8 pool)
//   p64_sad_map_swar  <- _sad_kernel_swar / sad_map_pallas_swar (SWAR)
//
// Contract (p64tpu/kernels/me.py): cur and ref are (streams, H, W) uint8,
// H and W multiples of 16.  Per stream and 16x16 macroblock, SAD =
// sum |cur - ref| at every (dy, dx) in [-search, search]^2, offsets in
// dy-major order, MBs in raster order; an offset whose window leaves the
// picture gets 1<<30.  The dense map is (streams, (2s+1)^2, nMB) int32.
// The search's winner is the FIRST minimum in offset order; sad0 is the SAD
// at (0, 0).  The map kernels are held equal to their plain torch versions
// (p64tpu_torch/kernels/me_variants.py) on the card.
//
// What bounds them on the card: integer instruction issue.  Each macroblock
// costs up to 961 x 256 abs-diffs at search 15, 11.28 G per frame of 128
// CIF streams once offsets off the picture are left out, against about
// 26 MB of input per frame; device memory is not the limit of the search.
// The cheapest instruction for the work is VABSDIFF4 with accumulate
// (PTX vabsdiff4.add: 4 byte abs-diffs summed into a 32-bit register),
// which issues on the SM's 64 integer lanes per clock, as IADD3, LOP3 and
// VIADDMNMX.U16x2 do (IDP4A issues beside them, on another pipe; probes on
// an H100); that puts the floor of the work at 0.169 ms per frame at 1,980
// MHz.  No tensor core helps K2: |a - b| has no product form, and
// VABSDIFF4 already pools 4 bytes into its accumulator, so an mma/wgmma
// pool could only add work.  K4's formulation has a pool of its own, a
// signed int8 dot product; for it an int8 tensor-core pool was built and
// measured, and lost (see K4).  A dense map adds 195 MB of stores per
// frame of 128 CIF streams.
//
// K2, the search (one thread per 4 dx x 8 dy of one MB, register tiled):
//   * A thread owns byte columns 4g..4g+3 of the window (4 dx sharing one
//     word alignment) and 8 consecutive dy.  It walks the 23 window rows
//     its dy need once; for each row it loads 16 words, its 4 words in each
//     of the 4 byte alignments, and adds 16 vabsdiff4.add into each of the
//     8 dy whose 16 rows hold that row.  That is 2,048 SIMD ops against
//     368 shared loads per 32 offsets.  The 4 alignments are copies of the
//     window shifted by 0..3 bytes, made once per block with
//     __funnelshift_r, so that the per-offset loop spends no integer
//     instruction on alignment.
//   * A block serves up to `mb_tile` horizontally adjacent MBs of one MB
//     row; they share one window staged with cp.async 16-byte chunks (x0-16
//     is a multiple of 16, so a chunk lies wholly inside or outside the
//     picture, and the zero-fill form gives the border).  At search 15 the
//     tile grid is 8 dx groups x 4 dy tiles = 32 threads per MB, 8 MBs per
//     256-thread block; dx = -16 and dy = 16 are padding that makes no key,
//     and a ragged last tile of an MB row (QCIF, CIF) is masked.  The block
//     is (dx group, MB, dy tile), dx group fastest, so a warp's window
//     loads fall on distinct banks or broadcast, and the grid is (MB tile,
//     MB row, stream): no thread divides to find its place.
//   * Each thread walks its offsets in increasing o, the (2s+1)-wide
//     offset index, keeps the first least SAD, and writes the key
//     (uint64)sad << 32 | o; the lexicographic minimum of the keys is the
//     first minimum.  Offsets off the picture or past the search are
//     ORed with an all-ones penalty instead of branching: the winner lies
//     inside the picture ((0, 0) always does).  Two passes in shared memory
//     reduce the MB's keys, over its dx groups and then its dy tiles.  The
//     owner of (0, 0) writes sad0.
//   * Map mode (parity only) stages each offset's values of the tile's MBs
//     in shared memory, over the window copies, and writes them as runs of
//     consecutive MBs.
//   * The wrapper (kernels/me_cuda.py::search_tiles) computes the tile
//     geometry; tests/test_torch_me_tiles.py walks it on the CPU.  K1, K4
//     and K5 share the tiles, the staging and the map store; K4 also the
//     4 byte alignments and the thread tile.
//   * Tried and measured (PERF.md): 4 dy per thread with the alignments
//     formed by funnel shifts in the loop, and a persistent grid that
//     double-buffers the next tile's window; both were slower.
// K3, rp: rows pooled first, as the TPU kernel: per dx, each column's sum
//   of |cur - ref| over the MB's 16 rows, then 16 columns per MB.  One block
//   per (stream, MB row, group of `dy_per_block` dy); it stages the 16
//   current rows and the group's reference rows with a 16-byte halo on each
//   side in shared memory once (cp.async, zero fill) and loops over its dy.
//   A thread owns 4 adjacent columns as one word: per row it loads 9 words,
//   and per dx __funnelshift_r aligns the reference word and __vabsdiffu4
//   takes 4 abs-diffs.  __byte_perm moves columns 1 and 3 into a word of
//   16-bit fields that a plain add accumulates (16 x 255 < 2^16: no carry
//   crosses a field); a second plain add sums the packed words themselves,
//   mod 2^32, and subtracting the first sum shifted by 8 leaves the sums of
//   columns 0 and 2, so each row costs one byte permute, not two.  The 4
//   column sums fold in registers and 4 threads per MB pool by shuffles.
//   The TPU split the column sums into 64 * hi + lo only so that its bf16
//   matrix unit would pool them exactly; integer sums are exact as they
//   are.  Pictures wider than CIF are refused.
// K1 (f32) and K5 (swar): K2's tiles and map mode, each kernel keeping the
//   arithmetic of its TPU kernel.  A block serves up to `mb_tile` MBs of an
//   MB row (kernels/me_variants_cuda.py::map_tiles, the same tile geometry
//   as the search), stages their window and current rows with cp.async
//   once, and turns them into one 32-bit element per byte column, so that
//   the loop spends nothing on conversion or alignment.  A thread owns 4 dx
//   x 8 dy of one MB: per window row it loads 20 elements (5 x 16 bytes)
//   and, for each of its dy that covers the row, the MB's current row (4 x
//   16 bytes, one address per quarter warp), which serve its 4 dx.  The map
//   is staged in shared memory over the window and written as runs of
//   consecutive MBs.
//     - f32: the window and current rows as floats; per abs-diff one FADD
//       for cur - ref and one FADD of |d| into the accumulator, on the
//       CUDA cores (no tensor core, no TF32; no product to contract).
//       Exact in any order: every partial sum is an integer <= 65,280 <
//       2^24.  Its floor is those 2 FP32 instructions per abs-diff on
//       128 FP32 lanes per SM: 0.674 ms per frame of 128 CIF streams.
//     - swar: two pixels per 32-bit word in 16-bit fields, no byte SIMD
//       instruction.  The window is staged as field words of bytes b and
//       b + 2, the current rows as biased fields cb and kc (see
//       kFieldBias); per 2 pixels one subtract (cb - ref, which ptxas
//       emits as IMAD.IADD on the FMA pipe), one Hopper VIADDMNMX.U16x2
//       (max(kc + ref, cb - ref) = 256 + |u - v| per field) and half an
//       IADD3 to accumulate: 2.5 instructions per 2 pixels where the TPU's
//       form spent 12.  The VIADDMNMX and the IADD3 share one pipe (a
//       probe on an H100: a 2:1 mix of them runs at the 61 lanes per SM per
//       clock either takes alone), and the whole mix, subtract included,
//       ran at 34 VIADDMNMX lanes per SM per clock: 0.63-0.65 ms per frame
//       of 128 CIF streams for the offsets inside the picture.  It is the
//       gate's check of integer SWAR against the hardware's byte SIMD.
// K4, i8 (<- _sad_kernel_i8): the TPU kernel's arithmetic.  Each byte
//   abs-diff ad = |cur - ref| becomes the int8 ad - 128 (XOR 0x80 per byte,
//   kI8Bias), a signed 8-bit dot product pools them into int32, and + 128
//   per pixel (kI8Excess = 32,768 per MB) undoes the bias after the pool.
//   Exact: an MB's 256 terms lie in -128..127, so their sum lies in
//   -32,768..32,512, far inside int32, and + 32,768 gives the SAD in
//   0..65,280.  The TPU pooled the biased bytes on its int8 matrix unit;
//   here the pool is IDP4A.S8 (__dp4a with 0x01010101), 4 terms per
//   instruction.  K2's tiles, staging, 4 byte alignments and thread tile
//   (4 dx x 8 dy of one MB, kernels/me_variants_cuda.py::i8_tiles): per 4
//   pixels one VABSDIFF4 without accumulate and one LOP3 on the integer
//   lanes, and the IDP4A beside them on another pipe, so the loop spends
//   2 integer-lane instructions per 4 pixels: 0.337 ms per frame of 128 CIF
//   streams for the offsets inside the picture, 0.433 ms over the padded
//   32 x 32 offsets and 24 MB slots of a CIF row that the tiles compute.
//   The map is staged over the window, off-picture entries masked there,
//   and written as runs of MBs.  Registers per thread: acc[8][4] (its 8 dy
//   x 4 dx), the current block's 64 words, and per window row the 16
//   words al[j][k] of the 4 alignments.
//   Measured and dropped at design time (PERF.md): the pool on the int8
//   tensor cores.  With B all ones, a row of A sums into every column of
//   C whatever the order of its k, so mma.sync m16n8k32 s8 took one warp
//   per (8 MBs, 2 dx, 8 dy): lane l held A rows l/4 (MB l/4 at the first
//   dx) and l/4 + 8 (at the second), its k slots the biased words l%4 of
//   current rows r - 1 and r, and C's column 0 of each row summed that
//   (dy, dx, MB) over 8 k-steps.  That spends the same 2 integer-lane
//   instructions per 4 pixels plus an IMMA per 128 words; equal to the
//   plain map, it took 0.948 ms against this kernel's 0.595: an IMMA
//   beside every 8 integer instructions slowed them by 27% in a probe, an
//   IDP4A beside every 2 by 1%.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMb = 16;
constexpr int kMargin = 15;                  // H.261 MV range
constexpr int kThreads = 256;
constexpr int kInvalid = 1 << 30;
constexpr int kStaticSmem = 48 * 1024;       // no opt-in attribute needed
// K2's register tile: 8 dy per thread over the 23 window rows they need,
// read in 4 byte alignments
constexpr int kTileDy = 8;
constexpr int kTileRows = kTileDy + kMb - 1;
constexpr int kAligns = 4;
// K3
constexpr int kRpMaxWidth = 352;             // CIF, the widest H.261 picture
constexpr int kRpSide = 2 * kMargin + 1;     // dx computed per column word
constexpr int kRpHaloWords = 4;              // 16 bytes each side
constexpr int kRpMaxThreads = 128;           // >= kRpMaxWidth / 4, whole warps

// One 16-byte cp.async; with inside false it writes 16 zero bytes and reads
// nothing (src is then any valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool inside) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(inside ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// sum of the 4 byte abs-diffs of a and b, plus acc: one VABSDIFF4.ACC
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(acc));
  return d;
}

// ------------------------------- MB tiles: K2's geometry, also K1, K4, K5

// A block serves up to mb_tile horizontally adjacent MBs of one MB row;
// block (n_dxg, mb_tile, n_dyt), grid (tiles per MB row, MB rows, streams),
// from kernels/me_cuda.py::tile_geometry.  Its window: rows y0 - search ..
// (search_win_rows), byte columns xt - 16 .. (search_win_words words).
__host__ __device__ __forceinline__ int search_win_words(int mb_tile) {
  return 4 * mb_tile + 8;
}

__host__ __device__ __forceinline__ int search_win_rows(int n_dyt) {
  return kTileDy * n_dyt + kMb - 1;
}

// Stage the tile's window (row stride search_win_words) and its current
// rows (row stride 4 mb_tile words) in 16-byte cp.async chunks; x0 - 16 is
// a multiple of 16, so a chunk lies wholly inside or outside the picture,
// and chunks outside it or past a ragged tile's last MB are zero-filled.
__device__ __forceinline__ void stage_tile(
    const uint8_t* cur_plane, const uint8_t* ref_plane, int height,
    int width, int search, int y0, int xt, int mb_tile, int n_here,
    int win_rows, uint32_t* win, uint32_t* cur_s, int tid, int n_threads) {
  const int win_words = search_win_words(mb_tile);
  const int win_chunks = mb_tile + 2;
  for (int i = tid; i < win_rows * win_chunks; i += n_threads) {
    const int r = i / win_chunks;
    const int c = i - r * win_chunks;
    const int py = y0 - search + r;
    const int px = xt - 16 + 16 * c;
    const bool inside = py >= 0 && py < height && px >= 0 && px < width;
    cp_async16(win + r * win_words + 4 * c,
               inside ? ref_plane + (size_t)py * width + px : ref_plane,
               inside);
  }
  for (int i = tid; i < kMb * mb_tile; i += n_threads) {
    const int r = i / mb_tile;
    const int c = i - r * mb_tile;
    const bool inside = c < n_here;
    cp_async16(cur_s + r * 4 * mb_tile + 4 * c,
               inside ? cur_plane + (size_t)(y0 + r) * width + xt + 16 * c
                      : cur_plane,
               inside);
  }
  cp_async_wait_all();
}

// Copies 1..3 of a staged window (copy_words words each): copy j is the
// window shifted by j bytes, so that a loop reads every byte alignment with
// plain loads (a row's last word is never read).
__device__ __forceinline__ void shift_copies(uint32_t* win, int copy_words,
                                             int tid, int n_threads) {
  for (int i = tid; i < copy_words; i += n_threads) {
    const uint32_t a = win[i];
    const uint32_t b = i + 1 < copy_words ? win[i + 1] : 0;
    win[copy_words + i] = __funnelshift_r(a, b, 8);
    win[2 * copy_words + i] = __funnelshift_r(a, b, 16);
    win[3 * copy_words + i] = __funnelshift_r(a, b, 24);
  }
}

// Write a tile's map, staged as map_s[o * mb_tile + m], into the (streams,
// n_off, n_mb) map: each offset's row holds the tile's MBs side by side, so
// consecutive threads store consecutive MBs.
__device__ __forceinline__ void store_map_tile(const int32_t* map_s,
                                               int32_t* sad_map, int n_off,
                                               int n_mb, int stream, int mb0,
                                               int mb_tile, int n_here,
                                               int tid, int n_threads) {
  int32_t* out = sad_map + (size_t)stream * n_off * n_mb + mb0;
  for (int i = tid; i < n_off * n_here; i += n_threads) {
    const int o = i / n_here;
    const int mm = i - o * n_here;
    out[(size_t)o * n_mb + mm] = map_s[o * mb_tile + mm];
  }
}

// ------------------------------------------------- K2: the fused search

// Shared memory of a tile read in 4 byte alignments (K2, K4): the window in
// 4 copies, copy j shifted by j bytes (the map of a tile aliases them once
// the loop is done), and the current rows.
__host__ __device__ __forceinline__ size_t aligned_tile_smem_bytes(
    int mb_tile, int n_dyt, int search, bool with_map) {
  const int side = 2 * search + 1;
  const size_t win = 4 * (size_t)kAligns * search_win_rows(n_dyt) *
                     search_win_words(mb_tile);
  // whole 16-byte chunks, so that the current rows stay aligned
  const size_t map = with_map ? 16 * (((size_t)side * side * mb_tile + 3) / 4)
                              : 0;
  return (win > map ? win : map) + 4 * (size_t)kMb * 4 * mb_tile;
}

// K2's shared memory: the aligned tile and one key per thread.
__host__ __device__ __forceinline__ size_t search_smem_bytes(
    int mb_tile, int n_dxg, int n_dyt, int search, bool with_map) {
  return aligned_tile_smem_bytes(mb_tile, n_dyt, search, with_map) +
         8 * (size_t)n_dxg * mb_tile * n_dyt;
}

template <bool kMap>
__global__ void __launch_bounds__(kThreads, 2)
sad_search_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ ref, int height, int width,
                  int search, int g_lo, int32_t* __restrict__ mv,
                  int32_t* __restrict__ best_sad, int32_t* __restrict__ sad0,
                  int32_t* __restrict__ sad_map) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_dxg = blockDim.x;
  const int mb_tile = blockDim.y;
  const int n_dyt = blockDim.z;
  const int n_threads = n_dxg * mb_tile * n_dyt;
  const int tid = threadIdx.x + n_dxg * (threadIdx.y + mb_tile * threadIdx.z);
  const int win_words = search_win_words(mb_tile);
  const int win_rows = search_win_rows(n_dyt);
  const int copy_words = win_rows * win_words;
  const int side = 2 * search + 1;
  const size_t win_part = (size_t)kAligns * copy_words;
  const size_t map_part = kMap ? ((size_t)side * side * mb_tile + 3) / 4 * 4
                                : 0;
  uint32_t* win = smem;
  uint32_t* cur_s = win + (win_part > map_part ? win_part : map_part);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(cur_s + kMb * 4 * mb_tile);
  int32_t* map_s = reinterpret_cast<int32_t*>(win);

  const int mb_cols = width / kMb;
  const int n_mb = mb_cols * (height / kMb);
  const int mb_row = blockIdx.y;
  const int stream = blockIdx.z;
  const int mc0 = blockIdx.x * mb_tile;
  const int n_here = min(mb_tile, mb_cols - mc0);
  const int y0 = mb_row * kMb;
  const int xt = mc0 * kMb;
  const size_t plane = (size_t)height * width;
  const uint8_t* ref_plane = ref + stream * plane;
  const uint8_t* cur_plane = cur + stream * plane;

  stage_tile(cur_plane, ref_plane, height, width, search, y0, xt, mb_tile,
             n_here, win_rows, win, cur_s, tid, n_threads);
  __syncthreads();
  shift_copies(win, copy_words, tid, n_threads);
  __syncthreads();

  const int m = threadIdx.y;
  const int t = threadIdx.z;
  const int g = g_lo + threadIdx.x;  // byte columns 4g .. 4g+3

  uint32_t c[kMb * 4];
  const uint4* cur4 = reinterpret_cast<const uint4*>(cur_s);
#pragma unroll
  for (int r = 0; r < kMb; ++r) {
    const uint4 v = cur4[r * mb_tile + m];
    c[4 * r + 0] = v.x;
    c[4 * r + 1] = v.y;
    c[4 * r + 2] = v.z;
    c[4 * r + 3] = v.w;
  }

  // acc[i][j]: dy + search = kTileDy * t + i, dx + 16 = 4 g + j
  uint32_t acc[kTileDy][4];
#pragma unroll
  for (int i = 0; i < kTileDy; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const uint32_t* p = win + kTileDy * t * win_words + 4 * m + g;
#pragma unroll
  for (int q = 0; q < kTileRows; ++q) {
    uint32_t al[4][4];  // al[j][k]: bytes 4(g+k)+j .. of window row q
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        al[j][k] = p[j * copy_words + q * win_words + k];
#pragma unroll
    for (int i = 0; i < kTileDy; ++i) {
      const int r = q - i;  // row of the current block under this dy
      if (r < 0 || r >= kMb) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[i][j] = sad4(al[j][k], c[4 * r + k], acc[i][j]);
    }
  }

  // Which of the thread's offsets are in the search and inside the
  // picture: all-ones penalties for the others, so that `acc | pen` never
  // wins.  The winner always lies inside ((0, 0) does), so an offset off
  // the picture can never be the first minimum.
  const int x0 = xt + kMb * m;
  const int di_lo = max(0, search - y0);        // dy >= -y0
  const int di_hi = min(side - 1, search + height - kMb - y0);
  const int dx_lo = max(-search, -x0);
  const int dx_hi = min(search, width - kMb - x0);
  uint32_t row_pen[kTileDy], col_pen[4];
#pragma unroll
  for (int i = 0; i < kTileDy; ++i) {
    const int di = kTileDy * t + i;
    row_pen[i] = m < n_here && di >= di_lo && di <= di_hi ? 0u : ~0u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int dx = 4 * g + j - 16;
    col_pen[j] = dx >= dx_lo && dx <= dx_hi ? 0u : ~0u;
  }
  // offsets in increasing o, so a strict < keeps the first minimum
  const int o0 = kTileDy * t * side + 4 * g - 16 + search;
  uint32_t best = ~0u;
  int best_o = -1;
#pragma unroll
  for (int i = 0; i < kTileDy; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t v = acc[i][j] | row_pen[i] | col_pen[j];
      if (v < best) {
        best = v;
        best_o = o0 + i * side + j;
      }
    }
  }
  const size_t at0 = (size_t)stream * n_mb + mb_row * mb_cols + mc0;
  if (m < n_here && t == search / kTileDy && g == 4) {
    uint32_t v = 0;  // dy = dx = 0: i = search % kTileDy, j = 0
#pragma unroll
    for (int i = 0; i < kTileDy; ++i)
      if (i == search % kTileDy) v = acc[i][0];
    sad0[at0 + m] = (int)v;
  }
  if (kMap) {
    __syncthreads();  // the map aliases the window copies
#pragma unroll
    for (int i = 0; i < kTileDy; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int di = kTileDy * t + i;
        const int dx = 4 * g + j - 16;
        if (m < n_here && di < side && dx >= -search && dx <= search)
          map_s[(di * side + dx + search) * mb_tile + m] =
              (row_pen[i] | col_pen[j]) ? kInvalid : (int)acc[i][j];
      }
    }
  }
  keys[tid] = best_o < 0 ? ~0ull
                         : ((unsigned long long)best << 32) | (uint32_t)best_o;
  __syncthreads();

  // the lexicographic (sad, o) minimum per MB: over dx groups, then dy tiles
  if (threadIdx.x == 0) {
    unsigned long long b = keys[tid];
    for (int x = 1; x < n_dxg; ++x) b = keys[tid + x] < b ? keys[tid + x] : b;
    keys[tid] = b;
  }
  __syncthreads();
  if (tid < n_here) {
    unsigned long long b = ~0ull;
    for (int tt = 0; tt < n_dyt; ++tt) {
      const unsigned long long k = keys[(tt * mb_tile + tid) * n_dxg];
      b = k < b ? k : b;
    }
    const int o = (int)(b & 0xffffffffu);
    best_sad[at0 + tid] = (int)(b >> 32);
    mv[2 * (at0 + tid) + 0] = o % side - search;  // mvx
    mv[2 * (at0 + tid) + 1] = o / side - search;  // mvy
  }
  if (kMap)
    store_map_tile(map_s, sad_map, side * side, n_mb, stream,
                   mb_row * mb_cols + mc0, mb_tile, n_here, tid, n_threads);
}

// ------------------------------------------------ K1: f32 and K5: swar

// K5's field arithmetic.  A word holds two pixels in 16-bit fields (bytes
// x and x + 2 of a row at bits 0 and 16).  With cb = cur + 0x01000100 and
// kc = 0x02000200 - cb = 0x01000100 - cur, both staged once per block:
//   d1 = cb - ref        per field 256 + u - v, in 1..511: the field of cb
//                        is >= 256 > v, so no borrow crosses a field
//   kc + ref             per field 256 - u + v, in 1..511 (16-bit adds)
//   max(kc + ref, d1)    = 256 + |u - v|: one VIADDMNMX.U16x2
// and the fields accumulate those unmasked.  A thread's accumulator of one
// offset takes 16 rows x 8 words = 128 terms per field, <= 128 x 511 =
// 65,408 < 2^16, so no field ever carries into the next; the two fields
// then sum to SAD + 2 x 128 x 256.
constexpr uint32_t kFieldBias = 0x01000100u;
constexpr int kSwarExcess = 2 * 128 * 256;

// elements of one window row of K1's floats and K5's field words: one per
// byte column of the staged window
__host__ __device__ __forceinline__ int map_win_row(int mb_tile) {
  return 4 * search_win_words(mb_tile);
}

// Shared memory of K1 and K5 (elements of 4 bytes): the window, one element
// per byte column, which the tile's map aliases once it is computed; the
// current rows, 16 elements per (row, MB); then the bytes that cp.async
// staged, window and current rows, which the first two are made from.
__host__ __device__ __forceinline__ size_t map_tile_smem_bytes(int mb_tile,
                                                                int n_dyt,
                                                                int search) {
  const int side = 2 * search + 1;
  const size_t win =
      4 * (size_t)search_win_rows(n_dyt) * map_win_row(mb_tile);
  const size_t map = 16 * (((size_t)side * side * mb_tile + 3) / 4);
  const size_t cur = 4 * (size_t)kMb * kMb * mb_tile;
  const size_t raw = win / 4 + (size_t)kMb * kMb * mb_tile;
  return (win > map ? win : map) + cur + raw;
}

// one 16-byte shared load into 4 registers
template <typename T4, typename T>
__device__ __forceinline__ void load4(const T4* src, T* dst) {
  const T4 v = *src;
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// The map of a tile of MBs in K2's geometry: thread (x, m, t) owns dx =
// 4 (g_lo + x) + j - 16 for j < 4 and dy + search = 8 t + i for i < 8 of MB
// m.  It walks the 23 window rows its dy need once: per row it loads the
// 20 window elements at byte columns 16 m + 4 g .. of that row (5 x 16
// bytes), and for each of its dy whose 16 rows hold that row, the MB's
// current row (4 x 16 bytes, the same for the 8 threads of an MB in a
// quarter warp), which serve its 4 dx.
template <bool kF32>
__device__ __forceinline__ void sad_map_tile(const uint8_t* __restrict__ cur,
                                             const uint8_t* __restrict__ ref,
                                             int height, int width,
                                             int search, int g_lo,
                                             int32_t* __restrict__ out) {
  using T = typename std::conditional<kF32, float, uint32_t>::type;
  using T4 = typename std::conditional<kF32, float4, uint4>::type;
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_dxg = blockDim.x;
  const int mb_tile = blockDim.y;
  const int n_dyt = blockDim.z;
  const int n_threads = n_dxg * mb_tile * n_dyt;
  const int tid = threadIdx.x + n_dxg * (threadIdx.y + mb_tile * threadIdx.z);
  const int win_rows = search_win_rows(n_dyt);
  const int row = map_win_row(mb_tile);
  const int side = 2 * search + 1;
  const int n_off = side * side;
  const size_t win_part = (size_t)win_rows * row;
  const size_t map_part = ((size_t)n_off * mb_tile + 3) / 4 * 4;
  T* win = reinterpret_cast<T*>(smem);
  T* cur_s = win + (win_part > map_part ? win_part : map_part);
  uint32_t* raw_win =
      reinterpret_cast<uint32_t*>(cur_s + kMb * kMb * mb_tile);
  uint32_t* raw_cur = raw_win + win_part / 4;
  int32_t* map_s = reinterpret_cast<int32_t*>(smem);

  const int mb_cols = width / kMb;
  const int n_mb = mb_cols * (height / kMb);
  const int mb_row = blockIdx.y;
  const int stream = blockIdx.z;
  const int mc0 = blockIdx.x * mb_tile;
  const int n_here = min(mb_tile, mb_cols - mc0);
  const int y0 = mb_row * kMb;
  const int xt = mc0 * kMb;
  const size_t plane = (size_t)height * width;
  stage_tile(cur + stream * plane, ref + stream * plane, height, width,
             search, y0, xt, mb_tile, n_here, win_rows, raw_win, raw_cur, tid,
             n_threads);
  __syncthreads();
  // the window, one element per byte column b: K1 the float of byte b, K5
  // the field word of bytes b and b + 2 (a row's last two are never read)
  const int raw_words = (int)(win_part / 4);
  for (int i = tid; i < raw_words; i += n_threads) {
    const uint32_t a = raw_win[i];
    const uint32_t b = i + 1 < raw_words ? raw_win[i + 1] : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kF32)
        win[4 * i + k] = (float)((a >> (8 * k)) & 0xFFu);
      else
        win[4 * i + k] = __funnelshift_r(a, b, 8 * k) & 0x00FF00FFu;
    }
  }
  // current row r of MB m at cur_s[16 (r mb_tile + m)]: K1 its 16 floats,
  // K5 cb of fields x = 0, 1, 4, 5, 8, 9, 12, 13, then kc of the same
  for (int i = tid; i < kMb * mb_tile * 4; i += n_threads) {
    const uint32_t w = raw_cur[i];  // pixels 4c .. 4c + 3 of row r, MB m
    T* dst = cur_s + 16 * (i / 4);
    const int c = i % 4;
    if constexpr (kF32) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[4 * c + k] = (float)((w >> (8 * k)) & 0xFFu);
    } else {
      const uint32_t lo = w & 0x00FF00FFu;         // pixels 4c, 4c + 2
      const uint32_t hi = (w >> 8) & 0x00FF00FFu;  // pixels 4c + 1, 4c + 3
      dst[2 * c] = lo + kFieldBias;
      dst[2 * c + 1] = hi + kFieldBias;
      dst[8 + 2 * c] = kFieldBias - lo;
      dst[8 + 2 * c + 1] = kFieldBias - hi;
    }
  }
  __syncthreads();

  const int m = threadIdx.y;
  const int t = threadIdx.z;
  const int g = g_lo + threadIdx.x;
  // acc[i][j]: dy + search = kTileDy * t + i, dx + 16 = 4 g + j
  T acc[kTileDy][4];
#pragma unroll
  for (int i = 0; i < kTileDy; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const T* wp = win + kTileDy * t * row + kMb * m + 4 * g;
  const T* cp = cur_s + 16 * m;
#pragma unroll 1
  for (int q = 0; q < kTileRows; ++q) {
    T p[20];  // byte columns 16 m + 4 g + 0 .. 19 of window row q
#pragma unroll
    for (int u = 0; u < 5; ++u)
      load4(reinterpret_cast<const T4*>(wp + q * row) + u, p + 4 * u);
#pragma unroll
    for (int i = 0; i < kTileDy; ++i) {
      const int r = q - i;  // row of the current block under this dy
      if (r < 0 || r >= kMb) continue;
      T c[16];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        load4(reinterpret_cast<const T4*>(cp + 16 * mb_tile * r) + u,
              c + 4 * u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kF32) {
#pragma unroll
          for (int k = 0; k < kMb; ++k) acc[i][j] += fabsf(c[k] - p[j + k]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const uint32_t v = p[j + 4 * (k >> 1) + (k & 1)];
            acc[i][j] += __viaddmax_u16x2(c[8 + k], v, c[k] - v);
          }
        }
      }
    }
  }

  // the tile's map in shared memory, over the window, then runs of MBs
  const int x0 = xt + kMb * m;
  const int di_lo = max(0, search - y0);  // dy >= -y0
  const int di_hi = min(side - 1, search + height - kMb - y0);
  const int dx_lo = max(-search, -x0);
  const int dx_hi = min(search, width - kMb - x0);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTileDy; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int di = kTileDy * t + i;
      const int dx = 4 * g + j - 16;
      if (m < n_here && di < side && dx >= -search && dx <= search) {
        int sad;
        if constexpr (kF32)
          sad = (int)acc[i][j];
        else
          sad = (int)((acc[i][j] & 0xFFFFu) + (acc[i][j] >> 16)) -
                kSwarExcess;
        const bool inside =
            di >= di_lo && di <= di_hi && dx >= dx_lo && dx <= dx_hi;
        map_s[(di * side + dx + search) * mb_tile + m] =
            inside ? sad : kInvalid;
      }
    }
  }
  __syncthreads();
  store_map_tile(map_s, out, n_off, n_mb, stream, mb_row * mb_cols + mc0,
                 mb_tile, n_here, tid, n_threads);
}

// Blocks per SM (measured, PERF.md): K1 fits 64 registers unspilled and
// gains from a fourth block; K5 loses with a fourth and keeps three.
__global__ void __launch_bounds__(kThreads, 4)
sad_map_f32_kernel(const uint8_t* __restrict__ cur,
                   const uint8_t* __restrict__ ref, int height, int width,
                   int search, int g_lo, int32_t* __restrict__ out) {
  sad_map_tile<true>(cur, ref, height, width, search, g_lo, out);
}

__global__ void __launch_bounds__(kThreads, 3)
sad_map_swar_kernel(const uint8_t* __restrict__ cur,
                    const uint8_t* __restrict__ ref, int height, int width,
                    int search, int g_lo, int32_t* __restrict__ out) {
  sad_map_tile<false>(cur, ref, height, width, search, g_lo, out);
}

// ----------------------------------------------------------------- K3: rp

__global__ void __launch_bounds__(kRpMaxThreads)
sad_map_rp_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ ref, int height, int width,
                  int search, int dy_per_block, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int words = width / 4;                     // column words per row
  const int row_words = words + 2 * kRpHaloWords;  // a staged reference row
  const int side = 2 * search + 1;
  const int n_off = side * side;
  const int dyi0 = blockIdx.x * dy_per_block;      // first dy + search
  const int n_dy = min(dy_per_block, side - dyi0);
  const int mb_row = blockIdx.y;
  const int stream = blockIdx.z;
  const int y0 = mb_row * kMb;
  const int mb_cols = width / kMb;
  const int n_mb = mb_cols * (height / kMb);
  const size_t plane = (size_t)height * width;
  const uint8_t* cur_plane = cur + stream * plane;
  const uint8_t* ref_plane = ref + stream * plane;
  uint32_t* cur_s = smem;                          // 16 rows
  uint32_t* ref_s = cur_s + kMb * words;           // n_dy + 15 rows
  int32_t* out_s = out + (size_t)stream * n_off * n_mb + mb_row * mb_cols;

  // current rows, then reference rows y0 + dy .. with 16 bytes of halo
  const int chunks = width / 16;
  for (int i = threadIdx.x; i < kMb * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i % chunks;
    cp_async16(cur_s + r * words + 4 * c,
               cur_plane + (size_t)(y0 + r) * width + 16 * c, true);
  }
  const int ref_rows = n_dy + kMb - 1;
  for (int i = threadIdx.x; i < ref_rows * (chunks + 2); i += blockDim.x) {
    const int r = i / (chunks + 2);
    const int c = i % (chunks + 2);
    const int py = y0 + dyi0 - search + r;
    const int px = 16 * c - 16;
    const bool inside = py >= 0 && py < height && px >= 0 && px < width;
    cp_async16(ref_s + r * row_words + 4 * c,
               inside ? ref_plane + (size_t)py * width + px : ref_plane,
               inside);
  }
  cp_async_wait_all();
  __syncthreads();

  const int k = threadIdx.x;  // pixel columns 4k .. 4k+3
  const bool active = k < words;
  uint32_t c[kMb];
#pragma unroll
  for (int r = 0; r < kMb; ++r) c[r] = active ? cur_s[r * words + k] : 0;
  const int kc = active ? k : 0;  // idle lanes read a valid word

  for (int u = 0; u < n_dy; ++u) {
    const int dyi = dyi0 + u;
    const int dy = dyi - search;
    if (y0 + dy < 0 || y0 + dy + kMb > height) {
      // the whole MB row's window leaves the picture at this dy
      for (int i = threadIdx.x; i < side * mb_cols; i += blockDim.x)
        out_s[(size_t)(dyi * side + i / mb_cols) * n_mb + i % mb_cols] =
            kInvalid;
      continue;
    }
    // For dx = d - 15: odd[d] holds the 16-row sums of columns 1 and 3 as
    // 16-bit fields; all[d] sums the packed abs-diff words mod 2^32, so
    // all - (odd << 8) leaves those of columns 0 and 2.
    uint32_t all[kRpSide], odd[kRpSide];
#pragma unroll
    for (int d = 0; d < kRpSide; ++d) all[d] = odd[d] = 0;
    const uint32_t* p = ref_s + u * row_words + kc;
#pragma unroll
    for (int r = 0; r < kMb; ++r) {
      uint32_t w[9];  // staged bytes 4k .. 4k+35 = picture x-16 .. x+19
#pragma unroll
      for (int i = 0; i < 9; ++i) w[i] = p[r * row_words + i];
#pragma unroll
      for (int d = 0; d < kRpSide; ++d) {
        const int b = d + 1;  // staged byte of dx = d - 15, past 4k
        const uint32_t rw =
            (b & 3) ? __funnelshift_r(w[b >> 2], w[(b >> 2) + 1], 8 * (b & 3))
                    : w[b >> 2];
        const uint32_t ad = __vabsdiffu4(rw, c[r]);
        all[d] += ad;
        odd[d] += __byte_perm(ad, 0, 0x4341);
      }
    }
#pragma unroll
    for (int d = 0; d < kRpSide; ++d) {
      // columns 0+1 and 2+3 as 16-bit fields
      const uint32_t f = all[d] - (odd[d] << 8) + odd[d];
      int sum = (int)((f & 0xFFFFu) + (f >> 16));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);  // the MB's 16 columns
      const int dx = d - kMargin;
      if (active && (k & 3) == 0 && dx >= -search && dx <= search) {
        const int mc = k >> 2;
        const int x0 = mc * kMb;
        out_s[(size_t)(dyi * side + dx + search) * n_mb + mc] =
            (x0 + dx >= 0 && x0 + dx + kMb <= width) ? sum : kInvalid;
      }
    }
  }
}

// ----------------------------------------------------------------- K4: i8

// Per byte: ad ^ 0x80 is ad - 128 read as int8 (ad = |cur - ref| <= 255);
// a 16x16 MB's 256 terms sum to SAD - kI8Excess.
constexpr uint32_t kI8Bias = 0x80808080u;
constexpr int kI8Excess = 128 * kMb * kMb;

__device__ __forceinline__ uint32_t biased_absdiff4(uint32_t a, uint32_t b) {
  return __vabsdiffu4(a, b) ^ kI8Bias;
}

// K2's map mode with K4's arithmetic: thread (x, m, t) owns dx = 4 (g_lo +
// x) + j - 16 for j < 4 and dy + search = 8 t + i for i < 8 of MB m; per
// window row it loads its 4 words in each of the 4 byte alignments and,
// for each of its dy whose 16 rows hold that row, pools 16 biased words
// into each of its 4 dx.  The current block stays in 64 registers.
__global__ void __launch_bounds__(kThreads, 2)
sad_map_i8_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ ref, int height, int width,
                  int search, int g_lo, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_dxg = blockDim.x;
  const int mb_tile = blockDim.y;
  const int n_dyt = blockDim.z;
  const int n_threads = n_dxg * mb_tile * n_dyt;
  const int tid = threadIdx.x + n_dxg * (threadIdx.y + mb_tile * threadIdx.z);
  const int win_words = search_win_words(mb_tile);
  const int win_rows = search_win_rows(n_dyt);
  const int copy_words = win_rows * win_words;
  const int side = 2 * search + 1;
  const int n_off = side * side;
  const size_t win_part = (size_t)kAligns * copy_words;
  const size_t map_part = ((size_t)n_off * mb_tile + 3) / 4 * 4;
  uint32_t* win = smem;
  uint32_t* cur_s = win + (win_part > map_part ? win_part : map_part);
  int32_t* map_s = reinterpret_cast<int32_t*>(smem);

  const int mb_cols = width / kMb;
  const int n_mb = mb_cols * (height / kMb);
  const int mb_row = blockIdx.y;
  const int stream = blockIdx.z;
  const int mc0 = blockIdx.x * mb_tile;
  const int n_here = min(mb_tile, mb_cols - mc0);
  const int y0 = mb_row * kMb;
  const int xt = mc0 * kMb;
  const size_t plane = (size_t)height * width;
  stage_tile(cur + stream * plane, ref + stream * plane, height, width,
             search, y0, xt, mb_tile, n_here, win_rows, win, cur_s, tid,
             n_threads);
  __syncthreads();
  shift_copies(win, copy_words, tid, n_threads);
  __syncthreads();

  const int m = threadIdx.y;
  const int t = threadIdx.z;
  const int g = g_lo + threadIdx.x;
  uint32_t c[kMb * 4];
  const uint4* cur4 = reinterpret_cast<const uint4*>(cur_s);
#pragma unroll
  for (int r = 0; r < kMb; ++r) {
    const uint4 v = cur4[r * mb_tile + m];
    c[4 * r + 0] = v.x;
    c[4 * r + 1] = v.y;
    c[4 * r + 2] = v.z;
    c[4 * r + 3] = v.w;
  }
  // acc[i][j]: dy + search = kTileDy * t + i, dx + 16 = 4 g + j
  int acc[kTileDy][4];
#pragma unroll
  for (int i = 0; i < kTileDy; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const uint32_t* p = win + kTileDy * t * win_words + 4 * m + g;
#pragma unroll
  for (int q = 0; q < kTileRows; ++q) {
    uint32_t al[4][4];  // al[j][k]: bytes 4(g+k)+j .. of window row q
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        al[j][k] = p[j * copy_words + q * win_words + k];
#pragma unroll
    for (int i = 0; i < kTileDy; ++i) {
      const int r = q - i;  // row of the current block under this dy
      if (r < 0 || r >= kMb) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[i][j] = __dp4a((int)biased_absdiff4(al[j][k], c[4 * r + k]),
                             0x01010101, acc[i][j]);
    }
  }

  const int x0 = xt + kMb * m;
  const int di_lo = max(0, search - y0);
  const int di_hi = min(side - 1, search + height - kMb - y0);
  const int dx_lo = max(-search, -x0);
  const int dx_hi = min(search, width - kMb - x0);
  __syncthreads();  // the map aliases the window copies
#pragma unroll
  for (int i = 0; i < kTileDy; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int di = kTileDy * t + i;
      const int dx = 4 * g + j - 16;
      if (m < n_here && di < side && dx >= -search && dx <= search) {
        const bool inside =
            di >= di_lo && di <= di_hi && dx >= dx_lo && dx <= dx_hi;
        map_s[(di * side + dx + search) * mb_tile + m] =
            inside ? acc[i][j] + kI8Excess : kInvalid;
      }
    }
  }
  __syncthreads();
  store_map_tile(map_s, out, n_off, n_mb, stream, mb_row * mb_cols + mc0,
                 mb_tile, n_here, tid, n_threads);
}

int check_args(int streams, int height, int width, int search) {
  if (streams <= 0 || streams > 65535 || height <= 0 || width <= 0 ||
      height % kMb != 0 || width % kMb != 0 || search < 0 ||
      search > kMargin)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// A tile geometry (kernels/me_cuda.py::tile_geometry) the tiled kernels
// take: the thread grid covers byte columns 16 - search .. 16 + search and
// the 2 search + 1 dy, the tiles cover the MB row with no empty tile, and
// the block fits kThreads and the static shared memory.
bool tiles_ok(int width, int search, int tiles_per_row, int mb_tile,
              int g_lo, int n_dxg, int n_dyt, size_t smem) {
  const int mb_cols = width / kMb;
  return mb_tile >= 1 && n_dxg >= 1 && n_dyt >= 1 && g_lo >= 0 &&
         g_lo + n_dxg <= 8 && 4 * g_lo <= 16 - search &&
         4 * (g_lo + n_dxg) > 16 + search &&
         kTileDy * n_dyt >= 2 * search + 1 &&
         tiles_per_row * mb_tile >= mb_cols &&
         (tiles_per_row - 1) * mb_tile < mb_cols &&
         n_dxg * mb_tile * n_dyt <= kThreads && smem <= (size_t)kStaticSmem;
}

using TileMapKernel = void (*)(const uint8_t*, const uint8_t*, int, int, int,
                               int, int32_t*);

// Launch a map kernel that takes block (n_dxg, mb_tile, n_dyt) and `smem`
// bytes of shared memory: K1, K4, K5.
int launch_tile_map(TileMapKernel kernel, size_t smem, const void* cur,
                    const void* ref, int streams, int height, int width,
                    int search, int tiles_per_row, int mb_tile, int g_lo,
                    int n_dxg, int n_dyt, void* out, void* stream) {
  if (int rc = check_args(streams, height, width, search)) return rc;
  if (!tiles_ok(width, search, tiles_per_row, mb_tile, g_lo, n_dxg, n_dyt,
                smem))
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(tiles_per_row, height / kMb, streams),
           dim3(n_dxg, mb_tile, n_dyt), smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
      height, width, search, g_lo, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  cur/ref: (streams, height, width) uint8,
// contiguous on the current device, 16-byte aligned (every kernel stages
// them with cp.async).  Each launches
// on `stream`, does not synchronise, and returns the cudaGetLastError()
// code of the launch (0 on success, cudaErrorInvalidValue for arguments or
// a geometry it does not take).

// Outputs int32: mv (streams, nMB, 2), best_sad and sad0 (streams, nMB),
// sad_map (streams, (2s+1)^2, nMB) or NULL.  The geometry comes from
// kernels/me_cuda.py::search_tiles.
extern "C" int p64_sad_search(const void* cur, const void* ref, int streams,
                              int height, int width, int search,
                              int tiles_per_row, int mb_tile, int g_lo,
                              int n_dxg, int n_dyt, void* mv, void* best_sad,
                              void* sad0, void* sad_map, void* stream) {
  if (int rc = check_args(streams, height, width, search)) return rc;
  const bool with_map = sad_map != nullptr;
  const size_t smem =
      search_smem_bytes(mb_tile, n_dxg, n_dyt, search, with_map);
  if (!tiles_ok(width, search, tiles_per_row, mb_tile, g_lo, n_dxg, n_dyt,
                smem))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles_per_row, height / kMb, streams);
  const dim3 block(n_dxg, mb_tile, n_dyt);
  const auto kernel =
      with_map ? sad_search_kernel<true> : sad_search_kernel<false>;
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
      height, width, search, g_lo, static_cast<int32_t*>(mv),
      static_cast<int32_t*>(best_sad), static_cast<int32_t*>(sad0),
      static_cast<int32_t*>(sad_map));
  return (int)cudaGetLastError();
}

// The map kernels' output: out (streams, (2s+1)^2, nMB) int32.  K1's and
// K5's geometry comes from kernels/me_variants_cuda.py::map_tiles.
extern "C" int p64_sad_map_f32(const void* cur, const void* ref, int streams,
                               int height, int width, int search,
                               int tiles_per_row, int mb_tile, int g_lo,
                               int n_dxg, int n_dyt, void* out,
                               void* stream) {
  return launch_tile_map(sad_map_f32_kernel,
                         map_tile_smem_bytes(mb_tile, n_dyt, search), cur,
                         ref, streams, height, width, search, tiles_per_row,
                         mb_tile, g_lo, n_dxg, n_dyt, out, stream);
}

// rp's geometry comes from kernels/me_variants_cuda.py::rp_geometry.
extern "C" int p64_sad_map_rp(const void* cur, const void* ref, int streams,
                              int height, int width, int search,
                              int dy_per_block, int threads, void* out,
                              void* stream) {
  if (int rc = check_args(streams, height, width, search)) return rc;
  const int side = 2 * search + 1;
  const size_t smem = 4 * ((size_t)kMb * (width / 4) +
                           (size_t)(dy_per_block + kMb - 1) *
                               (width / 4 + 2 * kRpHaloWords));
  if (width > kRpMaxWidth || dy_per_block < 1 || threads % 32 != 0 ||
      threads < width / 4 || threads > kRpMaxThreads ||
      smem > (size_t)kStaticSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((side + dy_per_block - 1) / dy_per_block, height / kMb,
                  streams);
  sad_map_rp_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
      height, width, search, dy_per_block, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// K4's geometry comes from kernels/me_variants_cuda.py::i8_tiles.
extern "C" int p64_sad_map_i8(const void* cur, const void* ref, int streams,
                              int height, int width, int search,
                              int tiles_per_row, int mb_tile, int g_lo,
                              int n_dxg, int n_dyt, void* out, void* stream) {
  return launch_tile_map(sad_map_i8_kernel,
                         aligned_tile_smem_bytes(mb_tile, n_dyt, search, true),
                         cur, ref, streams, height, width, search,
                         tiles_per_row, mb_tile, g_lo, n_dxg, n_dyt, out,
                         stream);
}

extern "C" int p64_sad_map_swar(const void* cur, const void* ref, int streams,
                                int height, int width, int search,
                                int tiles_per_row, int mb_tile, int g_lo,
                                int n_dxg, int n_dyt, void* out,
                                void* stream) {
  return launch_tile_map(sad_map_swar_kernel,
                         map_tile_smem_bytes(mb_tile, n_dyt, search), cur,
                         ref, streams, height, width, search, tiles_per_row,
                         mb_tile, g_lo, n_dxg, n_dyt, out, stream);
}

// Message for a code returned by the entry points above.
extern "C" const char* p64_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
