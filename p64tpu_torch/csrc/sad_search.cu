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
// What bounds them on the card: integer (or float) instruction throughput.
// Each macroblock costs 961 x 256 abs-diffs at search 15, about 12.5 G per
// frame of 128 CIF streams, against about 26 MB of input per frame (about
// 200 KB per stream); device memory is not the limit of the search.  A
// dense map adds 195 MB of stores per frame of 128 CIF streams, one 4-byte
// store per (offset, MB), not coalesced across MBs.
//
// What the designs do about it (simple first versions):
//   * search, f32, i8, swar: one block per (stream, macroblock); the 16x16
//     current block and the reference window (rows y0-15 .. y0+30, columns
//     x0-16 .. x0+31) are staged once in shared memory, and each thread
//     walks its share of the offsets.  They differ in the inner loop only:
//       - search: the current block in 64 registers; one row of 16 pixels
//         is 5 aligned word loads, 4 funnel shifts to the offset's byte
//         alignment and 4 __vsadu4 (4 pixels per SIMD instruction).  The
//         (sad, offset) pairs are reduced as one 64-bit key
//         (sad << 32 | offset), which keeps the first minimum; the map is
//         written only when asked for, so on the encoder's path it never
//         reaches device memory.
//       - f32 (CUDA cores, no tensor core, no TF32): the window staged as
//         floats, float abs-diff and a float accumulator.  Exact: every
//         partial sum is an integer <= 65,280 < 2^24.
//       - i8: __vabsdiffu4 gives 4 packed |a - b| bytes; XOR 0x80808080
//         turns each into the int8 ad - 128; __dp4a(word, 0x01010101, acc)
//         pools 4 of them per instruction; + 128 * 256 per box undoes the
//         bias.  The TPU fed the biased bytes to its int8 matrix unit; the
//         Hopper analogue, mma.sync / wgmma on s8 operands, is left for a
//         later version.
//       - swar: the TPU's formulation in plain 32-bit integer ops, no byte
//         SIMD intrinsic: bytes 0,2 and 1,3 of each word become two 16-bit
//         fields, pair_absdiff takes |u - v| per field with the 0x01000100
//         bias, the bit-8 mask and a select, and the fields accumulate
//         packed (<= 510 * 4 * 16 = 32,640 < 2^16) until one unpack per
//         box.  Beside the search's __vsadu4 it is the A/B of integer SWAR
//         emulation against the hardware's byte SIMD.
//     i8 and swar read the reference at any byte column through the
//     search's funnel-shift alignment of 32-bit words.
//   * rp: row pool first, as the TPU kernel.  One block per (stream, MB row,
//     dy); each thread owns pixel columns x, keeps the current block's 16
//     rows of its column in registers, and for every dx forms the 16-row
//     column sum of |cur - ref| into shared memory (31 x 352 int32 =
//     43.6 KB at CIF, under the 48 KB static limit; wider pictures are
//     refused).  A second pass pools 16 columns per MB, so the column sums
//     are shared by every MB of the row.  The TPU split the column sums
//     into 64 * hi + lo only so that its bf16 matrix unit would pool them
//     exactly; int32 sums are exact as they are, so there is no split here.
// Left for later: several MBs per block sharing one window, register
// tiling of the window, a persistent grid, a coalesced (MB-fastest) map
// store, s8 tensor cores for the i8 pool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMb = 16;
constexpr int kMargin = 15;                  // H.261 MV range
constexpr int kSideMax = 2 * kMargin + 1;    // 31
constexpr int kWinRows = kMb + 2 * kMargin;  // 46
constexpr int kWinWords = 12;                // 48 bytes: x0-16 .. x0+31
constexpr int kWinCols = 4 * kWinWords;
constexpr int kThreads = 256;
constexpr int kInvalid = 1 << 30;
constexpr int kRpMaxWidth = 352;             // CIF, the widest H.261 picture

__device__ __forceinline__ bool window_inside(int y0, int x0, int dy, int dx,
                                              int height, int width) {
  return y0 + dy >= 0 && y0 + dy + kMb <= height && x0 + dx >= 0 &&
         x0 + dx + kMb <= width;
}

// Stage the reference window and the current block as 32-bit words; pixels
// outside the picture read as 0 and are used by no valid offset.  x0 - 16
// is a multiple of 16 and the width of 16, so a word lies wholly inside or
// wholly outside the picture.
__device__ __forceinline__ void stage_words(const uint32_t* cur_plane,
                                            const uint32_t* ref_plane,
                                            int height, int width, int y0,
                                            int x0, uint32_t* win,
                                            uint32_t* cur_words) {
  const int words_per_row = width / 4;
  for (int i = threadIdx.x; i < kWinRows * kWinWords; i += blockDim.x) {
    const int r = i / kWinWords;
    const int c = i % kWinWords;
    const int py = y0 - kMargin + r;
    const int px = x0 - 16 + 4 * c;
    uint32_t v = 0;
    if (py >= 0 && py < height && px >= 0 && px < width)
      v = ref_plane[py * words_per_row + px / 4];
    win[i] = v;
  }
  if (threadIdx.x < kMb * 4) {
    const int r = threadIdx.x / 4;
    const int c = threadIdx.x % 4;
    cur_words[threadIdx.x] = cur_plane[(y0 + r) * words_per_row + x0 / 4 + c];
  }
}

// ------------------------------------------------- K2: the fused search

__global__ void __launch_bounds__(kThreads)
sad_search_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ ref, int height, int width,
                  int search, int32_t* __restrict__ mv,
                  int32_t* __restrict__ best_sad, int32_t* __restrict__ sad0,
                  int32_t* __restrict__ sad_map) {
  __shared__ uint32_t win[kWinRows * kWinWords];
  __shared__ uint32_t cur_words[kMb * 4];
  __shared__ unsigned long long warp_best[kThreads / 32];

  const int mb_cols = width / kMb;
  const int n_mb = mb_cols * (height / kMb);
  const int stream = blockIdx.y;
  const int mb = blockIdx.x;
  const int y0 = (mb / mb_cols) * kMb;
  const int x0 = (mb % mb_cols) * kMb;
  const size_t plane = (size_t)height * width;
  stage_words(reinterpret_cast<const uint32_t*>(cur + stream * plane),
              reinterpret_cast<const uint32_t*>(ref + stream * plane), height,
              width, y0, x0, win, cur_words);
  __syncthreads();

  uint32_t c[kMb * 4];
#pragma unroll
  for (int i = 0; i < kMb * 4; ++i) c[i] = cur_words[i];

  const int side = 2 * search + 1;
  const int n_off = side * side;
  unsigned long long best = ~0ull;
  for (int o = threadIdx.x; o < n_off; o += kThreads) {
    const int dy = o / side - search;
    const int dx = o % side - search;
    int sad = kInvalid;
    if (window_inside(y0, x0, dy, dx, height, width)) {
      const int col = 16 + dx;                 // byte column in the window
      const int shift = (col & 3) * 8;
      const uint32_t* p = win + (kMargin + dy) * kWinWords + (col >> 2);
      uint32_t acc = 0;
#pragma unroll
      for (int r = 0; r < kMb; ++r) {
        const uint32_t* q = p + r * kWinWords;
        const uint32_t a0 = q[0], a1 = q[1], a2 = q[2], a3 = q[3], a4 = q[4];
        acc += __vsadu4(__funnelshift_r(a0, a1, shift), c[4 * r + 0]);
        acc += __vsadu4(__funnelshift_r(a1, a2, shift), c[4 * r + 1]);
        acc += __vsadu4(__funnelshift_r(a2, a3, shift), c[4 * r + 2]);
        acc += __vsadu4(__funnelshift_r(a3, a4, shift), c[4 * r + 3]);
      }
      sad = (int)acc;
    }
    if (sad_map != nullptr)
      sad_map[((size_t)stream * n_off + o) * n_mb + mb] = sad;
    if (dy == 0 && dx == 0) sad0[(size_t)stream * n_mb + mb] = sad;
    const unsigned long long key =
        ((unsigned long long)(uint32_t)sad << 32) | (uint32_t)o;
    best = key < best ? key : best;
  }

  // Lexicographic (sad, offset) minimum: warp shuffles, then warp 0.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, best, d);
    best = other < best ? other : best;
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? warp_best[lane] : ~0ull;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const unsigned long long other = __shfl_down_sync(0xffffffffu, best, d);
      best = other < best ? other : best;
    }
    if (lane == 0) {
      const int o = (int)(best & 0xffffffffu);
      const size_t at = (size_t)stream * n_mb + mb;
      best_sad[at] = (int)(best >> 32);
      mv[2 * at + 0] = o % side - search;  // mvx
      mv[2 * at + 1] = o / side - search;  // mvy
    }
  }
}

// ---------------------------------------------------------------- K1: f32

__global__ void __launch_bounds__(kThreads)
sad_map_f32_kernel(const uint8_t* __restrict__ cur,
                   const uint8_t* __restrict__ ref, int height, int width,
                   int search, int32_t* __restrict__ out) {
  __shared__ float win[kWinRows * kWinCols];
  __shared__ float cur_px[kMb * kMb];

  const int mb_cols = width / kMb;
  const int n_mb = mb_cols * (height / kMb);
  const int stream = blockIdx.y;
  const int mb = blockIdx.x;
  const int y0 = (mb / mb_cols) * kMb;
  const int x0 = (mb % mb_cols) * kMb;
  const size_t plane = (size_t)height * width;
  const uint8_t* cur_plane = cur + stream * plane;
  const uint8_t* ref_plane = ref + stream * plane;

  for (int i = threadIdx.x; i < kWinRows * kWinCols; i += kThreads) {
    const int py = y0 - kMargin + i / kWinCols;
    const int px = x0 - 16 + i % kWinCols;
    float v = 0.f;
    if (py >= 0 && py < height && px >= 0 && px < width)
      v = (float)ref_plane[(size_t)py * width + px];
    win[i] = v;
  }
  for (int i = threadIdx.x; i < kMb * kMb; i += kThreads)
    cur_px[i] = (float)cur_plane[(size_t)(y0 + i / kMb) * width + x0 + i % kMb];
  __syncthreads();

  const int side = 2 * search + 1;
  const int n_off = side * side;
  for (int o = threadIdx.x; o < n_off; o += kThreads) {
    const int dy = o / side - search;
    const int dx = o % side - search;
    int sad = kInvalid;
    if (window_inside(y0, x0, dy, dx, height, width)) {
      const float* p = win + (kMargin + dy) * kWinCols + 16 + dx;
      float acc = 0.f;
#pragma unroll 4
      for (int r = 0; r < kMb; ++r) {
        float row = 0.f;
#pragma unroll
        for (int c = 0; c < kMb; ++c)
          row += fabsf(cur_px[r * kMb + c] - p[r * kWinCols + c]);
        acc += row;
      }
      sad = (int)acc;
    }
    out[((size_t)stream * n_off + o) * n_mb + mb] = sad;
  }
}

// ----------------------------------------------------------------- K3: rp

__global__ void __launch_bounds__(kThreads)
sad_map_rp_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ ref, int height, int width,
                  int search, int32_t* __restrict__ out) {
  __shared__ int colsum[kSideMax * kRpMaxWidth];

  const int side = 2 * search + 1;
  const int n_off = side * side;
  const int dyi = blockIdx.x;
  const int dy = dyi - search;
  const int mb_row = blockIdx.y;
  const int stream = blockIdx.z;
  const int y0 = mb_row * kMb;
  const int mb_cols = width / kMb;
  const int n_mb = mb_cols * (height / kMb);
  const size_t plane = (size_t)height * width;
  int32_t* out_s = out + (size_t)stream * n_off * n_mb;

  if (y0 + dy < 0 || y0 + dy + kMb > height) {
    // the whole MB row's window leaves the picture at this dy
    for (int i = threadIdx.x; i < side * mb_cols; i += kThreads)
      out_s[(size_t)(dyi * side + i / mb_cols) * n_mb + mb_row * mb_cols +
            i % mb_cols] = kInvalid;
    return;
  }

  // pass 1: colsum[dx][x] = sum over the 16 rows of |cur - ref(dx)|
  const uint8_t* cur_rows = cur + stream * plane + (size_t)y0 * width;
  const uint8_t* ref_rows = ref + stream * plane + (size_t)(y0 + dy) * width;
  for (int x = threadIdx.x; x < width; x += kThreads) {
    int c[kMb];
#pragma unroll
    for (int r = 0; r < kMb; ++r) c[r] = cur_rows[r * width + x];
    for (int dxi = 0; dxi < side; ++dxi) {
      const int xr = x + dxi - search;
      int acc = 0;
      if (xr >= 0 && xr < width) {
#pragma unroll
        for (int r = 0; r < kMb; ++r)
          acc += abs(c[r] - (int)__ldg(ref_rows + r * width + xr));
      }
      colsum[dxi * width + x] = acc;
    }
  }
  __syncthreads();

  // pass 2: pool 16 column sums per MB; starting each MB's walk at column
  // (mb column) mod 16 spreads neighbouring threads over the banks
  for (int i = threadIdx.x; i < side * mb_cols; i += kThreads) {
    const int dxi = i / mb_cols;
    const int mc = i % mb_cols;
    const int x0 = mc * kMb;
    int sad = kInvalid;
    if (window_inside(y0, x0, dy, dxi - search, height, width)) {
      const int* p = colsum + dxi * width + x0;
      sad = 0;
#pragma unroll
      for (int k = 0; k < kMb; ++k) sad += p[(k + mc) & (kMb - 1)];
    }
    out_s[(size_t)(dyi * side + dxi) * n_mb + mb_row * mb_cols + mc] = sad;
  }
}

// ------------------------------------------------------- K4: i8 and K5: swar

__device__ __forceinline__ int row_i8(const uint32_t* q, int shift,
                                      const uint32_t* c, int acc) {
  // ad - 128 as int8 per byte, pooled 4 at a time by a signed dot product
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t ad = __vabsdiffu4(__funnelshift_r(q[k], q[k + 1], shift),
                                     c[k]);
    acc = __dp4a((int)(ad ^ 0x80808080u), 0x01010101, acc);
  }
  return acc;
}

// |u - v| of the two 16-bit fields of a and b (bytes at bits 0 and 16,
// each 0..255): d1 = (u | 256) - v and d2 = (v | 256) - u lie in 1..511,
// and the one with bit 8 set is 256 + |u - v|.  No borrow crosses a field.
__device__ __forceinline__ uint32_t pair_absdiff(uint32_t a, uint32_t b) {
  const uint32_t d1 = (a | 0x01000100u) - b;
  const uint32_t d2 = (b | 0x01000100u) - a;
  const uint32_t mask = ((d1 >> 8) & 0x00010001u) * 0xFFFFu;
  return ((d1 & mask) | (d2 & ~mask)) & 0x00FF00FFu;
}

__device__ __forceinline__ uint32_t row_swar(const uint32_t* q, int shift,
                                             const uint32_t* c,
                                             uint32_t acc) {
  constexpr uint32_t kLo = 0x00FF00FFu;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t w = __funnelshift_r(q[k], q[k + 1], shift);
    acc += pair_absdiff(c[k] & kLo, w & kLo) +
           pair_absdiff((c[k] >> 8) & kLo, (w >> 8) & kLo);
  }
  return acc;
}

template <bool kSwar>
__global__ void __launch_bounds__(kThreads)
sad_map_packed_kernel(const uint8_t* __restrict__ cur,
                      const uint8_t* __restrict__ ref, int height, int width,
                      int search, int32_t* __restrict__ out) {
  __shared__ uint32_t win[kWinRows * kWinWords];
  __shared__ uint32_t cur_words[kMb * 4];

  const int mb_cols = width / kMb;
  const int n_mb = mb_cols * (height / kMb);
  const int stream = blockIdx.y;
  const int mb = blockIdx.x;
  const int y0 = (mb / mb_cols) * kMb;
  const int x0 = (mb % mb_cols) * kMb;
  const size_t plane = (size_t)height * width;
  stage_words(reinterpret_cast<const uint32_t*>(cur + stream * plane),
              reinterpret_cast<const uint32_t*>(ref + stream * plane), height,
              width, y0, x0, win, cur_words);
  __syncthreads();

  uint32_t c[kMb * 4];
#pragma unroll
  for (int i = 0; i < kMb * 4; ++i) c[i] = cur_words[i];

  const int side = 2 * search + 1;
  const int n_off = side * side;
  for (int o = threadIdx.x; o < n_off; o += kThreads) {
    const int dy = o / side - search;
    const int dx = o % side - search;
    int sad = kInvalid;
    if (window_inside(y0, x0, dy, dx, height, width)) {
      const int col = 16 + dx;  // byte column in the window
      const int shift = (col & 3) * 8;
      const uint32_t* p = win + (kMargin + dy) * kWinWords + (col >> 2);
      if (kSwar) {
        uint32_t acc = 0;  // two packed 16-bit field sums
#pragma unroll
        for (int r = 0; r < kMb; ++r)
          acc = row_swar(p + r * kWinWords, shift, c + 4 * r, acc);
        sad = (int)((acc & 0xFFFFu) + (acc >> 16));
      } else {
        int acc = 0;
#pragma unroll
        for (int r = 0; r < kMb; ++r)
          acc = row_i8(p + r * kWinWords, shift, c + 4 * r, acc);
        sad = acc + 128 * kMb * kMb;
      }
    }
    out[((size_t)stream * n_off + o) * n_mb + mb] = sad;
  }
}

int check_args(int streams, int height, int width, int search) {
  if (streams <= 0 || streams > 65535 || height <= 0 || width <= 0 ||
      height % kMb != 0 || width % kMb != 0 || search < 0 ||
      search > kMargin)
    return (int)cudaErrorInvalidValue;
  return 0;
}

using MapKernel = void (*)(const uint8_t*, const uint8_t*, int, int, int,
                           int32_t*);

int launch_map(MapKernel kernel, dim3 grid, const void* cur, const void* ref,
               int height, int width, int search, void* out, void* stream) {
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
      height, width, search, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  cur/ref: (streams, height, width) uint8,
// contiguous and 4-byte aligned, on the current device.  Each launches on
// `stream`, does not synchronise, and returns the cudaGetLastError() code of
// the launch (0 on success).

// Outputs int32: mv (streams, nMB, 2), best_sad and sad0 (streams, nMB),
// sad_map (streams, (2s+1)^2, nMB) or NULL.
extern "C" int p64_sad_search(const void* cur, const void* ref, int streams,
                              int height, int width, int search, void* mv,
                              void* best_sad, void* sad0, void* sad_map,
                              void* stream) {
  if (int rc = check_args(streams, height, width, search)) return rc;
  const dim3 grid((height / kMb) * (width / kMb), streams);
  sad_search_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
      height, width, search, static_cast<int32_t*>(mv),
      static_cast<int32_t*>(best_sad), static_cast<int32_t*>(sad0),
      static_cast<int32_t*>(sad_map));
  return (int)cudaGetLastError();
}

// The map kernels' output: out (streams, (2s+1)^2, nMB) int32.
extern "C" int p64_sad_map_f32(const void* cur, const void* ref, int streams,
                               int height, int width, int search, void* out,
                               void* stream) {
  if (int rc = check_args(streams, height, width, search)) return rc;
  return launch_map(sad_map_f32_kernel,
                    dim3((height / kMb) * (width / kMb), streams), cur, ref,
                    height, width, search, out, stream);
}

extern "C" int p64_sad_map_rp(const void* cur, const void* ref, int streams,
                              int height, int width, int search, void* out,
                              void* stream) {
  if (int rc = check_args(streams, height, width, search)) return rc;
  if (width > kRpMaxWidth) return (int)cudaErrorInvalidValue;
  return launch_map(sad_map_rp_kernel,
                    dim3(2 * search + 1, height / kMb, streams), cur, ref,
                    height, width, search, out, stream);
}

extern "C" int p64_sad_map_i8(const void* cur, const void* ref, int streams,
                              int height, int width, int search, void* out,
                              void* stream) {
  if (int rc = check_args(streams, height, width, search)) return rc;
  return launch_map(sad_map_packed_kernel<false>,
                    dim3((height / kMb) * (width / kMb), streams), cur, ref,
                    height, width, search, out, stream);
}

extern "C" int p64_sad_map_swar(const void* cur, const void* ref, int streams,
                                int height, int width, int search, void* out,
                                void* stream) {
  if (int rc = check_args(streams, height, width, search)) return rc;
  return launch_map(sad_map_packed_kernel<true>,
                    dim3((height / kMb) * (width / kMb), streams), cur, ref,
                    height, width, search, out, stream);
}

// Message for a code returned by the entry points above.
extern "C" const char* p64_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
