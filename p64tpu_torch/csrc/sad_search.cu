// Fused full-search SAD motion estimation for H.261 macroblocks (sm_90a).
//
// Replaces the TPU kernel p64tpu/kernels/me_pallas.py::_sad_kernel_bf16 /
// sad_map_pallas_bf16 together with the argmin that me.py::full_search ran
// on its output.  Contract (p64tpu/kernels/me.py):
//   * per stream and 16x16 macroblock, SAD = sum |cur - ref| at every
//     (dy, dx) in [-search, search]^2, offsets in dy-major order;
//   * an offset whose window leaves the picture gets SAD 1<<30;
//   * the winner is the FIRST minimum in that order; sad0 is the SAD at
//     (0, 0).
//
// What bounds it on the card: integer abs-diff throughput out of shared
// memory.  Each macroblock costs 961 x 256 byte abs-diffs at search 15,
// about 12.5 G per frame for 128 CIF streams, against about 26 MB of input
// per frame at 128 CIF streams (about 200 KB per stream); device memory is
// not the limit.
//
// What the design does about it (the simple first version):
//   * one block per (stream, macroblock); the 16x16 current block and the
//     reference window (rows y0-15 .. y0+30, columns x0-16 .. x0+31; pixels
//     outside the picture read as 0 and are never used by a valid offset)
//     are staged once in shared memory as 32-bit words;
//   * each thread keeps the current block in 64 registers and walks its
//     share of the offsets; one row of 16 pixels is 5 aligned word loads,
//     4 funnel shifts to the offset's byte alignment and 4 __vsadu4, i.e.
//     4 pixels per SIMD instruction instead of one;
//   * the (sad, offset) pairs are reduced in lexicographic order as one
//     64-bit key (sad << 32 | offset), which keeps the first minimum;
//   * the dense (S, 961, nMB) map is written only when asked for (parity
//     checks); on the encoder's path it never reaches device memory.
// Left for later: several macroblocks per block sharing one window,
// register tiling of the window, a persistent grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMb = 16;
constexpr int kMargin = 15;                  // H.261 MV range
constexpr int kWinRows = kMb + 2 * kMargin;  // 46
constexpr int kWinWords = 12;                // 48 bytes: x0-16 .. x0+31
constexpr int kThreads = 256;
constexpr int kInvalid = 1 << 30;

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
  const uint32_t* cur_plane =
      reinterpret_cast<const uint32_t*>(cur + stream * plane);
  const uint32_t* ref_plane =
      reinterpret_cast<const uint32_t*>(ref + stream * plane);
  const int words_per_row = width / 4;

  // Stage the window.  x0 - 16 is a multiple of 16 and width of 16, so a
  // word lies wholly inside or wholly outside the picture.
  for (int i = threadIdx.x; i < kWinRows * kWinWords; i += kThreads) {
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
    if (y0 + dy >= 0 && y0 + dy + kMb <= height && x0 + dx >= 0 &&
        x0 + dx + kMb <= width) {
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

}  // namespace

// Plain C entry point for ctypes.  cur/ref: (streams, height, width) uint8,
// contiguous, on the current device; outputs int32: mv (streams, nMB, 2),
// best_sad and sad0 (streams, nMB), sad_map (streams, (2s+1)^2, nMB) or
// NULL.  Launches on `stream`, does not synchronise, and returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int p64_sad_search(const void* cur, const void* ref, int streams,
                              int height, int width, int search, void* mv,
                              void* best_sad, void* sad0, void* sad_map,
                              void* stream) {
  if (streams <= 0 || height <= 0 || width <= 0 || height % kMb != 0 ||
      width % kMb != 0 || search < 0 || search > kMargin)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((height / kMb) * (width / kMb), streams);
  sad_search_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
      height, width, search, static_cast<int32_t*>(mv),
      static_cast<int32_t*>(best_sad), static_cast<int32_t*>(sad0),
      static_cast<int32_t*>(sad_map));
  return (int)cudaGetLastError();
}

// Message for a code returned by p64_sad_search.
extern "C" const char* p64_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
