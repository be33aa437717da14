// The decode's levels, expanded on the card from the packed form the host
// ships (csrc/levels_pack.cpp, core/decoder.py::stack_seqs) to the dense
// (T, S, nMB, 6, 64) int8 levels8 the reconstruct step reads.  One kernel,
// for sm_90a.
//
// Replaces no TPU kernel: the JAX decoder stacks dense levels on the host and
// copies them whole (p64tpu/core/decoder.py, decode_seq).  It was added
// because that stack and copy were the largest part of a decode job: 622 MB
// of int8 levels for 128 CIF streams x 32 frames, stacked on one host thread
// and copied pageable, of which under 10% are nonzero.  The host now ships
// per MB a mask of its nonzero blocks, per such block a 64-bit mask of its
// nonzero slots, and the nonzero levels.
//
// Design: one CTA per (frame, stream), a run of nMB macroblocks (396 at
// CIF), one thread per MB in the first two steps.
//
//   1. Each thread reads its MB's mask byte; an exclusive scan of the
//      popcounts over the CTA gives the index of the MB's first block mask
//      after the frame's base.
//   2. Each thread reads its MB's block masks; a second scan of their
//      popcounts gives each block's first level after the frame's level
//      base.  Masks and offsets go to shared memory, 12 bytes a block.
//   3. The CTA writes the frame's levels in 16-byte chunks, a quarter block
//      each, consecutive threads on consecutive chunks: a chunk with no bit
//      in its 16 slots stores zeros, another gathers its levels from the
//      packed run at its block's offset plus the popcount of the slots
//      below it.  Every byte of the output is stored exactly once, zero or
//      level, so there is no memset.
//
// Bound: the bytes.  The dense levels written once, 622,854,144 bytes at 128
// CIF streams x 32 frames, plus the packed form read once (about 40 MB on
// the benchmark's content): about 0.2 ms at 3.35 TB/s.  The scans are two
// CTA-wide barriers a frame, hidden behind other CTAs' stores.
//
// Exactness: bytes are copied, never computed.  The masks are the packer's
// own, so a frame's popcounts sum to its share of the packed arrays.
//
// The entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlocks = 6;                          // blocks in an MB
constexpr int kSlots = 64;                          // level slots in a block
constexpr int kChunk = 16;                          // bytes a store writes
constexpr int kChunksPerBlock = kSlots / kChunk;    // 4
constexpr int kMaxMbs = 396;                        // MBs of a CIF picture
constexpr int kThreads = 416;                       // 13 warps, >= kMaxMbs
constexpr int kWarps = kThreads / 32;

// Exclusive prefix sum of x over the CTA.  Every thread calls it.
__device__ __forceinline__ unsigned exclusive_scan(unsigned x,
                                                   unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < kWarps ? warp_sums[lane] : 0u;
    unsigned wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < kWarps) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  const unsigned out = warp_sums[warp] + inc - x;
  __syncthreads();  // warp_sums is read before the next scan writes it
  return out;
}

// mb_mask (frames, mbs) uint8; blocks the packed block masks; values the
// packed levels; bases (frames, 2) int64: the frame's first block mask and
// first level; out (frames, mbs, 6, 64) int8 as 16-byte chunks.
__global__ void __launch_bounds__(kThreads)
    levels_expand_kernel(const uint8_t* __restrict__ mb_mask,
                         const unsigned long long* __restrict__ blocks,
                         const int8_t* __restrict__ values,
                         const long long* __restrict__ bases, int mbs,
                         uint4* __restrict__ out) {
  __shared__ unsigned long long sh_mask[kMaxMbs * kBlocks];
  __shared__ unsigned sh_first[kMaxMbs * kBlocks];
  __shared__ unsigned warp_sums[kWarps];

  const long long frame = blockIdx.x;
  const long long block_base = bases[2 * frame];
  const long long value_base = bases[2 * frame + 1];
  const int mb = threadIdx.x;

  // 1. the MB's first block mask in the frame
  const unsigned present = mb < mbs ? mb_mask[frame * mbs + mb] & 0x3fu : 0u;
  const unsigned first_block = exclusive_scan(__popc(present), warp_sums);

  // 2. its block masks, and each block's first level in the frame
  unsigned long long mask[kBlocks];
  unsigned count = 0, k = 0;
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    mask[b] = 0;
    if (present >> b & 1u) mask[b] = blocks[block_base + first_block + k++];
    count += __popcll(mask[b]);
  }
  unsigned first = exclusive_scan(count, warp_sums);
  if (mb < mbs) {
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      sh_mask[mb * kBlocks + b] = mask[b];
      sh_first[mb * kBlocks + b] = first;
      first += __popcll(mask[b]);
    }
  }
  __syncthreads();

  // 3. every 16-byte chunk of the frame, once
  const int chunks = mbs * kBlocks * kChunksPerBlock;
  uint4* dst = out + frame * chunks;
  const int8_t* src = values + value_base;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int blk = c / kChunksPerBlock;
    const int shift = (c % kChunksPerBlock) * kChunk;
    const unsigned long long m = sh_mask[blk];
    unsigned bits = static_cast<unsigned>(m >> shift) & 0xffffu;
    unsigned long long lo = 0, hi = 0;
    if (bits) {
      const int8_t* v =
          src + sh_first[blk] + __popcll(m & ((1ull << shift) - 1));
      while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        const unsigned long long byte = static_cast<uint8_t>(*v++);
        if (j < 8)
          lo |= byte << (8 * j);
        else
          hi |= byte << (8 * (j - 8));
      }
    }
    dst[c] = make_uint4(static_cast<unsigned>(lo),
                        static_cast<unsigned>(lo >> 32),
                        static_cast<unsigned>(hi),
                        static_cast<unsigned>(hi >> 32));
  }
}

}  // namespace

extern "C" {

// Expand `frames` pictures of `mbs` (at most 396) macroblocks; out must be
// 16-byte aligned.
int p64_levels_expand(const void* mb_mask, const void* blocks,
                      const void* values, const void* bases, long long frames,
                      int mbs, void* out, void* stream) {
  if (frames > 0 && mbs > 0)
    levels_expand_kernel<<<static_cast<unsigned>(frames), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mb_mask),
        static_cast<const unsigned long long*>(blocks),
        static_cast<const int8_t*>(values),
        static_cast<const long long*>(bases), mbs, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* p64_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
