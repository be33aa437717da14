// Issue-rate probes of the SAD-map kernels' instruction mixes on one card:
// VABSDIFF4, LOP3, IDP4A.S8, int8 mma.sync m16n8k32 and the mixes K4 could
// pool with (csrc/sad_search.cu), and K5's VIADDMNMX.U16x2 beside IADD3.
// Each kernel runs kIters trips of independent chains over 4 and then 8
// blocks of 256 threads per SM; a rate is warp instructions of the named
// class per SM per clock x 32 lanes, at the clock a spin measures and at
// 1,980 MHz.  A standalone program, not part of the kernel library:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/issue_rates \
//       p64tpu_torch/probes/issue_rates.cu && build/issue_rates
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

#define CK(x)                                                          \
  do {                                                                 \
    cudaError_t e_ = (x);                                              \
    if (e_ != cudaSuccess) {                                           \
      printf("CUDA error %s at line %d\n", cudaGetErrorString(e_),     \
             __LINE__);                                                \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

constexpr int kIters = 2048;
constexpr uint32_t kBias = 0x80808080u;

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3) {
  const uint32_t b = 0x01010101u;
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b), "r"(b));
}

__global__ void spin(long long cycles, int* out) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
  if (threadIdx.x == 0) out[blockIdx.x] = 1;
}

#define SETUP                                              \
  uint32_t x[8], y[8];                                     \
  _Pragma("unroll") for (int j = 0; j < 8; ++j) {          \
    x[j] = seed * (j + 1) + threadIdx.x * 0x01030507u;     \
    y[j] = seed ^ (0x9E3779B9u * (j + 3));                 \
  }

// VABSDIFF4 alone: 8 chains
__global__ void k_vad(uint32_t seed, uint32_t* out) {
  SETUP
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __vabsdiffu4(x[j], y[j]);
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// VABSDIFF4 + LOP3 (the bias): 8 chains
__global__ void k_vad_xor(uint32_t seed, uint32_t* out) {
  SETUP
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __vabsdiffu4(x[j], y[j]) ^ kBias;
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// VABSDIFF4 + LOP3 + IDP4A.S8: 8 chains, K4's loop mix
__global__ void k_vad_xor_dp4a(uint32_t seed, uint32_t* out) {
  SETUP
  int acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0;
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = __vabsdiffu4(x[j], y[j]) ^ kBias;
      acc[j] = __dp4a((int)x[j], 0x01010101, acc[j]);
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j] + acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// mma.sync m16n8k32 s8 alone: 8 independent C tiles
__global__ void k_mma(uint32_t seed, uint32_t* out) {
  SETUP
  int c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) c[j][k] = 0;
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_s8(c[j], x[j], y[j], x[(j + 1) & 7], y[(j + 1) & 7]);
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= c[j][0] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// an int8 tensor-core pool of biased words: per trip 8 VABSDIFF4 + 8 LOP3 and 2 MMAs (4 words
// of biased abs-diffs per MMA per thread)
__global__ void k_vad_xor_mma(uint32_t seed, uint32_t* out) {
  SETUP
  int c[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) c[j][k] = 0;
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __vabsdiffu4(x[j], y[j]) ^ kBias;
    mma_s8(c[0], x[0], x[1], x[2], x[3]);
    mma_s8(c[1], x[4], x[5], x[6], x[7]);
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  s += c[0][0] + c[1][2];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// the same with twice the MMAs (4 per 8 VABSDIFF4 + 8 LOP3)
__global__ void k_vad_xor_mma2(uint32_t seed, uint32_t* out) {
  SETUP
  int c[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) c[j][k] = 0;
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __vabsdiffu4(x[j], y[j]) ^ kBias;
    mma_s8(c[0], x[0], x[1], x[2], x[3]);
    mma_s8(c[1], x[4], x[5], x[6], x[7]);
    mma_s8(c[2], x[1], x[2], x[3], x[4]);
    mma_s8(c[3], x[5], x[6], x[7], x[0]);
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  s += c[0][0] + c[1][2] + c[2][1] + c[3][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// K5: VIADDMNMX.U16x2 alone (8 chains)
__global__ void k_vmnmx(uint32_t seed, uint32_t* out) {
  SETUP
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __viaddmax_u16x2(y[j], x[j], y[7 - j]);
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// IADD3 alone (8 chains, each adding its neighbour's value)
__global__ void k_iadd3(uint32_t seed, uint32_t* out) {
  SETUP
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = x[j] + x[(j + 1) & 7] + y[j];
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// K5's mix: 2 VIADDMNMX.U16x2 and 1 IADD3 per 2 chains
__global__ void k_vmnmx_iadd3(uint32_t seed, uint32_t* out) {
  SETUP
  uint32_t acc[4] = {0, 0, 0, 0};
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __viaddmax_u16x2(y[j], x[j], y[7 - j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = acc[j] + x[2 * j] + x[2 * j + 1];
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s + acc[0] + acc[1] + acc[2] +
                                               acc[3];
}

// K5's whole mix: per pixel pair one subtract, one VIADDMNMX.U16x2, half an
// IADD3
__global__ void k_k5_mix(uint32_t seed, uint32_t* out) {
  SETUP
  uint32_t acc[4] = {0, 0, 0, 0};
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = __viaddmax_u16x2(y[7 - j], x[j], y[j] - x[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = acc[j] + x[2 * j] + x[2 * j + 1];
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s + acc[0] + acc[1] + acc[2] +
                                               acc[3];
}

typedef void (*Probe)(uint32_t, uint32_t*);

struct Case {
  const char* name;
  Probe fn;
  // warp instructions per thread-trip: {class name, count}
  const char* cls[3];
  int per_trip[3];
};

int main() {
  int dev = 0, sms = 0;
  CK(cudaGetDevice(&dev));
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  int* flags;
  CK(cudaMalloc(&flags, 4096 * sizeof(int)));
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  // clock under a spin of every SM
  const long long spin_cycles = 200000000LL;
  spin<<<sms, 32>>>(1000, flags);
  CK(cudaDeviceSynchronize());
  CK(cudaEventRecord(e0));
  spin<<<sms, 32>>>(spin_cycles, flags);
  CK(cudaEventRecord(e1));
  CK(cudaEventSynchronize(e1));
  float spin_ms = 0;
  CK(cudaEventElapsedTime(&spin_ms, e0, e1));
  const double mhz = spin_cycles / (spin_ms * 1e3);
  printf("clock: spin of %lld cycles took %.3f ms -> %.1f MHz; %d SMs\n",
         spin_cycles, spin_ms, mhz, sms);

  Case cases[] = {
      {"vad", k_vad, {"VABSDIFF4"}, {8}},
      {"vad_xor", k_vad_xor, {"VABSDIFF4", "LOP3"}, {8, 8}},
      {"vad_xor_dp4a", k_vad_xor_dp4a, {"VABSDIFF4", "LOP3", "IDP4A"},
       {8, 8, 8}},
      {"mma", k_mma, {"MMA"}, {8}},
      {"vad_xor_mma", k_vad_xor_mma, {"VABSDIFF4", "LOP3", "MMA"}, {8, 8, 2}},
      {"vad_xor_mma2", k_vad_xor_mma2, {"VABSDIFF4", "LOP3", "MMA"},
       {8, 8, 4}},
      {"vmnmx", k_vmnmx, {"VIADDMNMX"}, {8}},
      {"iadd3", k_iadd3, {"IADD3"}, {8}},
      {"vmnmx_iadd3", k_vmnmx_iadd3, {"VIADDMNMX", "IADD3"}, {8, 4}},
      {"k5_mix", k_k5_mix, {"VIADDMNMX", "IADD3", "SUB"}, {8, 4, 8}},
  };
  const int threads = 256;
  uint32_t* out;
  for (int blocks_per_sm : {4, 8}) {
    const int blocks = sms * blocks_per_sm;
    CK(cudaMalloc(&out, (size_t)blocks * threads * sizeof(uint32_t)));
    for (const Case& c : cases) {
      c.fn<<<blocks, threads>>>(1u, out);
      CK(cudaGetLastError());
      CK(cudaDeviceSynchronize());
      float best = 1e30f;
      for (int r = 0; r < 5; ++r) {
        CK(cudaEventRecord(e0));
        c.fn<<<blocks, threads>>>(2u + r, out);
        CK(cudaEventRecord(e1));
        CK(cudaEventSynchronize(e1));
        float ms = 0;
        CK(cudaEventElapsedTime(&ms, e0, e1));
        if (ms < best) best = ms;
      }
      const double warps = (double)blocks * threads / 32;
      printf("%-13s blocks/SM %d: %.4f ms;", c.name, blocks_per_sm, best);
      for (int k = 0; k < 3 && c.cls[k]; ++k) {
        const double instr = warps * kIters * c.per_trip[k];
        printf("  %s %.1f lanes/SM/clk (%.1f at 1980 MHz)", c.cls[k],
               instr * 32 / (sms * mhz * 1e6 * best * 1e-3),
               instr * 32 / (sms * 1980e6 * best * 1e-3));
      }
      printf("\n");
    }
    CK(cudaFree(out));
  }
  return 0;
}
