// The rate-control GOB chain of one coded picture, for every stream at once,
// in three kernels for sm_90a.
//
// Replaces no TPU kernel: the JAX package runs this chain as a `lax.scan`
// over the GOBs of plain XLA ops (p64tpu/core/encoder.py, `_gob_chain` and
// `process_gob_mquant`), and the port's plain version is the same chain of
// small torch ops (p64tpu_torch/core/encoder.py `_gob_chain`, `_gob_mquant`):
// at 32 CIF streams about 7,200 kernels a frame with three MQUANT segments a
// GOB, whose cost is launch and tail, not arithmetic.  This source computes
// the same outputs, bit for bit, with three launches.
//
// What makes the sequential chain cheap: a block's coefficient bits, its
// nonzero flag and so the MB's CBP at a quantizer q depend only on (block, q,
// intra), never on the buffer.  So
//
//   1. price (rate_price_kernel): every (stream, MB) and every q in 1..31,
//      across the card.  One CTA of six warps per MB, a warp per block, a
//      lane per quantizer.  The warp first lists the block's coefficients
//      that are nonzero at QUANT 1 (a ballot and a popcount); each lane
//      walks that list in zigzag order, the only levels that can be
//      nonzero at its QUANT, sums TC_LEN[run][|level|] over the nonzero
//      ones, adds EOB and the intra DC's 8-bit FLC, takes off the inter
//      first-coefficient (0, +-1) short form's saving.  The MB's entry for
//      q is (bits << 6) | CBP, int32, (S, nGOB, 33, 31).
//   2. walk (rate_walk_kernel): one warp per stream carries the int32
//      buffer through the GOBs in transmission order.  A lane holds MB
//      `lane` of the GOB and lane 0 also MB 32.  Each pass reads the price
//      entries at the MBs' quantizers and derives coded, MTYPE, the MBA
//      chain (the last coded MB below, from a 33-bit ballot), the MVD
//      predictor and each MB's bits, as entropy/lengths.py does.  With
//      mquant_segments > 1 it runs pass 1 at the GOB quantizer, pass 1b at
//      the provisional segment quantizers and the final pass, walking the
//      segments in order as `_gob_mquant` does; with 1 the final pass alone.
//      It writes CBP, coded, MTYPE (with the MQUANT upgrade), GQUANT, the
//      per-MB quantizer, each GOB's bits and, as scratch for the emit, the
//      quantizer each MB's levels are quantized at.
//   3. emit (rate_emit_kernel): every block quantized once at its MB's
//      quantizer, four coefficients a thread, levels zeroed on uncoded MBs.
//
// Bound (32 CIF streams, a frame): the coefficients read once, 19.5 MB of
// int32, and the int32 levels written once, 19.5 MB, plus under 2 MB of
// price entries and per-MB outputs: about 41 MB, 12 us at 3.35 TB/s.  The
// price does 2.36 M (block, q) walks of up to 64 coefficients, at most 151 M
// quantize and look-up steps, tens of us of integer issue over 132 SMs; it
// is the part the bound does not cover.  The walk is latency-bound: 12 GOBs
// x at most 3 passes, one warp a stream.
//
// Exactness: integer arithmetic throughout.  AC levels trunc(|coef| / 2q)
// with the sign, clamped to 127: the division is a multiply-high by
// floor((2^32 - 1) / 2q) + 1, exact for |coef| < 2^14 (tested for every q),
// and |coef| is clamped to 8191 first, which leaves every level at or above
// 127 at 127.  The intra DC (coef + 4) >> 3, clamped to 1..254.  The buffer
// law floors (qdfact > 0), clamps to 1..31, in int32.
//
// The VLC and MTYPE tables come from one int32 device tensor that
// kernels/rate_chain_cuda.py builds from spec/luts.py; the offsets below are
// its layout (tests/test_torch_rate_chain.py holds the two together).
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMbs = 33;          // MBs in a GOB
constexpr int kBlocks = 6;        // blocks in an MB
constexpr int kCoefs = 64;
constexpr int kQuants = 31;       // QUANT 1..31
constexpr int kLevels = 128;      // TC_LEN's |level| axis
constexpr int kMbCoefs = kBlocks * kCoefs;
constexpr int kLevelMax = 127;
constexpr int kAbsClamp = 8191;   // >= 128 x 62: every clamped level stays 127
constexpr int kDcMin = 1, kDcMax = 254;
constexpr int kPriceThreads = kBlocks * 32;
constexpr int kEmitThreads = 256;

// the table tensor's layout (kernels/rate_chain_cuda.py TABLE_LAYOUT)
constexpr int kTcLen = 0;          // TC_LEN, 64 runs x 128 levels
constexpr int kMbaLen = 8192;      // MBA_LEN, 34
constexpr int kMtypeLen = 8226;    // MTYPE_LEN, 10
constexpr int kMvdLen = 8236;      // MVD_LEN, 32
constexpr int kCbpLen = 8268;      // CBP_LEN, 64
constexpr int kMtypeFlags = 8332;  // per MTYPE: kFlag* bits, 10
constexpr int kMqUp = 8342;        // base MTYPE -> its MQUANT variant, 10
constexpr int kMtCode = 8352;      // the MTYPE codes kMt* name, 6
constexpr int kScalar = 8358;      // EOB_LEN, FIRST01_SAVING, MQUANT_BITS,
                                   // GOB_HEADER_BITS
constexpr int kTableSize = 8362;

constexpr int kFlagMc = 1, kFlagCbp = 2, kFlagTcoeff = 4, kFlagMquant = 8;
constexpr int kMtIntra = 0, kMtInter = 1, kMtMc = 2, kMtMcCoef = 3,
              kMtFil = 4, kMtFilCoef = 5;
constexpr int kEob = 0, kFirst01Saving = 1, kMquantBits = 2, kGobHeader = 3;
// the small tables the walk keeps in shared memory: MBA_LEN onwards
constexpr int kSmall = kTableSize - kMbaLen;

__device__ __forceinline__ unsigned magic(int d) {
  // floor((2^32 - 1) / d) + 1: __umulhi(a, magic(d)) == a / d for a < 2^14
  return 0xffffffffu / static_cast<unsigned>(d) + 1u;
}

__device__ __forceinline__ int ac_abs_level(int coef, unsigned m) {
  const int a = min(abs(coef), kAbsClamp);
  return min(static_cast<int>(__umulhi(static_cast<unsigned>(a), m)),
             kLevelMax);
}

// ---------------------------------------------------------------------------
// 1. price
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPriceThreads)
rate_price_kernel(const int* __restrict__ coefs,
                  const uint8_t* __restrict__ intra,
                  const int* __restrict__ tables, int n_mbs,
                  int* __restrict__ price) {
  __shared__ uint8_t tc[kCoefs * kLevels];
  __shared__ int part[kBlocks][32];
  // per block, its coefficients that are nonzero at QUANT 1 (|coef| >= 2,
  // the intra DC left out), in zigzag order: (position << 16) | |coef|
  __shared__ int cand[kBlocks][kCoefs];
  const int tid = threadIdx.x;
  const int blk = tid >> 5, lane = tid & 31;
  for (int i = tid; i < kCoefs * kLevels; i += kPriceThreads)
    tc[i] = static_cast<uint8_t>(tables[kTcLen + i]);
  const int eob = tables[kScalar + kEob];
  const int saving = tables[kScalar + kFirst01Saving];
  // lane 31 has no quantizer; it runs q = 31 again and writes nothing
  const int q = min(lane + 1, kQuants);
  const unsigned m = magic(2 * q);
  const unsigned below = (1u << lane) - 1;
  for (int mb = blockIdx.x; mb < n_mbs; mb += gridDim.x) {
    const int* src = coefs + static_cast<long long>(mb) * kMbCoefs +
                     blk * kCoefs;
    const bool is_intra = intra[mb] != 0;
    const int c0 = src[lane], c1 = src[lane + 32];
    const int a0 = min(abs(c0), kAbsClamp), a1 = min(abs(c1), kAbsClamp);
    const bool k0 = a0 >= 2 && !(is_intra && lane == 0), k1 = a1 >= 2;
    const unsigned lo = __ballot_sync(kFull, k0);
    const unsigned hi = __ballot_sync(kFull, k1);
    const int n = __popc(lo) + __popc(hi);
    __syncthreads();  // the last MB's cand and part are read
    if (k0) cand[blk][__popc(lo & below)] = (lane << 16) | a0;
    if (k1)
      cand[blk][__popc(lo) + __popc(hi & below)] = ((lane + 32) << 16) | a1;
    const int first = __shfl_sync(kFull, c0, 0);
    __syncwarp();
    // intra: the DC is an 8-bit FLC, never zero; runs start after it
    int bits = is_intra ? 8 : 0;
    int last = is_intra ? 0 : -1;
    bool nz = is_intra;
    for (int i = 0; i < n; ++i) {
      const int e = cand[blk][i];
      const int k = e >> 16;
      const int l = min(static_cast<int>(__umulhi(
                            static_cast<unsigned>(e & 0xffff), m)),
                        kLevelMax);
      if (l) {
        bits += tc[((k - last - 1) << 7) + l];
        last = k;
        nz = true;
      }
    }
    if (!is_intra && ac_abs_level(first, m) == 1) bits -= saving;
    part[blk][lane] = nz ? ((bits + eob) << 1) | 1 : 0;
    __syncthreads();
    if (tid < kQuants) {
      int sum = 0, cbp = 0;
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        const int p = part[b][tid];
        sum += p >> 1;
        cbp |= (p & 1) << (kBlocks - 1 - b);
      }
      price[static_cast<long long>(mb) * kQuants + tid] = (sum << 6) | cbp;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. walk
// ---------------------------------------------------------------------------

// the 33-bit mask of a per-MB flag: slot 0 is MB `lane`, slot 1 MB 32 on
// lane 0 (false elsewhere)
__device__ __forceinline__ uint64_t ballot33(bool v0, bool v1) {
  const unsigned lo = __ballot_sync(kFull, v0);
  const unsigned hi = __shfl_sync(kFull, v1 ? 1u : 0u, 0);
  return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
}

__device__ __forceinline__ int gob_quant(int buffer, int qdfact, int qoffs) {
  int d = buffer / qdfact;  // floor, as the plain law's //
  if (buffer % qdfact != 0 && buffer < 0) --d;
  return min(max(d + qoffs, 1), kQuants);
}

// the segment of MB j and the last MB of segment `seg`
__device__ __forceinline__ int seg_of(int j, int nseg) {
  return static_cast<int>(static_cast<long long>(j) * nseg / kMbs);
}
__device__ __forceinline__ int seg_end(int seg, int nseg) {
  const long long e =
      ((static_cast<long long>(seg) + 1) * kMbs + nseg - 1) / nseg - 1;
  return static_cast<int>(min(e, static_cast<long long>(kMbs - 1)));
}

__device__ __forceinline__ uint64_t span_mask(int lo, int hi) {
  return ((hi >= 63 ? ~0ull : ((1ull << (hi + 1)) - 1))) &
         ~((1ull << lo) - 1);
}

struct Mb {
  int cbp, blk, mt;
  bool coded, hc;
};

// what the price entry at quantizer q says of an MB, and its base MTYPE
// (core/encoder.py `_quantize_derive`, `_mtype_from_flags`)
__device__ __forceinline__ Mb lookup(int entry, bool in, bool mc, bool fil,
                                     const int* tab) {
  Mb r;
  r.cbp = entry & 63;
  r.blk = entry >> 6;
  r.hc = r.cbp != 0;
  r.coded = in || mc || r.hc;
  const int pick = in ? kMtIntra
                      : mc ? (fil ? (r.hc ? kMtFilCoef : kMtFil)
                                  : (r.hc ? kMtMcCoef : kMtMc))
                           : kMtInter;
  r.mt = tab[kMtCode - kMbaLen + pick];
  return r;
}

__global__ void __launch_bounds__(32)
rate_walk_kernel(const int* __restrict__ price,
                 const uint8_t* __restrict__ intra,
                 const uint8_t* __restrict__ mc,
                 const uint8_t* __restrict__ fil, const int* __restrict__ mv,
                 const int* __restrict__ buffer,
                 const int* __restrict__ tables, int gobs, int nseg,
                 int qdfact, int qoffs, int* __restrict__ cbp_out,
                 uint8_t* __restrict__ coded_out,
                 int* __restrict__ mtype_out, int* __restrict__ gquant_out,
                 int* __restrict__ quant_out, int* __restrict__ bits_out,
                 int* __restrict__ qlev_out) {
  __shared__ int tab[kSmall];
  __shared__ int mvx[kMbs], mvy[kMbs], mts[kMbs], qseg[kMbs];
  const int lane = threadIdx.x;
  const int s = blockIdx.x;
  for (int i = lane; i < kSmall; i += 32) tab[i] = tables[kMbaLen + i];
#define TAB(off) tab[(off) - kMbaLen]
  const int mq_bits = TAB(kScalar + kMquantBits);
  int buf = buffer[s];

  for (int g = 0; g < gobs; ++g) {
    const long long mb0 = (static_cast<long long>(s) * gobs + g) * kMbs;
    bool in[2] = {false, false}, m[2] = {false, false}, f[2] = {false, false};
    __syncwarp();  // the last GOB's shared arrays are read
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      if (j < kMbs) {
        in[t] = intra[mb0 + j] != 0;
        m[t] = mc[mb0 + j] != 0;
        f[t] = fil[mb0 + j] != 0;
        mvx[j] = mv[2 * (mb0 + j)];
        mvy[j] = mv[2 * (mb0 + j) + 1];
      }
    }
    __syncwarp();
    const int q0 = gob_quant(buf, qdfact, qoffs);
    int q[2] = {q0, q0};
    Mb mb[2];
    int bits[2];

    // per-MB bits (entropy/lengths.py gob_payload_bits_per_mb) of mb[] with
    // the MQUANT upgrade where up[] is set; writes the final MTYPE back
    auto mb_bits = [&](const bool* up) {
      int fl[2];
      bool is_mc[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (up[t]) mb[t].mt = TAB(kMqUp + mb[t].mt);
        fl[t] = TAB(kMtypeFlags + mb[t].mt);
        is_mc[t] = (fl[t] & kFlagMc) && mb[t].coded;
      }
      const uint64_t coded_mask = ballot33(mb[0].coded, mb[1].coded);
      const uint64_t mc_mask = ballot33(is_mc[0], is_mc[1]);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        bits[t] = 0;
        if (j >= kMbs || !mb[t].coded) continue;
        const uint64_t below = coded_mask & ((1ull << j) - 1);
        const int prev = below ? 63 - __clzll(static_cast<long long>(below))
                               : -1;
        const int mba = j - prev;
        const bool use_pred = mba == 1 && prev >= 0 &&
                              ((mc_mask >> prev) & 1) && j % 11 != 0;
        const int px = use_pred ? mvx[prev] : 0;
        const int py = use_pred ? mvy[prev] : 0;
        const int dx = ((mvx[j] - px + 16) & 31) - 16;
        const int dy = ((mvy[j] - py + 16) & 31) - 16;
        int b = TAB(kMbaLen + min(mba, kMbs)) + TAB(kMtypeLen + mb[t].mt);
        if (fl[t] & kFlagMquant) b += mq_bits;
        if (is_mc[t]) b += TAB(kMvdLen + dx + 16) + TAB(kMvdLen + dy + 16);
        if (fl[t] & kFlagCbp) b += TAB(kCbpLen + mb[t].cbp);
        if (fl[t] & kFlagTcoeff) b += mb[t].blk;
        bits[t] = b;
      }
    };
    auto look = [&]() {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        const int e = j < kMbs
            ? price[(mb0 + j) * kQuants + q[t] - 1] : 0;
        mb[t] = lookup(e, in[t], m[t], f[t], tab);
      }
    };
    const bool none[2] = {false, false};

    if (nseg > 1) {
      // pass 1 at q0, pass 1b at the provisional segment quantizers: each
      // walks the segments in order, as the chain does, pricing a changed
      // quantizer's MQUANT and MTYPE delta into the later segments
      for (int pass = 0; pass < 2; ++pass) {
        look();
        mb_bits(none);
#pragma unroll
        for (int t = 0; t < 2; ++t)
          if (lane + 32 * t < kMbs) mts[lane + 32 * t] = mb[t].mt;
        __syncwarp();
        const uint64_t hc_mask = ballot33(mb[0].hc, mb[1].hc);
        int eff = q0, acc = 0;
        for (int start = 0, r = 0; start < kMbs; ++r) {
          const int end = seg_end(seg_of(start, nseg), nseg);
          int mine = 0;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int j = lane + 32 * t;
            if (j >= start && j <= end) mine += bits[t];
          }
          const int seg_bits = __reduce_add_sync(kFull, mine);
          const uint64_t coef = hc_mask & span_mask(start, end);
          const int qr = gob_quant(buf + acc, qdfact, qoffs);
          if (r > 0 && coef && qr != eff) {
            const int mt = mts[__ffsll(static_cast<long long>(coef)) - 1];
            eff = qr;
            acc += mq_bits + TAB(kMtypeLen + TAB(kMqUp + mt)) -
                   TAB(kMtypeLen + mt);
          }
          acc += seg_bits;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int j = lane + 32 * t;
            if (j >= start && j <= end) q[t] = qr;
          }
          if (lane == 0) qseg[r] = qr;
          start = end + 1;
        }
        __syncwarp();
      }
    }

    // the final pass: levels at q[], the effective quantizer chain, and
    // MQUANT on the first coefficient-bearing MB of a changed segment
    look();
    int quant[2] = {q0, q0};
    bool up[2] = {false, false};
    if (nseg > 1) {
      const uint64_t hc_mask = ballot33(mb[0].hc, mb[1].hc);
      int eff = q0;
      for (int start = 0, r = 0; start < kMbs; ++r) {
        const int end = seg_end(seg_of(start, nseg), nseg);
        const uint64_t coef = hc_mask & span_mask(start, end);
        if (r > 0 && coef && qseg[r] != eff) {
          const int first = __ffsll(static_cast<long long>(coef)) - 1;
#pragma unroll
          for (int t = 0; t < 2; ++t)
            if (lane + 32 * t == first) up[t] = true;
          eff = qseg[r];
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = lane + 32 * t;
          if (j >= start && j <= end) quant[t] = eff;
        }
        start = end + 1;
      }
    }
    mb_bits(up);
    const int gob_bits = __reduce_add_sync(kFull, bits[0] + bits[1]) +
                         TAB(kScalar + kGobHeader);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      if (j < kMbs) {
        cbp_out[mb0 + j] = mb[t].cbp;
        coded_out[mb0 + j] = mb[t].coded ? 1 : 0;
        mtype_out[mb0 + j] = mb[t].mt;
        quant_out[mb0 + j] = quant[t];
        qlev_out[mb0 + j] = q[t];
      }
    }
    if (lane == 0) {
      const long long gob = static_cast<long long>(s) * gobs + g;
      gquant_out[gob] = q0;
      bits_out[gob] = gob_bits;
    }
    buf += gob_bits;
  }
#undef TAB
}

// ---------------------------------------------------------------------------
// 3. emit
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kEmitThreads)
rate_emit_kernel(const int4* __restrict__ coefs,
                 const uint8_t* __restrict__ intra,
                 const uint8_t* __restrict__ coded,
                 const int* __restrict__ qlev, long long n_quads,
                 int4* __restrict__ levels) {
  __shared__ unsigned magics[kQuants + 1];
  if (threadIdx.x < kQuants) magics[threadIdx.x + 1] = magic(2 * (threadIdx.x + 1));
  __syncthreads();
  constexpr int kQuadsPerMb = kMbCoefs / 4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n_quads; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long mb = i / kQuadsPerMb;
    int4 out = make_int4(0, 0, 0, 0);
    if (coded[mb]) {
      const int4 c = coefs[i];
      const unsigned m = magics[qlev[mb]];
      const int v[4] = {c.x, c.y, c.z, c.w};
      int l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int a = ac_abs_level(v[u], m);
        l[u] = v[u] < 0 ? -a : a;
      }
      // the intra DC: slot 0 of each block, the first of its 16 quads
      if (intra[mb] && (i % kQuadsPerMb) % (kCoefs / 4) == 0)
        l[0] = min(max((v[0] + 4) >> 3, kDcMin), kDcMax);
      out = make_int4(l[0], l[1], l[2], l[3]);
    }
    levels[i] = out;
  }
}

}  // namespace

extern "C" {

int p64_rate_price(const void* coefs, const void* intra, const void* tables,
                   int n_mbs, int grid, void* price, void* stream) {
  rate_price_kernel<<<grid, kPriceThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(coefs), static_cast<const uint8_t*>(intra),
      static_cast<const int*>(tables), n_mbs, static_cast<int*>(price));
  return static_cast<int>(cudaGetLastError());
}

int p64_rate_walk(const void* price, const void* intra, const void* mc,
                  const void* fil, const void* mv, const void* buffer,
                  const void* tables, int streams, int gobs, int nseg,
                  int qdfact, int qoffs, void* cbp, void* coded, void* mtype,
                  void* gquant, void* quant, void* bits, void* qlev,
                  void* stream) {
  rate_walk_kernel<<<streams, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(price), static_cast<const uint8_t*>(intra),
      static_cast<const uint8_t*>(mc), static_cast<const uint8_t*>(fil),
      static_cast<const int*>(mv), static_cast<const int*>(buffer),
      static_cast<const int*>(tables), gobs, nseg, qdfact, qoffs,
      static_cast<int*>(cbp), static_cast<uint8_t*>(coded),
      static_cast<int*>(mtype), static_cast<int*>(gquant),
      static_cast<int*>(quant), static_cast<int*>(bits),
      static_cast<int*>(qlev));
  return static_cast<int>(cudaGetLastError());
}

int p64_rate_emit(const void* coefs, const void* intra, const void* coded,
                  const void* qlev, long long n_quads, int grid, void* levels,
                  void* stream) {
  rate_emit_kernel<<<grid, kEmitThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(coefs), static_cast<const uint8_t*>(intra),
      static_cast<const uint8_t*>(coded), static_cast<const int*>(qlev),
      n_quads, static_cast<int4*>(levels));
  return static_cast<int>(cudaGetLastError());
}

const char* p64_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
