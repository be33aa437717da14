// Batch H.261 serializer: a chunk's stacked (S, T, ...) encoder outputs ->
// each stream's bytes, in one pass over the arrays as the encoder left them.
//
//   p64_serialize_batch -- streams [first, last) of a chunk -> their bytes
//
// The single translation unit of libp64serialize.so.  It includes the
// bit-I/O engine (bitio.cpp, the JAX package's source, kept byte-identical)
// for its encoder tables and helpers, and emits exactly what p64_serialize
// emits for the same pictures: PSC/TR/PTYPE, GOB headers with GQUANT,
// MBA/MTYPE/MQUANT/MVD/CBP, TCOEFF with escapes, EOB, and the MBA stuffing
// codes.  What differs is the input and the writer:
//
//   * levels stay int8, with the intra DC in a uint8 sidecar; slot 0 of a
//     block is rebuilt on the fly as core.encoder.outputs_to_symbols does
//     (dc > 0 ? dc : level), and a block's nonzero levels are found eight
//     at a time;
//   * frames a stream skipped (frame_coded 0) are passed over;
//   * the writer keeps up to 63 pending bits in a register and stores whole
//     bytes, each byte of a stream's slot once: nothing is cleared first.
//
// Each stream writes into its own slot of one output buffer, sized by the
// caller from the device bit model.  A stream that outgrows its slot stops
// writing but goes on counting, so its bit count tells the caller by how
// much the model and the serializer disagree.
//
// The engine checks the symbols it writes, as the per-stream binding checks
// them before p64_serialize: per stream it counts the coded CBP-bearing MBs
// whose CBP is outside 1..63, the MQUANT MBs whose quantizer is outside
// 1..31, the coded pictures' GQUANTs outside 1..31, and the MBs whose
// MTYPE or MVD lies outside the code tables.  It reads no table out of
// range: such an MB's codes are left out, and the caller raises.
//
// It also counts, per stream, the MBs it writes with an MQUANT MTYPE: the
// rate control's mid-GOB quantizer changes.
//
// Build: g++ -O3 -Wall -Wextra -fPIC -std=c++17 -shared
//            -o libp64serialize.so serialize_batch.cpp

#include "bitio.cpp"

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the level scan reads zigzag slot j of a word at byte j % 8");

// rows of the MTYPE tables (H.261 Table 2)
static const int kMtypes = 10;

namespace {

struct WordWriter {
  uint8_t* buf;
  int64_t cap;     // bytes of the slot
  int64_t nbytes;  // bytes stored (or, past cap, counted)
  uint64_t acc;    // pending bits in the low `nacc` bits
  int nacc;        // 0..31 between puts
  int overflow;
};

inline void ww_store(WordWriter* w, uint8_t b) {
  if (w->nbytes < w->cap) w->buf[w->nbytes] = b;
  else w->overflow = 1;
  ++w->nbytes;
}

// the low `nbits` (0..32) bits of value, MSB first, as bw_put writes them
inline void ww_put(WordWriter* w, uint32_t value, int nbits) {
  w->acc = (w->acc << nbits) | (value & ((1ull << nbits) - 1));
  w->nacc += nbits;
  if (w->nacc >= 32) {
    w->nacc -= 32;
    uint32_t v = (uint32_t)(w->acc >> w->nacc);
    if (w->nbytes + 4 <= w->cap) {
      uint8_t* p = w->buf + w->nbytes;
      p[0] = (uint8_t)(v >> 24);
      p[1] = (uint8_t)(v >> 16);
      p[2] = (uint8_t)(v >> 8);
      p[3] = (uint8_t)v;
      w->nbytes += 4;
    } else {
      for (int k = 24; k >= 0; k -= 8) ww_store(w, (uint8_t)(v >> k));
    }
  }
}

inline int64_t ww_bits(const WordWriter* w) {
  return w->nbytes * 8 + w->nacc;
}

// store the pending bits, the last byte zero-padded
inline void ww_finish(WordWriter* w) {
  while (w->nacc >= 8) {
    w->nacc -= 8;
    ww_store(w, (uint8_t)(w->acc >> w->nacc));
  }
  if (w->nacc > 0) ww_store(w, (uint8_t)(w->acc << (8 - w->nacc)));
  w->nacc = 0;
}

inline void put_coef(WordWriter* w, const EncTables* t, int run, int level,
                     int first_inter) {
  int alevel = level < 0 ? -level : level;
  unsigned sign = level < 0 ? 1u : 0u;
  if (first_inter && run == 0 && alevel == 1) {
    ww_put(w, (1u << 1) | sign, 2);  // '1s'
  } else if (alevel < 128 && t->tc_in[run * 128 + alevel]) {
    ww_put(w, (t->tc_code[run * 128 + alevel] << 1) | sign,
           t->tc_len[run * 128 + alevel]);
  } else {
    // escape: 000001 + 6-bit run + 8-bit two's-complement level
    ww_put(w, (1u << 14) | ((uint32_t)run << 8) | ((uint32_t)level & 0xFFu),
           20);
  }
}

// high bit of each nonzero byte of x
inline uint64_t nonzero_bytes(uint64_t x) {
  const uint64_t lo7 = 0x7F7F7F7F7F7F7F7Full;
  return (((x & lo7) + lo7) | x) & ~lo7;
}

// put_block of the block whose int16 levels are (level0, lv[1..63])
void put_block8(WordWriter* w, const EncTables* t, const int8_t* lv,
                int level0, int intra) {
  int prev = 0;
  int first_inter = 0;
  if (intra) {
    ww_put(w, level0 == 128 ? 255u : (uint32_t)level0, 8);
  } else if (level0 != 0) {
    put_coef(w, t, 0, level0, 1);
  } else {
    prev = -1;
    first_inter = 1;
  }
  for (int word = 0; word < 8; ++word) {
    uint64_t x;
    std::memcpy(&x, lv + word * 8, 8);
    if (word == 0) x &= ~0xFFull;  // slot 0 is level0
    for (uint64_t m = nonzero_bytes(x); m; m &= m - 1) {
      int j = word * 8 + (__builtin_ctzll(m) >> 3);
      put_coef(w, t, j - prev - 1, lv[j], first_inter);
      prev = j;
      first_inter = 0;
    }
  }
  ww_put(w, 2u, 2);  // EOB '10'
}

}  // namespace

extern "C" {

// error counts per stream (errors[s * P64_SYM_ERRORS + kind])
enum { P64_BAD_CBP, P64_BAD_MQUANT, P64_BAD_GQUANT, P64_BAD_CODE,
       P64_SYM_ERRORS };

// Serialize streams [first, last) of a chunk of n_streams x n_frames
// pictures.  Per-MB arrays are in raster MB order, stream-major then
// frame; perm maps transmission index -> raster.  Stream s writes its
// bytes at out + offsets[s], at most offsets[s + 1] - offsets[s] of them,
// its bit count to nbits[s] and its symbol error counts to
// errors[s * P64_SYM_ERRORS ...] and the MBs it wrote with an MQUANT MTYPE
// to mquant_mbs[s].  Returns the number of streams of the range that
// outgrew their slot.
int64_t p64_serialize_batch(
    const EncTables* t,
    int64_t n_frames, int32_t n_mb, int32_t n_gob,
    const int32_t* gn_values,        // [n_gob]
    const int32_t* perm,             // [n_gob*33] -> raster index
    int32_t ptype,                   // 6-bit PTYPE value
    const uint8_t* frame_coded,      // [S*T]
    const int32_t* tr,               // [S*T]
    const int32_t* gquant,           // [S*T*n_gob]
    const uint8_t* coded,            // [S*T*n_mb]
    const int32_t* mtype,            // [S*T*n_mb]
    const int32_t* mv,               // [S*T*n_mb*2]
    const int32_t* cbp,              // [S*T*n_mb]
    const int8_t* levels8,           // [S*T*n_mb*6*64], slot 0 of intra 0
    const uint8_t* dc_intra,         // [S*T*n_mb*6] intra DC level, else 0
    const int32_t* quant_mb,         // [S*T*n_mb] (5-bit MQUANT values)
    const int32_t* n_stuff,          // [S*T] trailing MBA stuffing codes
    int64_t first, int64_t last,
    uint8_t* out, const int64_t* offsets,  // [S + 1]
    int64_t* nbits,                        // [S]
    int64_t* errors,                       // [S * P64_SYM_ERRORS]
    int64_t* mquant_mbs) {                 // [S]
  int64_t overflowed = 0;
  for (int64_t s = first; s < last; ++s) {
    WordWriter w{out + offsets[s], offsets[s + 1] - offsets[s], 0, 0, 0, 0};
    int64_t* err = errors + s * P64_SYM_ERRORS;
    for (int k = 0; k < P64_SYM_ERRORS; ++k) err[k] = 0;
    int64_t n_mquant = 0;
    for (int64_t f = s * n_frames; f < (s + 1) * n_frames; ++f) {
      if (!frame_coded[f]) continue;
      const int64_t mb0 = f * n_mb;
      const uint8_t* fcoded = coded + mb0;
      const int32_t* fmtype = mtype + mb0;
      const int32_t* fmv = mv + mb0 * 2;
      const int32_t* fcbp = cbp + mb0;
      const int32_t* fquant = quant_mb + mb0;
      const int8_t* flev = levels8 + mb0 * 6 * 64;
      const uint8_t* fdc = dc_intra + mb0 * 6;

      ww_put(&w, 0x00010u, 20);            // PSC
      ww_put(&w, (uint32_t)(tr[f] & 31), 5);
      ww_put(&w, (uint32_t)ptype, 6);
      ww_put(&w, 0u, 1);                   // PEI

      for (int g = 0; g < n_gob; ++g) {
        int gq = gquant[f * n_gob + g];
        err[P64_BAD_GQUANT] += gq < 1 || gq > 31;
        ww_put(&w, 1u, 16);                // GBSC
        ww_put(&w, (uint32_t)gn_values[g], 4);
        ww_put(&w, (uint32_t)gq, 5);
        ww_put(&w, 0u, 1);                 // GEI

        int prev_idx = -1;
        int prev_mvx = 0, prev_mvy = 0;
        int prev_was_mc = 0;
        for (int idx = 0; idx < kMbsPerGob; ++idx) {
          int raster = perm[g * kMbsPerGob + idx];
          if (!fcoded[raster]) continue;
          int mt = fmtype[raster];
          if (mt < 0 || mt >= kMtypes) {
            ++err[P64_BAD_CODE];
            continue;
          }
          const uint8_t* fl = t->mtype_flags + mt * 6;
          int gap = idx - prev_idx;
          ww_put(&w, t->mba_code[gap], t->mba_len[gap]);
          ww_put(&w, t->mtype_code[mt], t->mtype_len[mt]);
          if (fl[1]) {  // MQUANT: new 5-bit quantizer
            int q = fquant[raster];
            err[P64_BAD_MQUANT] += q < 1 || q > 31;
            ww_put(&w, (uint32_t)q, 5);
            ++n_mquant;
          }
          if (fl[2]) {  // MC -> MVD pair
            int px = 0, py = 0;
            if (idx % 11 != 0 && gap == 1 && prev_was_mc) {
              px = prev_mvx;
              py = prev_mvy;
            }
            int mvx = fmv[raster * 2], mvy = fmv[raster * 2 + 1];
            int dx = wrap_mvd(mvx - px), dy = wrap_mvd(mvy - py);
            if (dx < -16 || dx > 15 || dy < -16 || dy > 15) {
              ++err[P64_BAD_CODE];
            } else {
              ww_put(&w, t->mvd_code[dx + 16], t->mvd_len[dx + 16]);
              ww_put(&w, t->mvd_code[dy + 16], t->mvd_len[dy + 16]);
            }
            prev_mvx = mvx;
            prev_mvy = mvy;
            prev_was_mc = 1;
          } else {
            prev_was_mc = 0;
          }
          int blockmask = 0;
          if (fl[4]) {  // CBP
            int c = fcbp[raster];
            if (c < 1 || c > 63) {
              ++err[P64_BAD_CBP];
            } else {
              ww_put(&w, t->cbp_code[c], t->cbp_len[c]);
              blockmask = c;
            }
          } else if (fl[5]) {  // intra: all six blocks
            blockmask = 63;
          }
          for (int b = 0; b < 6; ++b) {
            if ((blockmask >> (5 - b)) & 1) {
              const int8_t* lv = flev + (raster * 6 + b) * 64;
              int dc = fdc[raster * 6 + b];
              put_block8(&w, t, lv, dc > 0 ? dc : lv[0], fl[0]);
            }
          }
          prev_idx = idx;
        }
      }
      // minimum-rate fill: MBA stuffing ('00000001111', H.261 Table 1)
      for (int32_t k = 0; k < n_stuff[f]; ++k) ww_put(&w, 0xFu, 11);
    }
    nbits[s] = ww_bits(&w);
    mquant_mbs[s] = n_mquant;
    ww_finish(&w);
    overflowed += w.overflow;
  }
  return overflowed;
}

}  // extern "C"
