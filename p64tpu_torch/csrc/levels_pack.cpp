// Packs the dense int8 levels of a parsed stream into the form the decode
// ships to the card (core/decoder.py::stack_seqs), where
// csrc/levels_expand.cu expands them back.  Of a CIF picture's 152,064 level
// slots an inter frame of conference content fills a few thousand; the
// packed form carries those and the masks that place them:
//
//   mb_mask  uint8  (frames, mbs)     bit b set where block b of the MB holds
//                                     a nonzero level
//   blocks   uint64 (n_blocks,)       one per such block, in (frame, MB,
//                                     block) order: bit j set where slot j
//                                     is nonzero
//   values   int8   (n_values,)       the nonzero levels in (frame, MB,
//                                     block, slot) order
//   offsets  int64  (frames + 1, 2)   blocks and values before each frame;
//                                     the last row holds the totals
//
// A macroblock costs 1 + 8 x (nonzero blocks) + (nonzero levels) bytes: at
// worst 433 against the dense 384, about 30 on the decode benchmark's
// content.
//
// It reads the final dense array the parser wrote, never the symbols as they
// were parsed: a resync parse can parse one block twice, and the last write
// wins.  A pack of the final state keeps that rule by construction, negative
// slot-0 inter levels included.
//
// Beside the pack, p64_picture_starts counts a stream's picture start
// codes, which size the parse's output buffers (native/binding.py).
//
// Built with the bit-I/O engine's flags (kernels/_build.py) into its own
// library; plain C interface for ctypes, which releases the GIL, so the
// parse threads pack and count their streams in parallel.

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlocks = 6;   // blocks in an MB
constexpr int kSlots = 64;   // level slots in a block

// Bit i set where byte i of w is nonzero.
inline uint32_t nonzero_bytes(uint64_t w) {
  const uint64_t low7 = 0x7F7F7F7F7F7F7F7FULL;
  // the high bit of each byte: set iff any of its bits is
  const uint64_t high = ((((w & low7) + low7) | w) >> 7) & 0x0101010101010101ULL;
  // gather byte i's bit (at 8i) into bit 56 + i: the products land on
  // distinct positions, so nothing carries
  return static_cast<uint32_t>((high * 0x0102040810204080ULL) >> 56);
}

// Mask of the nonzero slots of one 64-byte block.  Most blocks of inter
// pictures are all zero: one OR over the block tells, before any mask.
inline uint64_t block_mask(const int8_t* block) {
  uint64_t w[kSlots / 8], any = 0;
  memcpy(w, block, kSlots);
  for (int k = 0; k < kSlots / 8; ++k) any |= w[k];
  if (!any) return 0;
  uint64_t mask = 0;
  for (int k = 0; k < kSlots / 8; ++k)
    mask |= static_cast<uint64_t>(nonzero_bytes(w[k])) << (8 * k);
  return mask;
}

}  // namespace

extern "C" {

// Pack `frames` pictures of `mbs` macroblocks: levels[f * frame_stride +
// (mb * 6 + b) * 64 + j].  The caller sizes blocks for frames x mbs x 6 and
// values for frames x mbs x 384.  Returns the number of values written, or
// -1 on a negative size.
int64_t p64_pack_levels(const int8_t* levels, int64_t frames, int32_t mbs,
                        int64_t frame_stride, uint8_t* mb_mask,
                        uint64_t* blocks, int8_t* values, int64_t* offsets) {
  if (frames < 0 || mbs < 0 || frame_stride < 0) return -1;
  int64_t n_blocks = 0, n_values = 0;
  for (int64_t f = 0; f < frames; ++f) {
    offsets[2 * f] = n_blocks;
    offsets[2 * f + 1] = n_values;
    const int8_t* frame = levels + f * frame_stride;
    for (int32_t mb = 0; mb < mbs; ++mb) {
      uint8_t present = 0;
      for (int b = 0; b < kBlocks; ++b) {
        const int8_t* block = frame + (mb * kBlocks + b) * kSlots;
        uint64_t mask = block_mask(block);
        if (!mask) continue;
        present |= static_cast<uint8_t>(1u << b);
        blocks[n_blocks++] = mask;
        while (mask) {
          values[n_values++] = block[__builtin_ctzll(mask)];
          mask &= mask - 1;
        }
      }
      mb_mask[f * mbs + mb] = present;
    }
  }
  offsets[2 * frames] = n_blocks;
  offsets[2 * frames + 1] = n_values;
  return n_values;
}

// Picture start codes (15 zeros, a one, then GN 0000) at any bit position
// of data[0..n), read as if ones came before it and zeros after it: at least
// as many as the pictures any parse of it finds.  The 15 zeros of a code
// cover exactly one whole zero byte k, and the code starts in the 8 bits
// that end with byte k's first; so only the zero bytes are looked at, each
// with the byte before it and the two after it.
int64_t p64_picture_starts(const uint8_t* data, int64_t n) {
  int64_t count = 0;
  const uint8_t* end = data + n;
  for (const uint8_t* z = data; z < end; ++z) {
    z = static_cast<const uint8_t*>(
        memchr(z, 0, static_cast<size_t>(end - z)));
    if (!z) break;
    // the byte before, the zero byte (bits 8..15, all 0) and two after
    const uint32_t before = z > data ? z[-1] : 0xFF;
    const uint32_t after1 = z + 1 < end ? z[1] : 0;
    const uint32_t after2 = z + 2 < end ? z[2] : 0;
    const uint32_t word = before << 24 | after1 << 8 | after2;
    for (int shift = 4; shift < 12; ++shift)
      count += ((word >> shift) & 0xFFFFF) == 0x10;
  }
  return count;
}

}  // extern "C"
