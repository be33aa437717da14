"""Compiled lookup tables for vectorized VLC encode and table-driven decode.

The port's copy of `p64tpu.spec.luts`.  H.261's static code tables
(:mod:`p64tpu_torch.spec.tables`) are compiled into flat numpy arrays once
at import time:

  * encoder side: (value, length) arrays indexed by symbol, usable both from
    vectorized numpy packing on the host and -- for the *length* tables --
    from tensor code on the device, so exact bitstream lengths (and
    therefore rate control) are computed without materializing any bits.
  * decoder side: 2^K peek-K-bits LUTs mapping the next K bits to
    (symbol, bits-consumed), the classic single-lookup VLC decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import tables
from .constants import LEVEL_CLAMP

# ---------------------------------------------------------------------------
# Encoder-side tables
# ---------------------------------------------------------------------------


def _enc_arrays(code_map, size, offset=0):
    codes = np.zeros(size, dtype=np.uint32)
    lens = np.zeros(size, dtype=np.int32)
    for k, bits in code_map.items():
        v, n = tables.code_to_int(bits)
        codes[k + offset] = v
        lens[k + offset] = n
    return codes, lens


#: index by MBA value 1..33 (index 0 unused)
MBA_CODE, MBA_LEN = _enc_arrays(tables.MBA_CODES, 34)

#: index by MTYPE row index 0..9
MTYPE_CODE = np.zeros(10, dtype=np.uint32)
MTYPE_LEN = np.zeros(10, dtype=np.int32)
#: per-MTYPE flag vectors, index by row: intra/mquant/mc/fil/cbp/tcoeff
MTYPE_INTRA = np.zeros(10, dtype=bool)
MTYPE_MQUANT = np.zeros(10, dtype=bool)
MTYPE_MC = np.zeros(10, dtype=bool)
MTYPE_FIL = np.zeros(10, dtype=bool)
MTYPE_CBP = np.zeros(10, dtype=bool)
MTYPE_TCOEFF = np.zeros(10, dtype=bool)
for _i, (_n, _a, _q, _m, _f, _c, _t, _bits) in enumerate(tables.MTYPE_ROWS):
    MTYPE_CODE[_i], MTYPE_LEN[_i] = tables.code_to_int(_bits)
    MTYPE_INTRA[_i], MTYPE_MQUANT[_i], MTYPE_MC[_i] = _a, _q, _m
    MTYPE_FIL[_i], MTYPE_CBP[_i], MTYPE_TCOEFF[_i] = _f, _c, _t

#: index by (mvd + 16), mvd in -16..15
MVD_CODE, MVD_LEN = _enc_arrays(tables.MVD_CODES, 32, offset=16)

#: index by CBP value 1..63 (index 0 invalid, len 0)
CBP_CODE, CBP_LEN = _enc_arrays(tables.CBP_CODES, 64)

# TCOEFF: indexed by [run 0..63, |level| 0..LEVEL_CLAMP].
# TC_LEN includes the sign bit for table codes, and is the full 20-bit escape
# length for out-of-table pairs; TC_CODE holds the code WITHOUT sign and
# TC_IN_TABLE distinguishes the cases.  |level| = 0 rows are invalid (len 0).
TC_CODE = np.zeros((64, LEVEL_CLAMP + 1), dtype=np.uint32)
TC_LEN = np.zeros((64, LEVEL_CLAMP + 1), dtype=np.int32)
TC_IN_TABLE = np.zeros((64, LEVEL_CLAMP + 1), dtype=bool)
TC_LEN[:, 1:] = tables.TCOEFF_ESCAPE_BITS
for (_r, _l), _bits in tables.TCOEFF_CODES.items():
    v, n = tables.code_to_int(_bits)
    TC_CODE[_r, _l] = v
    TC_LEN[_r, _l] = n + 1  # + sign bit
    TC_IN_TABLE[_r, _l] = True

EOB_CODE, EOB_LEN = tables.code_to_int(tables.TCOEFF_EOB)
ESC_CODE, ESC_LEN = tables.code_to_int(tables.TCOEFF_ESCAPE)
FIRST01_CODE, FIRST01_LEN = tables.code_to_int(tables.TCOEFF_FIRST_01)

#: length saved when the first transmitted coefficient of an inter block is
#: (run 0, |level| 1): '1s' (2) instead of '11s' (3).
FIRST01_SAVING = (TC_LEN[0, 1]) - (FIRST01_LEN + 1)

MBA_STUFFING_CODE, MBA_STUFFING_LEN = tables.code_to_int(tables.MBA_STUFFING)

# ---------------------------------------------------------------------------
# Decoder-side peek LUTs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VlcLut:
    """Peek-K-bits decode table: for the next K bits (MSB-first, zero padded
    on the right if near EOF), `symbol[peek]` is the decoded symbol and
    `nbits[peek]` the bits consumed; nbits == 0 marks an invalid prefix."""

    k: int
    symbol: np.ndarray  # int32
    nbits: np.ndarray   # int32


def _build_lut(code_map, k: int) -> VlcLut:
    symbol = np.zeros(1 << k, dtype=np.int32)
    nbits = np.zeros(1 << k, dtype=np.int32)
    for sym, bits in code_map.items():
        v, n = tables.code_to_int(bits)
        assert n <= k, (sym, bits)
        lo = v << (k - n)
        hi = lo + (1 << (k - n))
        assert not nbits[lo:hi].any(), f"prefix clash at {sym}:{bits}"
        symbol[lo:hi] = sym
        nbits[lo:hi] = n
    return VlcLut(k, symbol, nbits)


#: MBA: symbols 1..33, 34 = stuffing.  Longest code 11 bits.
MBA_LUT = _build_lut({**tables.MBA_CODES, 34: tables.MBA_STUFFING}, 11)
MBA_STUFFING_SYMBOL = 34

#: MTYPE: symbols 0..9 are row indices.  Longest code 10 bits.
MTYPE_LUT = _build_lut(
    {i: r[-1] for i, r in enumerate(tables.MTYPE_ROWS)}, 10
)

#: MVD: symbol = primary value + 16 (0..31).  Longest code 11 bits.
MVD_LUT = _build_lut({v + 16: c for v, c in tables.MVD_CODES.items()}, 11)

#: CBP: symbols 1..63.  Longest code 9 bits.
CBP_LUT = _build_lut(tables.CBP_CODES, 9)

# TCOEFF decode LUT: peek 14 bits covers every table code + sign (13 + 1);
# escape bodies are parsed by the caller after consuming the 6-bit prefix.
TC_KIND_COEF, TC_KIND_EOB, TC_KIND_ESC, TC_KIND_INVALID = 0, 1, 2, 3
TC_PEEK = 14


def _build_tcoeff_lut(first: bool):
    n = 1 << TC_PEEK
    kind = np.full(n, TC_KIND_INVALID, dtype=np.int8)
    run = np.zeros(n, dtype=np.int8)
    level = np.zeros(n, dtype=np.int16)
    nbits = np.zeros(n, dtype=np.int8)

    def fill(bits: str, k, r, l, consumed):
        v, ln = tables.code_to_int(bits)
        lo = v << (TC_PEEK - ln)
        hi = lo + (1 << (TC_PEEK - ln))
        assert (kind[lo:hi] == TC_KIND_INVALID).all(), bits
        kind[lo:hi] = k
        run[lo:hi] = r
        level[lo:hi] = l
        nbits[lo:hi] = consumed

    for (r, l), bits in tables.TCOEFF_CODES.items():
        if first and (r, l) == (0, 1):
            continue  # replaced by the short form below
        for s in (0, 1):
            fill(bits + str(s), TC_KIND_COEF, r, -l if s else l, len(bits) + 1)
    if first:
        for s in (0, 1):
            fill(tables.TCOEFF_FIRST_01 + str(s), TC_KIND_COEF, 0,
                 -1 if s else 1, 2)
    else:
        fill(tables.TCOEFF_EOB, TC_KIND_EOB, 0, 0, 2)
    fill(tables.TCOEFF_ESCAPE, TC_KIND_ESC, 0, 0, 6)
    return kind, run, level, nbits


#: LUT used for the first coefficient of inter blocks ('1s' valid, no EOB).
TC_LUT_FIRST = _build_tcoeff_lut(first=True)
#: LUT used everywhere else (EOB valid, (0,1) is '11s').
TC_LUT_NEXT = _build_tcoeff_lut(first=False)
