"""Compiled lookup tables for vectorized VLC encode.

Frozen copy of the port's encoder-side tables.  H.261's static code
tables (:mod:`tables`) are compiled once at import time into flat numpy
(value, length) arrays indexed by symbol, which the bit model (`lengths`)
and the serializer (`serialize`) index with tensors.
"""

from __future__ import annotations

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
