"""H.261 variable-length code tables.

All tables are transcribed from
ITU-T Rec. H.261 (03/93) section 4.2.4 (Tables 1-6) and were checked entry
by entry against the MPEG-1 tables that H.261 shares by construction
(ISO 11172-2 B.1 macroblock_address_increment == MBA incl. stuffing/escape
space, B.4 motion codes == MVD, B.3 coded_block_pattern == CBP, B.5 dct
coefficients == TCOEFF incl. EOB '10', first-(0,1) '1', escape '000001' +
6-bit run + 8-bit level with 0/-128 forbidden) plus the H.261-only MTYPE
table.

Codes are given as ('bitstring', ...) so they are self-documenting; LUT
builders in :mod:`luts` compile them into numpy arrays
for the vectorized encoder and the table-driven decoders.

Conventions:
  * bitstring '0001' is transmitted MSB-first, i.e. 0,0,0,1.
  * TCOEFF sign bit s: 0 => positive level, 1 => negative level.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# Table 1 -- macroblock address (MBA)
# ---------------------------------------------------------------------------

#: MBA 1..33.  Also reused (by construction in the Recommendation) as the
#: skeleton of the MVD table below.
MBA_CODES: Dict[int, str] = {
    1: "1",
    2: "011",
    3: "010",
    4: "0011",
    5: "0010",
    6: "00011",
    7: "00010",
    8: "0000111",
    9: "0000110",
    10: "00001011",
    11: "00001010",
    12: "00001001",
    13: "00001000",
    14: "00000111",
    15: "00000110",
    16: "0000010111",
    17: "0000010110",
    18: "0000010101",
    19: "0000010100",
    20: "0000010011",
    21: "0000010010",
    22: "00000100011",
    23: "00000100010",
    24: "00000100001",
    25: "00000100000",
    26: "00000011111",
    27: "00000011110",
    28: "00000011101",
    29: "00000011100",
    30: "00000011011",
    31: "00000011010",
    32: "00000011001",
    33: "00000011000",
}

#: MBA stuffing -- discarded by decoders, may be inserted freely before MBA.
MBA_STUFFING = "00000001111"

# ---------------------------------------------------------------------------
# Table 2 -- macroblock type (MTYPE)
# ---------------------------------------------------------------------------

#: MTYPE rows: (name, intra, mquant, mc, fil, cbp, tcoeff, code).
#: `mc` implies an MVD field is present; `cbp` implies a CBP field; `tcoeff`
#: implies coefficient blocks follow (for intra: all six blocks, no CBP).
MTYPE_ROWS: List[Tuple[str, bool, bool, bool, bool, bool, bool, str]] = [
    ("intra",            True,  False, False, False, False, True,  "0001"),
    ("intra_mquant",     True,  True,  False, False, False, True,  "0000001"),
    ("inter",            False, False, False, False, True,  True,  "1"),
    ("inter_mquant",     False, True,  False, False, True,  True,  "00001"),
    ("inter_mc",         False, False, True,  False, False, False, "000000001"),
    ("inter_mc_coef",    False, False, True,  False, True,  True,  "00000001"),
    ("inter_mc_mquant",  False, True,  True,  False, True,  True,  "0000000001"),
    ("inter_fil",        False, False, True,  True,  False, False, "001"),
    ("inter_fil_coef",   False, False, True,  True,  True,  True,  "01"),
    ("inter_fil_mquant", False, True,  True,  True,  True,  True,  "000001"),
]

MTYPE_BY_NAME = {r[0]: i for i, r in enumerate(MTYPE_ROWS)}

# ---------------------------------------------------------------------------
# Table 3 -- motion vector data (MVD)
# ---------------------------------------------------------------------------
# Each code stands for two displacement values differing by 32; only one of
# the pair yields a vector within +/-15 given the prediction, which resolves
# the ambiguity (H.261 section 4.2.3.3).  The code skeleton is MBA's: the
# k-th MBA code encodes the k-th MVD entry in the order 0, -1, +1, -2, +2,
# ..., -15, +15, -16.

_MVD_ORDER = [0]
for _m in range(1, 16):
    _MVD_ORDER += [-_m, _m]
_MVD_ORDER.append(-16)

#: primary value (-16..15) -> bitstring
MVD_CODES: Dict[int, str] = {
    v: MBA_CODES[i + 1] for i, v in enumerate(_MVD_ORDER)
}

# ---------------------------------------------------------------------------
# Table 4 -- coded block pattern (CBP)
# ---------------------------------------------------------------------------
# CBP = 32*P1 + 16*P2 + 8*P3 + 4*P4 + 2*P5 + P6 for blocks Y1 Y2 Y3 Y4 Cb Cr.
# CBP 0 never occurs (such MBs use a no-coefficient MTYPE or are skipped).

CBP_CODES: Dict[int, str] = {
    60: "111",
    4: "1101", 8: "1100", 16: "1011", 32: "1010",
    12: "10011", 48: "10010", 20: "10001", 40: "10000",
    28: "01111", 44: "01110", 52: "01101", 56: "01100",
    1: "01011", 61: "01010", 2: "01001", 62: "01000",
    24: "001111", 36: "001110", 3: "001101", 63: "001100",
    5: "0010111", 9: "0010110", 17: "0010101", 33: "0010100",
    6: "0010011", 10: "0010010", 18: "0010001", 34: "0010000",
    7: "00011111", 11: "00011110", 19: "00011101", 35: "00011100",
    13: "00011011", 49: "00011010", 21: "00011001", 41: "00011000",
    14: "00010111", 50: "00010110", 22: "00010101", 42: "00010100",
    15: "00010011", 51: "00010010", 23: "00010001", 43: "00010000",
    25: "00001111", 37: "00001110", 26: "00001101", 38: "00001100",
    29: "00001011", 45: "00001010", 53: "00001001", 57: "00001000",
    30: "00000111", 46: "00000110", 54: "00000101", 58: "00000100",
    31: "000000111", 47: "000000110", 55: "000000101", 59: "000000100",
    27: "000000011", 39: "000000010",
}

# ---------------------------------------------------------------------------
# Table 5 -- transform coefficients (TCOEFF)
# ---------------------------------------------------------------------------
# (run, |level|) -> bitstring WITHOUT the trailing sign bit.  A sign bit s
# (0 positive / 1 negative) follows every code below.
#
# The pair (0, 1) has two encodings: '1' is used only when it is the FIRST
# transmitted coefficient of an INTER-coded block (where EOB cannot occur, so
# there is no clash with EOB '10'); elsewhere '11' is used.  INTRA blocks
# carry their DC as an 8-bit FLC, so their ACs always use '11'.

TCOEFF_EOB = "10"
TCOEFF_FIRST_01 = "1"       # + sign bit
TCOEFF_ESCAPE = "000001"    # + 6-bit run + 8-bit two's-complement level

TCOEFF_CODES: Dict[Tuple[int, int], str] = {
    (0, 1): "11",
    (0, 2): "0100",
    (0, 3): "00101",
    (0, 4): "0000110",
    (0, 5): "00100110",
    (0, 6): "00100001",
    (0, 7): "0000001010",
    (0, 8): "000000011101",
    (0, 9): "000000011000",
    (0, 10): "000000010011",
    (0, 11): "000000010000",
    (0, 12): "0000000011010",
    (0, 13): "0000000011001",
    (0, 14): "0000000011000",
    (0, 15): "0000000010111",
    (1, 1): "011",
    (1, 2): "000110",
    (1, 3): "00100101",
    (1, 4): "0000001100",
    (1, 5): "000000011011",
    (1, 6): "0000000010110",
    (1, 7): "0000000010101",
    (2, 1): "0101",
    (2, 2): "0000100",
    (2, 3): "0000001011",
    (2, 4): "000000010100",
    (2, 5): "0000000010100",
    (3, 1): "00111",
    (3, 2): "00100100",
    (3, 3): "000000011100",
    (3, 4): "0000000010011",
    (4, 1): "00110",
    (4, 2): "0000001111",
    (4, 3): "000000010010",
    (5, 1): "000111",
    (5, 2): "0000001001",
    (5, 3): "0000000010010",
    (6, 1): "000101",
    (6, 2): "000000011110",
    (7, 1): "000100",
    (7, 2): "000000010101",
    (8, 1): "0000111",
    (8, 2): "000000010001",
    (9, 1): "0000101",
    (9, 2): "0000000010001",
    (10, 1): "00100111",
    (10, 2): "0000000010000",
    (11, 1): "00100011",
    (12, 1): "00100010",
    (13, 1): "00100000",
    (14, 1): "0000001110",
    (15, 1): "0000001101",
    (16, 1): "0000001000",
    (17, 1): "000000011111",
    (18, 1): "000000011010",
    (19, 1): "000000011001",
    (20, 1): "000000010111",
    (21, 1): "000000010110",
    (22, 1): "0000000011111",
    (23, 1): "0000000011110",
    (24, 1): "0000000011101",
    (25, 1): "0000000011100",
    (26, 1): "0000000011011",
}

#: escape total length: 6 (ESC) + 6 (run) + 8 (level)
TCOEFF_ESCAPE_BITS = 20


def code_to_int(bits: str) -> Tuple[int, int]:
    """'0101' -> (value=5, length=4)."""
    return int(bits, 2), len(bits)


def kraft_sum(codes) -> float:
    """Kraft inequality sum over an iterable of bitstrings (<= 1 iff the set
    can be prefix-free; == 1 iff complete)."""
    return sum(2.0 ** -len(c) for c in codes)
