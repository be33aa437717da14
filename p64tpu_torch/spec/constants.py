"""H.261 (p×64) bitstream and geometry constants.

The port's copy of `p64tpu.spec.constants`; tests/test_torch_imports.py
holds the two equal.  Every value is taken from ITU-T Rec. H.261 (03/93).

Layout recap (H.261 section 4.2):

  Picture  = PSC TR PTYPE PEI [PSPARE PEI]* GOB+
  GOB      = GBSC GN GQUANT GEI [GSPARE GEI]* MB*
  MB       = MBA MTYPE [MQUANT] [MVD] [CBP] block*
  block    = [INTRA DC 8-bit FLC] TCOEFF* EOB
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Start codes (H.261 sections 4.2.1, 4.2.2)
# ---------------------------------------------------------------------------

#: Picture start code: 20 bits, 0000 0000 0000 0001 0000.
PSC_VALUE = 0x00010
PSC_BITS = 20

#: GOB start code: 16 bits, 0000 0000 0000 0001.  PSC == GBSC followed by
#: GN == 0, which is why GN 0 is reserved.
GBSC_VALUE = 0x0001
GBSC_BITS = 16

TR_BITS = 5        # temporal reference, mod 32
PTYPE_BITS = 6
GN_BITS = 4
GQUANT_BITS = 5
MQUANT_BITS = 5
PEI_BITS = 1
PSPARE_BITS = 8

#: PTYPE bit values (bit 1 transmitted first):
#:   b1 split screen, b2 document camera, b3 freeze picture release,
#:   b4 source format (0 = QCIF, 1 = CIF), b5 still-image (HI_RES) mode
#:   (1 = off), b6 spare (shall be 1).
def ptype_value(is_cif: bool) -> int:
    bits = [0, 0, 0, 1 if is_cif else 0, 1, 1]
    v = 0
    for b in bits:
        v = (v << 1) | b
    return v


# ---------------------------------------------------------------------------
# Geometry (H.261 section 3.1)
# ---------------------------------------------------------------------------

MB_SIZE = 16          # luma pixels per macroblock edge
BLOCK_SIZE = 8        # transform block edge
BLOCKS_PER_MB = 6     # Y1 Y2 Y3 Y4 Cb Cr, in transmission order
MBS_PER_GOB = 33      # 11 cols x 3 rows
GOB_MB_COLS = 11
GOB_MB_ROWS = 3
GOB_WIDTH = 176       # luma pixels
GOB_HEIGHT = 48

#: Search window of the full-search ME (H.261 limits MVs to +/-15).
DEFAULT_SEARCH_RANGE = 15

#: H.261 section 4.2.3.4: every MB shall be INTRA-coded at least once per
#: 132 times coefficients are transmitted for it.
INTRA_REFRESH_PERIOD = 132

QUANT_MIN = 1
QUANT_MAX = 31

#: Coefficient clamp after inverse quantization (H.261 section 4.2.4.4).
COEFF_CLAMP_MIN = -2048
COEFF_CLAMP_MAX = 2047

#: Transmittable TCOEFF level magnitude bound: the escape level field is an
#: 8-bit two's-complement word whose values 0000 0000 and 1000 0000 are
#: forbidden (H.261 section 4.2.4.3) => |level| <= 127.
LEVEL_CLAMP = 127

#: Intra DC level range: the DC FLC is 8 bits with codes 0000 0000 and
#: 1000 0000 forbidden and level 128 transmitted as code 1111 1111
#: (H.261 section 4.2.4.1) => representable levels are 1..254.
INTRA_DC_MIN = 1
INTRA_DC_MAX = 254


@dataclasses.dataclass(frozen=True)
class Format:
    """Picture format descriptor (CIF or QCIF, H.261 section 3.1)."""

    name: str
    width: int            # luma
    height: int
    gob_numbers: tuple    # GN values in transmission order
    gob_cols: int         # GOB grid: columns of GOBs

    @property
    def chroma_width(self) -> int:
        return self.width // 2

    @property
    def chroma_height(self) -> int:
        return self.height // 2

    @property
    def mb_cols(self) -> int:
        return self.width // MB_SIZE

    @property
    def mb_rows(self) -> int:
        return self.height // MB_SIZE

    @property
    def num_mbs(self) -> int:
        return self.mb_cols * self.mb_rows

    @property
    def num_gobs(self) -> int:
        return len(self.gob_numbers)

    @property
    def gob_rows(self) -> int:
        return self.num_gobs // self.gob_cols

    @property
    def is_cif(self) -> bool:
        return self.name == "CIF"


#: CIF: 12 GOBs in a 2-wide, 6-tall grid; GN 1..12 raster (1 top-left,
#: 2 top-right, 3 second-row-left, ...).  H.261 Figure 8.
CIF = Format("CIF", 352, 288, tuple(range(1, 13)), 2)

#: QCIF: 3 GOBs stacked vertically, GN 1, 3, 5.  H.261 Figure 8.
QCIF = Format("QCIF", 176, 144, (1, 3, 5), 1)

FORMATS = {"CIF": CIF, "QCIF": QCIF}


def format_for_size(width: int, height: int) -> Format:
    for f in FORMATS.values():
        if (f.width, f.height) == (width, height):
            return f
    raise ValueError(f"unsupported picture size {width}x{height} (need CIF/QCIF)")
