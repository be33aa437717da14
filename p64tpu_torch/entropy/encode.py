"""Host-side bitstream serializer: per-frame symbol arrays -> H.261 bits.

Port of the pure-Python serializer in `p64tpu/entropy/encode.py` (the
reference module imports JAX through `core.blocks`).  It walks the symbol
arrays in GOB/MBA transmission order and packs VLCs with
`p64tpu.entropy.bitio.BitWriter`.  It MUST emit exactly the number of bits
the device length model (`entropy.lengths`) predicts; the encoder asserts
that on every encode.  The per-frame arrays are turned into Python lists
once, which keeps the walk free of numpy scalar indexing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np

from p64tpu.entropy.bitio import BitWriter
from p64tpu.spec import luts
from p64tpu.spec.constants import (
    GBSC_BITS,
    GBSC_VALUE,
    GN_BITS,
    GQUANT_BITS,
    MBS_PER_GOB,
    PEI_BITS,
    PSC_BITS,
    PSC_VALUE,
    PTYPE_BITS,
    TR_BITS,
    Format,
    ptype_value,
)

from ..core.blocks import transmission_order


@dataclasses.dataclass
class FrameSymbols:
    """Everything the host needs to serialize one coded picture.

    Per-MB arrays are in raster MB order; the serializer applies the
    GOB-major transmission permutation itself.

      tr:      temporal reference (0..31)
      gquant:  (nGOB,) GQUANT per GOB, transmission order
      coded:   (nMB,) bool, MB is transmitted
      mtype:   (nMB,) int, MTYPE row index (0..9); valid where coded
      mv:      (nMB, 2) int, (mvx, mvy); valid where MTYPE has MC
      cbp:     (nMB,) int, coded block pattern; valid where MTYPE has CBP
      levels:  (nMB, 6, 64) int, zigzag levels; intra MBs hold the DC
               *level* (1..254) in levels[:, :, 0]
      quant_mb: (nMB,) int effective quantizer, written as MQUANT wherever
               mtype is an MQUANT variant; may be None when none is.
      n_stuff: MBA stuffing codes appended after the last GOB.
    """

    tr: int
    gquant: np.ndarray
    coded: np.ndarray
    mtype: np.ndarray
    mv: np.ndarray
    cbp: np.ndarray
    levels: np.ndarray
    quant_mb: Optional[np.ndarray] = None
    n_stuff: int = 0


def wrap_mvd(mv: int, pred: int) -> int:
    """MVD = MV - pred, folded into the codeable range -16..15 by +/-32."""
    d = mv - pred
    if d < -16:
        d += 32
    elif d > 15:
        d -= 32
    return d


_MBA_CODE = luts.MBA_CODE.tolist()
_MBA_LEN = luts.MBA_LEN.tolist()
_MTYPE_CODE = luts.MTYPE_CODE.tolist()
_MTYPE_LEN = luts.MTYPE_LEN.tolist()
_MTYPE_MQUANT = luts.MTYPE_MQUANT.tolist()
_MTYPE_MC = luts.MTYPE_MC.tolist()
_MTYPE_INTRA = luts.MTYPE_INTRA.tolist()
_MTYPE_CBP = luts.MTYPE_CBP.tolist()
_MTYPE_TCOEFF = luts.MTYPE_TCOEFF.tolist()
_MVD_CODE = luts.MVD_CODE.tolist()
_MVD_LEN = luts.MVD_LEN.tolist()
_CBP_CODE = luts.CBP_CODE.tolist()
_CBP_LEN = luts.CBP_LEN.tolist()
_TC_CODE = luts.TC_CODE.tolist()
_TC_LEN = luts.TC_LEN.tolist()
_TC_IN_TABLE = luts.TC_IN_TABLE.tolist()


def _put_block(sink: BitWriter, zz: Sequence[int], intra: bool) -> None:
    """Serialize one 8x8 block's zigzag levels (+EOB)."""
    if intra:
        dc = zz[0]
        sink.put(255 if dc == 128 else dc, 8)
        start = 1
        first_inter = False
    else:
        start = 0
        first_inter = True
    prev = start - 1
    for j in range(start, 64):
        level = zz[j]
        if level == 0:
            continue
        run = j - prev - 1
        prev = j
        alevel = abs(level)
        sign = 1 if level < 0 else 0
        if first_inter and run == 0 and alevel == 1:
            sink.put((luts.FIRST01_CODE << 1) | sign, luts.FIRST01_LEN + 1)
        elif alevel <= 127 and _TC_IN_TABLE[run][alevel]:
            sink.put((_TC_CODE[run][alevel] << 1) | sign,
                     _TC_LEN[run][alevel])
        else:
            assert -127 <= level <= 127, level
            body = (luts.ESC_CODE << 14) | (run << 8) | (level & 0xFF)
            sink.put(body, 20)
        first_inter = False
    sink.put(luts.EOB_CODE, luts.EOB_LEN)


@functools.lru_cache(maxsize=None)
def _perm(fmt: Format) -> Tuple[int, ...]:
    return tuple(transmission_order(fmt).tolist())


def serialize_frame(fmt: Format, sym: FrameSymbols, sink: BitWriter) -> None:
    perm = _perm(fmt)
    coded = np.asarray(sym.coded).tolist()
    mtype = np.asarray(sym.mtype).tolist()
    mv = np.asarray(sym.mv).tolist()
    cbps = np.asarray(sym.cbp).tolist()
    quant_mb = (None if sym.quant_mb is None
                else np.asarray(sym.quant_mb).tolist())
    levels = np.asarray(sym.levels)

    # Picture header: PSC TR PTYPE PEI=0
    sink.put(PSC_VALUE, PSC_BITS)
    sink.put(sym.tr & 31, TR_BITS)
    sink.put(ptype_value(fmt.is_cif), PTYPE_BITS)
    sink.put(0, PEI_BITS)

    for gi, gn in enumerate(fmt.gob_numbers):
        sink.put(GBSC_VALUE, GBSC_BITS)
        sink.put(gn, GN_BITS)
        sink.put(int(sym.gquant[gi]), GQUANT_BITS)
        sink.put(0, PEI_BITS)  # GEI

        prev_idx = -1     # last coded MB's in-GOB index
        prev_mv = (0, 0)  # last MB's MV if it was MC-coded
        prev_was_mc = False
        for idx in range(MBS_PER_GOB):
            raster = perm[gi * MBS_PER_GOB + idx]
            if not coded[raster]:
                continue
            mt = mtype[raster]
            sink.put(_MBA_CODE[idx - prev_idx], _MBA_LEN[idx - prev_idx])
            sink.put(_MTYPE_CODE[mt], _MTYPE_LEN[mt])
            if _MTYPE_MQUANT[mt]:
                assert quant_mb is not None, (
                    "MQUANT MTYPE requires per-MB quant values")
                q = quant_mb[raster]
                assert 1 <= q <= 31, q
                sink.put(q, 5)
            if _MTYPE_MC[mt]:
                # predictor resets at MB 1/12/23 of the GOB, on address
                # gaps, and when the previous MB was not MC-coded.
                if idx % 11 == 0 or idx - prev_idx != 1 or not prev_was_mc:
                    pred = (0, 0)
                else:
                    pred = prev_mv
                mvx, mvy = mv[raster]
                for comp, p in zip((mvx, mvy), pred):
                    d = wrap_mvd(comp, p)
                    sink.put(_MVD_CODE[d + 16], _MVD_LEN[d + 16])
                prev_mv = (mvx, mvy)
                prev_was_mc = True
            else:
                prev_was_mc = False
            intra = _MTYPE_INTRA[mt]
            if _MTYPE_CBP[mt]:
                cbp = cbps[raster]
                assert 1 <= cbp <= 63, cbp
                sink.put(_CBP_CODE[cbp], _CBP_LEN[cbp])
                blockmask = [(cbp >> (5 - b)) & 1 for b in range(6)]
            elif _MTYPE_TCOEFF[mt]:  # intra: all six blocks
                blockmask = [1] * 6
            else:  # MC / FIL without coefficients
                blockmask = [0] * 6
            if any(blockmask):
                mb_levels = levels[raster].tolist()
                for b in range(6):
                    if blockmask[b]:
                        _put_block(sink, mb_levels[b], intra)
            prev_idx = idx

    # minimum-rate fill: stuffing codes trail the last GOB's macroblocks
    for _ in range(int(sym.n_stuff)):
        sink.put(luts.MBA_STUFFING_CODE, luts.MBA_STUFFING_LEN)


def serialize_sequence(fmt: Format,
                       frames: Sequence[FrameSymbols]) -> Tuple[bytes, int]:
    """Pack a whole sequence; returns (bytes, total_bits), zero-padded to a
    byte boundary at the very end only."""
    sink = BitWriter()
    for sym in frames:
        serialize_frame(fmt, sym, sink)
    return sink.getvalue(), sink.nbits

