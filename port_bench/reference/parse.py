"""Plain resync parse of an H.261 stream: bytes -> the pictures a decoder
that scans for start codes keeps.

The picture, GOB and macroblock layers of ITU-T Rec. H.261 (03/93) §4.2,
read over the code tables of `tables`, with PVRG-P64's error recovery: a
decoder that meets damage scans forward to the next start code.

  * The parse starts at the first start code (fifteen 0 bits, then a 1,
    with the 4 GN bits after it) at any bit offset; a stream with none
    has no picture.
  * GN 0 starts a picture: TR, PTYPE (its format bit), PEI and PSPARE.  A
    header that runs past the data discards the picture, and GOBs have no
    picture to go to until the next header parses.
  * A GN of the picture's format starts a GOB.  An invalid code, a
    forbidden value (GQUANT, MQUANT or an escape level of 0, an intra DC
    of 0 or 128, an escape level of -128), an address past the GOB's 33
    MBs, a run past slot 63, a vector outside the picture, or data that
    ends inside a code damages the GOB: the MBs parsed before it stay, and
    so does what the failed MB wrote (its vector, its filter flag, its
    coefficients), though it is not marked coded.  Any other GN, or bits
    between units that are no start code and no zero tail, damage the
    picture.  Either way the scan resumes at the bit where the damage was
    found.
  * A picture is one record that every later write to it updates in
    place: a GOB that comes twice is parsed twice over it, and the last
    write to a field or a coefficient wins.

A reading is zero-padded past the end of the data, a fixed-width field
that does not fit raises, and a code whose bits run past the end is found
when the next MB starts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import tables
from .blocks import transmission_order
from .constants import CIF, MBS_PER_GOB, QCIF, Format

#: bits peeked for each table: its longest code (with the TCOEFF sign)
MBA_PEEK, MTYPE_PEEK, MVD_PEEK, CBP_PEEK, TC_PEEK = 11, 10, 11, 9, 14
MBA_STUFFING = 34
#: TCOEFF entry kinds
COEF, EOB, ESC = 0, 1, 2


class Damage(Exception):
    """The bits at the reader's position cannot be parsed."""


def _lut(k: int, codes: Dict[object, str]) -> list:
    """A 2^k list: the next k bits -> (symbol, code length), or None."""
    out: list = [None] * (1 << k)
    for sym, bits in codes.items():
        lo = int(bits, 2) << (k - len(bits))
        for v in range(lo, lo + (1 << (k - len(bits)))):
            if out[v] is not None:
                raise ValueError(f"code {bits} is a prefix of another")
            out[v] = (sym, len(bits))
    return out


def _tcoeff_lut(first: bool) -> list:
    """The TCOEFF table for the first coefficient of an inter block ('1s'
    is (0, ±1) and no EOB) or for any other: entries (kind, run, level,
    length), the sign bit counted in a coefficient's length."""
    codes: Dict[object, str] = {}
    for (run, level), bits in tables.TCOEFF_CODES.items():
        if first and (run, level) == (0, 1):
            continue
        for s in (0, 1):
            codes[(COEF, run, -level if s else level)] = bits + str(s)
    if first:
        for s in (0, 1):
            codes[(COEF, 0, -1 if s else 1)] = tables.TCOEFF_FIRST_01 + str(s)
    else:
        codes[(EOB, 0, 0)] = tables.TCOEFF_EOB
    codes[(ESC, 0, 0)] = tables.TCOEFF_ESCAPE
    return [None if e is None else (*e[0], e[1])
            for e in _lut(TC_PEEK, codes)]


MBA_LUT = _lut(MBA_PEEK, {**tables.MBA_CODES,
                          MBA_STUFFING: tables.MBA_STUFFING})
MTYPE_LUT = _lut(MTYPE_PEEK, {i: row[7] for i, row in
                              enumerate(tables.MTYPE_ROWS)})
#: value -16..15 of an MVD code
MVD_LUT = _lut(MVD_PEEK, tables.MVD_CODES)
CBP_LUT = _lut(CBP_PEEK, tables.CBP_CODES)
TC_FIRST = _tcoeff_lut(first=True)
TC_NEXT = _tcoeff_lut(first=False)
#: MTYPE row -> (intra, mquant, mc, fil, cbp, tcoeff)
MTYPE_FLAGS = [tuple(row[1:7]) for row in tables.MTYPE_ROWS]


class Picture:
    """One picture as the parse left it, MBs in raster order.  While the
    parse runs, `levels` maps (MB × 6 + block) × 64 + zigzag slot to the
    last level written there (an intra DC as its level 1..254, code 255
    read as 128); `finish` then keeps them as the arrays `slots` and
    `values`.  Slots never written are 0.  `quant` is 1 where no MB was
    parsed."""

    def __init__(self, tr: int, fmt: Format):
        n = fmt.num_mbs
        self.tr, self.fmt = tr, fmt
        self.gquant = np.zeros(fmt.num_gobs, np.int32)
        self.coded = np.zeros(n, bool)
        self.intra = np.zeros(n, bool)
        self.mc = np.zeros(n, bool)
        self.fil = np.zeros(n, bool)
        self.quant = np.ones(n, np.int32)
        self.mv = np.zeros((n, 2), np.int32)
        self.cbp = np.zeros(n, np.int32)
        self.levels: Dict[int, int] = {}
        self.damaged = False
        self.gob_damaged = np.zeros(fmt.num_gobs, bool)

    def finish(self) -> None:
        self.slots = np.fromiter(self.levels.keys(), np.int64,
                                 len(self.levels))
        self.values = np.fromiter(self.levels.values(), np.int16,
                                  len(self.levels))
        del self.levels

    def dense_levels(self) -> np.ndarray:
        """(nMB, 6, 64) int16 levels of a finished picture."""
        out = np.zeros(self.fmt.num_mbs * 6 * 64, np.int16)
        out[self.slots] = self.values
        return out.reshape(self.fmt.num_mbs, 6, 64)


class Reader:
    """MSB-first bits of `data`, zero-padded past its end."""

    def __init__(self, data: bytes):
        self.buf = bytes(data) + bytes(16)
        self.nbits = 8 * len(data)
        self.pos = 0
        bits = np.unpackbits(np.frombuffer(bytes(data), np.uint8))
        if bits.size < 20:
            self.codes = np.empty(0, np.int64)
        else:
            c = np.concatenate([[0], np.cumsum(bits)])
            at = np.arange(bits.size - 19)
            self.codes = at[(c[at + 15] == c[at]) & (bits[at + 15] == 1)]

    def peek(self, n: int) -> int:
        p = self.pos
        w = int.from_bytes(self.buf[p >> 3:(p >> 3) + 4], "big")
        return (w >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise Damage(f"a {n}-bit field past the end at bit {self.pos}")
        v = self.peek(n)
        self.pos += n
        return v

    def vlc(self, lut: list, k: int):
        e = lut[self.peek(k)]
        if e is None:
            raise Damage(f"invalid code at bit {self.pos}")
        self.pos += e[1]
        return e[0]

    def scan(self) -> bool:
        """Move to the next start code at or after the position with its
        GN bits in the data; False where none is left."""
        j = int(np.searchsorted(self.codes, self.pos))
        if j == len(self.codes):
            return False
        self.pos = int(self.codes[j])
        return True

    def at_end(self) -> bool:
        """Nothing but a start code or a zero tail can follow here: data
        that ends, or fewer than 24 bits left that are all 0."""
        rem = self.nbits - self.pos
        return rem == 0 or (rem < 24 and self.peek(rem) == 0)

    def block(self, levels: Dict[int, int], base: int, intra: bool) -> None:
        """One block's coefficients up to its EOB, each written as it is
        read."""
        slot = 0
        lut = TC_FIRST
        if intra:
            dc = self.read(8)
            if dc in (0, 128):
                raise Damage(f"intra DC code {dc} at bit {self.pos}")
            levels[base] = 128 if dc == 255 else dc
            slot, lut = 1, TC_NEXT
        buf = self.buf
        while True:
            p = self.pos
            w = int.from_bytes(buf[p >> 3:(p >> 3) + 4], "big")
            e = lut[(w >> (18 - (p & 7))) & 0x3FFF]
            if e is None:
                raise Damage(f"invalid TCOEFF code at bit {p}")
            kind, run, level, n = e
            if kind == EOB:
                self.pos = p + 2
                return
            if kind == ESC:
                self.pos = p + 6
                run = self.read(6)
                lv = self.read(8)
                if lv in (0, 128):
                    raise Damage(f"escape level {lv} at bit {self.pos}")
                level = lv - 256 if lv >= 128 else lv
            else:
                self.pos = p + n
            slot += run
            if slot > 63:
                raise Damage(f"a run past slot 63 at bit {self.pos}")
            levels[base + slot] = level
            slot += 1
            lut = TC_NEXT


def _mv(pred: int, mvd: int) -> int:
    v = pred + mvd
    if v < -15:
        v += 32
    elif v > 15:
        v -= 32
    if not -15 <= v <= 15:
        raise Damage(f"vector component {v}")
    return v


def picture_header(r: Reader) -> Picture:
    """TR, PTYPE and PEI/PSPARE after a PSC."""
    tr = r.read(5)
    ptype = r.read(6)
    while r.read(1):
        r.read(8)
    return Picture(tr, CIF if (ptype >> 2) & 1 else QCIF)


def parse_gob(r: Reader, pic: Picture, gi: int, perm: np.ndarray) -> None:
    """GQUANT, GEI/GSPARE, then MBs until a start code, a zero tail or the
    end of the data."""
    fmt = pic.fmt
    gquant = r.read(5)
    if gquant == 0:
        raise Damage("GQUANT 0")
    pic.gquant[gi] = gquant
    while r.read(1):
        r.read(8)
    quant, addr = gquant, -1
    prev_mv, prev_mc = (0, 0), False
    while True:
        rem = r.nbits - r.pos
        if rem < 0:
            raise Damage("a code ran past the end of the data")
        if (rem >= 16 and r.peek(16) == 1) or r.at_end():
            return
        gap = r.vlc(MBA_LUT, MBA_PEEK)
        if gap == MBA_STUFFING:
            continue
        addr += gap
        if addr >= MBS_PER_GOB:
            raise Damage(f"MB address past the GOB at bit {r.pos}")
        mb = int(perm[gi * MBS_PER_GOB + addr])
        intra, mquant, mc, fil, has_cbp, tcoeff = MTYPE_FLAGS[
            r.vlc(MTYPE_LUT, MTYPE_PEEK)]
        if mquant:
            quant = r.read(5)
            if quant == 0:
                raise Damage("MQUANT 0")
        if mc:
            pred = (prev_mv if gap == 1 and addr % 11 != 0 and prev_mc
                    else (0, 0))
            mvx = _mv(pred[0], r.vlc(MVD_LUT, MVD_PEEK))
            mvy = _mv(pred[1], r.vlc(MVD_LUT, MVD_PEEK))
            y0 = (mb // fmt.mb_cols) * 16
            x0 = (mb % fmt.mb_cols) * 16
            if not (0 <= y0 + mvy and y0 + mvy + 16 <= fmt.height
                    and 0 <= x0 + mvx and x0 + mvx + 16 <= fmt.width):
                raise Damage(f"vector ({mvx}, {mvy}) outside the picture")
            pic.mv[mb] = (mvx, mvy)
            prev_mv, prev_mc = (mvx, mvy), True
            pic.mc[mb] = True
            pic.fil[mb] = fil
        else:
            prev_mc = False
        cbp = (r.vlc(CBP_LUT, CBP_PEEK) if has_cbp
               else 63 if tcoeff else 0)
        pic.cbp[mb] = cbp
        for b in range(6):
            if (cbp >> (5 - b)) & 1:
                r.block(pic.levels, (mb * 6 + b) * 64, intra)
        pic.coded[mb] = True
        pic.intra[mb] = intra
        pic.quant[mb] = quant


def parse_resync(data: bytes) -> List[Picture]:
    """The pictures of `data` under the scan for start codes (module
    docstring), finished."""
    pictures: List[Picture] = []
    _resync(Reader(data), pictures)
    for p in pictures:
        p.finish()
    return pictures


def _resync(r: Reader, pictures: List[Picture]) -> None:
    cur: Optional[Picture] = None
    perm, gob_index = None, {}
    if not r.scan():
        return
    while True:
        r.pos += 16
        gn = r.read(4)
        if gn == 0:
            try:
                cur = picture_header(r)
            except Damage:
                cur = None
                if not r.scan():
                    return
                continue
            pictures.append(cur)
            perm = transmission_order(cur.fmt)
            gob_index = {g: i for i, g in enumerate(cur.fmt.gob_numbers)}
        elif cur is None:
            if not r.scan():
                return
            continue
        elif gn not in gob_index:
            cur.damaged = True
            if not r.scan():
                return
            continue
        else:
            gi = gob_index[gn]
            try:
                parse_gob(r, cur, gi, perm)
            except Damage:
                cur.damaged = True
                cur.gob_damaged[gi] = True
                if not r.scan():
                    return
                continue
        if r.nbits - r.pos < 20:
            return
        if r.peek(16) != 1:
            if r.at_end():
                return
            if cur is not None:
                cur.damaged = True
            if not r.scan():
                return


def refusal(pictures: List[Picture]) -> Optional[str]:
    """Why a decoder of one sequence has no answer for these pictures, or
    None: it needs at least one picture, all of one format."""
    if not pictures:
        return "no picture"
    if any(p.fmt is not pictures[0].fmt for p in pictures):
        return "pictures of two formats"
    return None
