"""H.261 bitstream parser: bytes -> dense per-picture symbol arrays.

Port of `p64tpu/entropy/parse.py` (which imports JAX through
`core.blocks`).  The parse is bit-serial, so it runs on the host; the
device does all reconstruction math batched (core.decoder).  This module
is the oracle parser: the decoder parses through the C++ engine
(`native.binding`), whose output contract is identical, and the tests
hold the two against each other and against the JAX package's parser.

Accepts any compliant H.261 stream within CIF/QCIF, including mid-GOB
MQUANT and MBA stuffing.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..entropy.bitio import BitReader
from ..spec import luts
from ..spec.constants import (
    CIF,
    MBS_PER_GOB,
    QCIF,
    Format,
)
from ..core.blocks import transmission_order


@dataclasses.dataclass
class ParsedFrame:
    """Dense symbol view of one coded picture, raster MB order.

    levels holds zigzag levels with intra DC *levels* (1..254, code 255
    already mapped to 128) in slot 0; all-zero rows for untransmitted
    blocks/MBs.

    damaged / gob_damaged are only ever set by the resync parse mode
    (parse_stream(strict=False)): a damaged GOB keeps the MBs decoded
    before the error (the rest stay uncoded -- the device reconstruct
    conceals them as copy-from-reference); `damaged` also covers damage
    that could not be attributed to a GOB (invalid GN, garbage between
    units)."""

    tr: int
    fmt: Format
    gquant: np.ndarray   # (nGOB,)
    coded: np.ndarray    # (nMB,) bool
    intra: np.ndarray    # (nMB,) bool
    mc: np.ndarray       # (nMB,) bool
    fil: np.ndarray      # (nMB,) bool
    quant: np.ndarray    # (nMB,) effective quant at each MB
    mv: np.ndarray       # (nMB, 2) (mvx, mvy)
    cbp: np.ndarray      # (nMB,)
    levels: np.ndarray   # (nMB, 6, 64) int16
    damaged: bool = False               # any damage event in this picture
    gob_damaged: np.ndarray = None      # (nGOB,) bool (resync mode)


class StreamError(ValueError):
    pass


def _decode_vlc(r: BitReader, lut: luts.VlcLut, what: str) -> int:
    peek = r.peek(lut.k)
    n = int(lut.nbits[peek])
    if n == 0:
        raise StreamError(f"invalid {what} code at bit {r.pos}")
    r.skip(n)
    return int(lut.symbol[peek])


def _decode_block(r: BitReader, intra: bool, zz: np.ndarray) -> None:
    """Decode one block's TCOEFF sequence (incl. intra DC) up to EOB,
    writing coefficients into `zz` (a zeroed (64,) int16 view) AS THEY
    DECODE -- so a StreamError mid-block leaves the coefficients decoded
    before the error in place, exactly like the C++ parse_block writes
    directly into the output tensor.  Strict parses abort wholesale so
    never observe partials; the resync mode keeps them (and tests assert
    both engines agree on corrupted input)."""
    pos = 0
    if intra:
        code = r.read(8)
        if code in (0, 128):
            raise StreamError(f"forbidden intra DC code {code} at bit {r.pos}")
        zz[0] = 128 if code == 255 else code
        pos = 1
        first = False
    else:
        first = True
    while True:
        lutk, lutr, lutl, lutn = (luts.TC_LUT_FIRST if first
                                  else luts.TC_LUT_NEXT)
        peek = r.peek(luts.TC_PEEK)
        kind = int(lutk[peek])
        if kind == luts.TC_KIND_INVALID:
            raise StreamError(f"invalid TCOEFF code at bit {r.pos}")
        if kind == luts.TC_KIND_EOB:
            r.skip(2)
            return
        if kind == luts.TC_KIND_ESC:
            r.skip(6)
            run = r.read(6)
            lv = r.read(8)
            if lv in (0, 0x80):
                raise StreamError(f"forbidden escape level at bit {r.pos}")
            level = lv - 256 if lv >= 128 else lv
        else:
            r.skip(int(lutn[peek]))
            run, level = int(lutr[peek]), int(lutl[peek])
        pos += run
        if pos > 63:
            raise StreamError(f"coefficient position overflow at bit {r.pos}")
        zz[pos] = level
        pos += 1
        first = False
        if pos > 64:
            return


def _mv_from_mvd(pred: int, mvd: int) -> int:
    v = pred + mvd
    if v < -15:
        v += 32
    elif v > 15:
        v -= 32
    if not -15 <= v <= 15:
        raise StreamError(f"undecodable MV {v}")
    return v


def parse_stream(data: bytes, strict: bool = True) -> List[ParsedFrame]:
    """Parse an H.261 stream.

    strict=True (default): the first invalid code / forbidden value /
    truncation raises StreamError -- the test-oracle contract.

    strict=False: start-code resync error recovery, mirroring the
    reference decoder's "scan for PSC" loop: on
    damage, scan forward to the next PSC/GBSC, mark the damaged
    GOB/picture (ParsedFrame.damaged / .gob_damaged), keep the MBs
    already decoded, and continue.  Never raises on corrupt input; a
    stream with no start code at all parses as zero frames.  Contract is
    mirrored bit-for-bit by the C++ engine (native.parse(resync=True));
    tests assert both agree on arbitrary corrupted input.
    """
    r = BitReader(data)
    if not strict:
        return _parse_resync(r)
    frames: List[ParsedFrame] = []
    # stream must start with a PSC
    if r.remaining < 20 or r.read(16) != 1 or r.read(4) != 0:
        raise StreamError("stream does not start with PSC")
    more = True
    while more:
        try:
            frame, more = _parse_picture(r)
        except EOFError as e:
            # fixed-width reads (TR/PTYPE/PEI, GQUANT, MQUANT, escapes) hit
            # BitReader's EOFError on truncated streams; the module's
            # declared error type is StreamError -- keep the contract (and
            # match the native parser's P64_ERR_TRUNCATED)
            raise StreamError(
                f"truncated stream at bit {r.pos}: {e}") from e
        frames.append(frame)
    return frames


def _picture_header(r: BitReader) -> ParsedFrame:
    """TR/PTYPE/PEI (the PSC incl. GN=0 already consumed) -> empty frame."""
    tr = r.read(5)
    ptype = r.read(6)
    fmt = CIF if (ptype >> 2) & 1 else QCIF
    while r.read(1):         # PEI/PSPARE loop
        r.read(8)
    n = fmt.num_mbs
    return ParsedFrame(
        tr=tr, fmt=fmt,
        gquant=np.zeros(fmt.num_gobs, np.int32),
        coded=np.zeros(n, bool), intra=np.zeros(n, bool),
        mc=np.zeros(n, bool), fil=np.zeros(n, bool),
        quant=np.ones(n, np.int32), mv=np.zeros((n, 2), np.int32),
        cbp=np.zeros(n, np.int32), levels=np.zeros((n, 6, 64), np.int16),
        gob_damaged=np.zeros(fmt.num_gobs, bool),
    )


def _scan_start_code(r: BitReader) -> bool:
    """Advance r.pos to the next 16-bit start-code prefix ('0'*15 + '1')
    at ANY bit offset >= r.pos that still has the 4 GN bits after it
    (20 bits total).  Returns True with r.pos AT the code, else False.
    In a zero run longer than 15 the match is the LAST 15 zeros before
    the 1 (the only offset whose bit 15 is a 1), matching the C++
    scan_start_code.

    ALL start-code positions are computed once per reader (one vectorized
    O(n) pass, cached on the BitReader) and each rescan is a binary
    search: recomputing a full-stream cumsum per damage event would make
    resync O(bits x damage_events) with ~8x-stream-size temporaries per
    rescan."""
    cached = getattr(r, "_start_code_positions", None)
    if cached is None:
        bits = r._bits
        n = bits.size
        if n < 20:
            cached = np.empty(0, np.int64)
        else:
            c = np.concatenate([[0], np.cumsum(bits)])
            idx = np.arange(0, n - 19)
            cached = idx[((c[idx + 15] - c[idx]) == 0)
                         & (bits[idx + 15] == 1)]
        r._start_code_positions = cached
    j = np.searchsorted(cached, max(r.pos, 0))
    if j >= cached.size:
        return False
    r.pos = int(cached[j])
    return True


def _parse_resync(r: BitReader) -> List[ParsedFrame]:
    """Start-code resync loop; see parse_stream(strict=False).

    Mirrored bit-for-bit by the C++ parse_resync (native/bitio.cpp):
    every rescan starts AT the reader position where the error was
    detected, a damaged picture header discards the frame and drops
    picture context until the next header parses, and headerless GOBs
    are skipped."""
    frames: List[ParsedFrame] = []
    cur = None
    perm = None
    g2i = None
    if not _scan_start_code(r):
        return frames
    while True:
        # r.pos is AT a start code with >= 20 bits through GN
        r.skip(16)
        gn = r.read(4)
        if gn == 0:
            try:
                cur = _picture_header(r)
            except (StreamError, EOFError):
                cur = None
                if not _scan_start_code(r):
                    return frames
                continue
            frames.append(cur)
            perm = transmission_order(cur.fmt)
            g2i = {g: i for i, g in enumerate(cur.fmt.gob_numbers)}
        elif cur is None:
            # a GOB with no picture context cannot be placed; skip it
            if not _scan_start_code(r):
                return frames
            continue
        else:
            gi = g2i.get(int(gn))
            if gi is None:
                cur.damaged = True
                if not _scan_start_code(r):
                    return frames
                continue
            try:
                _parse_gob(r, cur, gi, perm)
            except (StreamError, EOFError):
                cur.damaged = True
                cur.gob_damaged[gi] = True
                if not _scan_start_code(r):
                    return frames
                continue
        rem = r.remaining
        if rem < 20:
            return frames
        if r.peek(16) != 1:
            if rem < 24 and r.peek(min(rem, 24)) == 0:
                return frames   # zero-pad tail
            if cur is not None:
                cur.damaged = True
            if not _scan_start_code(r):
                return frames
            continue


def _parse_picture(r: BitReader):
    """Parse one picture; the PSC (incl. GN=0) has already been consumed."""
    out = _picture_header(r)
    fmt = out.fmt
    perm = transmission_order(fmt)
    gn_to_gi = {gn: gi for gi, gn in enumerate(fmt.gob_numbers)}

    while True:
        if r.remaining < 20:
            return out, False
        if r.peek(16) != 1:
            if r.remaining < 24 and r.peek(min(r.remaining, 24)) == 0:
                return out, False  # trailing byte-pad
            raise StreamError(f"expected start code at bit {r.pos}")
        mark = r.pos
        r.skip(16)
        gn = r.read(4)
        if gn == 0:          # next picture's PSC
            return out, True
        if gn not in gn_to_gi:
            raise StreamError(f"GN {gn} invalid for {fmt.name} at bit {mark}")
        _parse_gob(r, out, gn_to_gi[gn], perm)


def _parse_gob(r: BitReader, out: ParsedFrame, gi: int,
               perm: np.ndarray) -> None:
    gquant = r.read(5)
    if gquant == 0:
        raise StreamError("GQUANT 0 is forbidden")
    out.gquant[gi] = gquant
    while r.read(1):         # GEI/GSPARE loop
        r.read(8)
    quant = gquant
    addr = -1                # in-GOB MB index of last coded MB
    prev_mv = (0, 0)
    prev_was_mc = False
    while True:
        rem = r.remaining
        if rem < 0:
            # a VLC peek zero-padded past EOF matched a code longer than
            # the remaining real bits (possible for any code with trailing
            # zero bits) and skip() overran -- a truncated stream, not a
            # successful end-of-data (and without this check the
            # peek(min(rem, 24)) below would raise a negative-shift
            # ValueError instead of the module's declared StreamError)
            raise StreamError(f"truncated stream (VLC ran past EOF at "
                              f"bit {r.nbits})")
        if rem == 0:
            return
        if rem >= 16 and r.peek(16) == 1:
            return           # next start code
        if rem < 24 and r.peek(min(rem, 24)) == 0:
            return           # zero padding tail
        # NOTE: a final MB can be as short as 6 bits and end flush with the
        # byte boundary, so `rem < 16` alone is NOT end-of-data -- only a
        # start code or an all-zero tail is (a `rem < 16` bail here would
        # drop a trailing MC-no-coeff macroblock).
        sym = _decode_vlc(r, luts.MBA_LUT, "MBA")
        if sym == luts.MBA_STUFFING_SYMBOL:
            continue
        gap = sym
        new_addr = addr + gap
        if new_addr >= MBS_PER_GOB:
            raise StreamError(f"MBA overflow in GOB at bit {r.pos}")
        # skipped MBs between addr and new_addr stay uncoded
        addr = new_addr
        raster = int(perm[gi * MBS_PER_GOB + addr])

        mt = _decode_vlc(r, luts.MTYPE_LUT, "MTYPE")
        intra = bool(luts.MTYPE_INTRA[mt])
        if luts.MTYPE_MQUANT[mt]:
            quant = r.read(5)
            if quant == 0:
                raise StreamError("MQUANT 0 is forbidden")
        if luts.MTYPE_MC[mt]:
            if gap != 1 or addr % 11 == 0 or not prev_was_mc:
                pred = (0, 0)
            else:
                pred = prev_mv
            mvx = _mv_from_mvd(pred[0],
                               _decode_vlc(r, luts.MVD_LUT, "MVD") - 16)
            mvy = _mv_from_mvd(pred[1],
                               _decode_vlc(r, luts.MVD_LUT, "MVD") - 16)
            # H.261 3.2.1: MVs must not reference pixels outside the
            # picture; the device MC path assumes this (core/predict.py)
            # and would otherwise silently predict from zero padding
            mb_cols = out.fmt.width // 16
            y0 = (raster // mb_cols) * 16
            x0 = (raster % mb_cols) * 16
            if not (0 <= y0 + mvy and y0 + mvy + 16 <= out.fmt.height
                    and 0 <= x0 + mvx and x0 + mvx + 16 <= out.fmt.width):
                raise StreamError(
                    f"MV ({mvx},{mvy}) at MB {raster} references outside "
                    f"the picture (bit {r.pos})")
            out.mv[raster] = (mvx, mvy)
            prev_mv = (mvx, mvy)
            prev_was_mc = True
            out.mc[raster] = True
            out.fil[raster] = bool(luts.MTYPE_FIL[mt])
        else:
            prev_was_mc = False
        if luts.MTYPE_CBP[mt]:
            cbp = _decode_vlc(r, luts.CBP_LUT, "CBP")
            blockmask = [(cbp >> (5 - b)) & 1 for b in range(6)]
        elif luts.MTYPE_TCOEFF[mt]:
            cbp = 63
            blockmask = [1] * 6
        else:
            cbp = 0
            blockmask = [0] * 6
        out.cbp[raster] = cbp
        for b in range(6):
            if blockmask[b]:
                _decode_block(r, intra, out.levels[raster, b])
        out.coded[raster] = True
        out.intra[raster] = intra
        out.quant[raster] = quant
