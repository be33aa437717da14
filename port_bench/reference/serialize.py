"""Symbol tensors -> H.261 bytes, vectorized over streams and frames.

The same bitstream as the port's serializers (its Python walk
`serialize_sequence_py` and its C++ engine), computed without a walk:
every frame is laid out as a fixed row of symbol slots, each a (code,
length) pair, and a slot whose symbol is absent has length 0:

  picture header  PSC TR PTYPE PEI                              4 slots
  per GOB         GBSC GN GQUANT GEI                            4 slots
    per MB        MBA MTYPE MQUANT MVDx MVDy CBP                6 slots
      per block   intra DC, 64 coefficients, EOB               66 slots
  stuffing        the frame's MBA stuffing codes    most of any frame's

A stream's slots follow one another frame by frame; each slot's first bit
is the running sum of the lengths before it, and its bits are written MSB
first.  A stream is zero-padded to a byte at its end only.  All of it is
plain torch on the device of the outputs.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import torch

from . import luts
from .blocks import to_gob_order
from .constants import (
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
from .util import device_const

#: the encoder output keys the serializer reads
SYMBOL_KEYS = ("frame_coded", "tr", "gquant", "quant_mb", "coded", "mtype",
               "mv", "cbp", "levels", "n_stuff")

#: streams serialized per block of work (bounds the slot tensors' memory)
BLOCK_STREAMS = 16
#: the longest code a slot holds (the TCOEFF escape)
MAX_CODE_BITS = 20

#: the TCOEFF tables flattened for one-index lookups, [run * levels + |level|]
_TC_LEVELS = luts.TC_CODE.shape[1]
_TC_CODE = luts.TC_CODE.reshape(-1)
_TC_LEN = luts.TC_LEN.reshape(-1)
_TC_IN_TABLE = luts.TC_IN_TABLE.reshape(-1)


def _lut(table, idx: torch.Tensor) -> torch.Tensor:
    return device_const(table, idx.device).to(torch.int64)[idx.long()]


def _exclusive_cummax(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running max along the last axis, seeded with -1."""
    inc = torch.cummax(x, dim=-1).values
    return torch.cat([torch.full_like(inc[..., :1], -1), inc[..., :-1]],
                     dim=-1)


def _slot(code, length, present) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot per element: (code, length), length 0 where absent."""
    length = torch.as_tensor(length, device=present.device).expand(
        present.shape)
    code = torch.as_tensor(code, device=present.device).expand(present.shape)
    return (torch.where(present, code, 0).to(torch.int64),
            torch.where(present, length, 0).to(torch.int64))


def _block_slots(levels, intra, sent):
    """levels (..., 6, 64) int zigzag levels, intra (...,) bool, sent (...,
    6) bool -> (codes, lens) of (..., 6, 66): DC, 64 coefficients, EOB."""
    lv = levels.to(torch.int64)
    dev = lv.device
    intra_b = intra[..., None].expand(sent.shape)
    dc = lv[..., 0]
    dc_code, dc_len = _slot(torch.where(dc == 128, 255, dc), 8,
                            sent & intra_b)

    pos = torch.arange(64, device=dev)
    start = intra_b.long()[..., None]                        # 1 intra, 0 inter
    nz = (lv != 0) & (pos >= start) & sent[..., None]
    prev = torch.maximum(_exclusive_cummax(torch.where(nz, pos, -1)),
                         start - 1)
    run = pos - prev - 1
    alev = lv.abs()
    sign = (lv < 0).long()
    cell = run.clamp(0, 63) * _TC_LEVELS + alev.clamp(0, _TC_LEVELS - 1)
    in_table = (alev < _TC_LEVELS) & _lut(_TC_IN_TABLE, cell).bool()
    first01 = (~intra_b[..., None]) & (pos == 0) & (alev == 1)
    code = torch.where(
        first01, (luts.FIRST01_CODE << 1) | sign,
        torch.where(in_table,
                    (_lut(_TC_CODE, cell) << 1) | sign,
                    (luts.ESC_CODE << 14) | (run << 8) | (lv & 0xFF)))
    length = torch.where(
        first01, luts.FIRST01_LEN + 1,
        torch.where(in_table, _lut(_TC_LEN, cell), MAX_CODE_BITS))
    coef_code = torch.where(nz, code, 0)
    coef_len = torch.where(nz, length, 0)
    eob_code, eob_len = _slot(luts.EOB_CODE, luts.EOB_LEN, sent)
    return (torch.cat([dc_code[..., None], coef_code, eob_code[..., None]],
                      dim=-1),
            torch.cat([dc_len[..., None], coef_len, eob_len[..., None]],
                      dim=-1))


def _mb_slots(coded, mtype, quant, mv, cbp):
    """Transmission-ordered (..., 33) MB arrays -> (codes, lens) of (...,
    33, 6): MBA, MTYPE, MQUANT, MVDx, MVDy, CBP."""
    dev = coded.device
    idx = torch.arange(MBS_PER_GOB, device=dev)
    prev_idx = _exclusive_cummax(torch.where(coded, idx, -1))
    mba = (idx - prev_idx).clamp(0, MBS_PER_GOB)
    is_mc = _lut(luts.MTYPE_MC, mtype).bool() & coded
    has_mq = _lut(luts.MTYPE_MQUANT, mtype).bool() & coded
    has_cbp = _lut(luts.MTYPE_CBP, mtype).bool() & coded

    # the MVD predictor is the previous MB's vector where that MB is the
    # adjacent, MC-coded one and this MB does not start an MB row
    safe_prev = prev_idx.clamp(0, MBS_PER_GOB - 1)
    prev_mv = torch.gather(mv, -2, safe_prev[..., None].expand(mv.shape))
    prev_mc = torch.gather(is_mc, -1, safe_prev)
    use_pred = (mba == 1) & prev_mc & (idx % 11 != 0) & (prev_idx >= 0)
    mvd = torch.remainder(mv - torch.where(use_pred[..., None], prev_mv, 0)
                          + 16, 32)                    # (MV - pred) + 16

    slots = [
        (_lut(luts.MBA_CODE, mba), _lut(luts.MBA_LEN, mba), coded),
        (_lut(luts.MTYPE_CODE, mtype), _lut(luts.MTYPE_LEN, mtype), coded),
        (quant, 5, has_mq),
        (_lut(luts.MVD_CODE, mvd[..., 0]), _lut(luts.MVD_LEN, mvd[..., 0]),
         is_mc),
        (_lut(luts.MVD_CODE, mvd[..., 1]), _lut(luts.MVD_LEN, mvd[..., 1]),
         is_mc),
        (_lut(luts.CBP_CODE, cbp.clamp(0, 63)),
         _lut(luts.CBP_LEN, cbp.clamp(0, 63)), has_cbp),
    ]
    pairs = [_slot(c, n, p) for c, n, p in slots]
    return (torch.stack([c for c, _ in pairs], dim=-1),
            torch.stack([n for _, n in pairs], dim=-1))


def frame_slots(fmt: Format, out: Mapping[str, torch.Tensor]):
    """Outputs of N frames (a leading frame axis on every key) ->
    (codes, lens), each (N, L): every frame's slots in transmission order.
    Frames not coded (frame_coded False) have only empty slots."""
    n = out["coded"].shape[0]
    dev = out["coded"].device
    g = fmt.num_gobs

    def gob(x):
        return to_gob_order(fmt, x)

    coded, mtype = gob(out["coded"].bool()), gob(out["mtype"].long())
    levels = gob(out["levels"])
    mb_code, mb_len = _mb_slots(coded, mtype, gob(out["quant_mb"].long()),
                                gob(out["mv"].long()),
                                gob(out["cbp"].long()))
    intra = _lut(luts.MTYPE_INTRA, mtype).bool() & coded
    has_cbp = _lut(luts.MTYPE_CBP, mtype).bool()
    has_tc = _lut(luts.MTYPE_TCOEFF, mtype).bool()
    bit = 5 - torch.arange(6, device=dev)
    cbp_mask = ((gob(out["cbp"].long())[..., None] >> bit) & 1).bool()
    sent = torch.where(has_cbp[..., None], cbp_mask,
                       has_tc[..., None].expand(cbp_mask.shape))
    sent = sent & coded[..., None]
    blk_code, blk_len = _block_slots(levels, intra, sent)

    ones = torch.ones((n, g), dtype=torch.bool, device=dev)
    gn = torch.as_tensor(fmt.gob_numbers, device=dev).expand(n, g)
    hdr = [_slot(GBSC_VALUE, GBSC_BITS, ones), _slot(gn, GN_BITS, ones),
           _slot(out["gquant"].long(), GQUANT_BITS, ones),
           _slot(0, PEI_BITS, ones)]
    gob_code = torch.cat([torch.stack([c for c, _ in hdr], dim=-1),
                          torch.cat([mb_code, blk_code.flatten(-2)], dim=-1)
                          .flatten(-2)], dim=-1)
    gob_len = torch.cat([torch.stack([ln for _, ln in hdr], dim=-1),
                         torch.cat([mb_len, blk_len.flatten(-2)], dim=-1)
                         .flatten(-2)], dim=-1)

    one = torch.ones((n,), dtype=torch.bool, device=dev)
    pic = [_slot(PSC_VALUE, PSC_BITS, one),
           _slot(out["tr"].long() & 31, TR_BITS, one),
           _slot(ptype_value(fmt.is_cif), PTYPE_BITS, one),
           _slot(0, PEI_BITS, one)]
    n_stuff = out["n_stuff"].long()
    stuff = (torch.arange(int(n_stuff.max()) if n > 0 else 0, device=dev)
             < n_stuff[:, None])
    stuff_code, stuff_len = _slot(luts.MBA_STUFFING_CODE,
                                  luts.MBA_STUFFING_LEN, stuff)
    codes = torch.cat([torch.stack([c for c, _ in pic], dim=-1),
                       gob_code.flatten(1), stuff_code], dim=-1)
    lens = torch.cat([torch.stack([ln for _, ln in pic], dim=-1),
                      gob_len.flatten(1), stuff_len], dim=-1)
    lens = torch.where(out["frame_coded"].bool()[:, None], lens, 0)
    return codes, lens


def pack(codes: torch.Tensor, lens: torch.Tensor) -> List[Tuple[bytes, int]]:
    """(B, L) slots of B streams -> per stream (bytes, nbits): the codes
    MSB first, one after another, the last byte zero-padded."""
    dev = codes.device
    nbits = lens.sum(dim=1)
    nbytes = (nbits + 7) // 8
    stream_base = 8 * (torch.cumsum(nbytes, 0) - nbytes)     # first bit
    start = torch.cumsum(lens, dim=1) - lens + stream_base[:, None]
    keep = lens > 0
    codes, lens, start = codes[keep], lens[keep], start[keep]
    bits = torch.zeros(int(8 * nbytes.sum()), dtype=torch.uint8, device=dev)
    for b in range(MAX_CODE_BITS):
        m = lens > b
        bits[start[m] + b] = ((codes[m] >> (lens[m] - 1 - b)) & 1).to(
            torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=dev)
    data = (bits.view(-1, 8).to(torch.int32) * weights).sum(dim=1).to(
        torch.uint8).cpu().numpy()
    ends = torch.cumsum(nbytes, 0).tolist()
    return [(data[e - k:e].tobytes(), int(nb)) for e, k, nb in
            zip(ends, nbytes.tolist(), nbits.tolist())]


def serialize_streams(fmt: Format, outputs: Mapping[str, torch.Tensor]
                      ) -> List[Tuple[bytes, int]]:
    """Stacked (S, T, ...) encoder outputs (`encoder.encode_sequence`) ->
    per stream (bytes, nbits), BLOCK_STREAMS streams at a time."""
    s, t = outputs["coded"].shape[:2]
    result = []
    for b0 in range(0, s, BLOCK_STREAMS):
        blk = {k: outputs[k][b0:b0 + BLOCK_STREAMS].flatten(0, 1)
               for k in SYMBOL_KEYS}
        codes, lens = frame_slots(fmt, blk)
        nb = codes.shape[0] // t
        result += pack(codes.view(nb, -1), lens.view(nb, -1))
    return result
