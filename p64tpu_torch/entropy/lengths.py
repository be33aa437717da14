"""Device-side exact bit accounting.

Port of `p64tpu/entropy/lengths.py`.  Every H.261 symbol's VLC length is a
table lookup, so the exact size of the bitstream is computed on the device,
vectorized over streams and MBs; the host serializer must emit exactly
these counts (asserted on every encode).

The reference's one-hot selects and MXU table product were TPU workarounds
for slow gathers; here they are direct indexing into the `p64tpu.spec.luts`
tables.  That is exact because TC_LEN[:, 0] == 0 and every entry outside
the 27 x 16 VLC block is the 20-bit escape (asserted in the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from p64tpu.spec import luts
from p64tpu.spec.constants import (
    GBSC_BITS,
    GN_BITS,
    GQUANT_BITS,
    MBS_PER_GOB,
    PEI_BITS,
    PSC_BITS,
    PTYPE_BITS,
    TR_BITS,
)

from ..utils import device_const

PICTURE_HEADER_BITS = PSC_BITS + TR_BITS + PTYPE_BITS + PEI_BITS
GOB_HEADER_BITS = GBSC_BITS + GN_BITS + GQUANT_BITS + PEI_BITS
MQUANT_BITS = 5

#: TC_LEN (run 0..63, |level| 0..127) flattened for one-index lookups
_TC_LEVELS = luts.TC_LEN.shape[1]
_TC_LEN = luts.TC_LEN.astype(np.int32).reshape(-1)
_MBA_LEN = luts.MBA_LEN.astype(np.int32)
_MTYPE_LEN = luts.MTYPE_LEN.astype(np.int32)
_MVD_LEN = luts.MVD_LEN.astype(np.int32)
_CBP_LEN = luts.CBP_LEN.astype(np.int32)
_MTYPE_MC = luts.MTYPE_MC.astype(np.bool_)
_MTYPE_CBP = luts.MTYPE_CBP.astype(np.bool_)
_MTYPE_TCOEFF = luts.MTYPE_TCOEFF.astype(np.bool_)
_MTYPE_INTRA = luts.MTYPE_INTRA.astype(np.bool_)
_MTYPE_MQUANT = luts.MTYPE_MQUANT.astype(np.bool_)


def _lut(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    return device_const(table, idx.device)[idx.to(torch.int64)]


def _exclusive_cummax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive running max along dim, seeded with -1 (enough for index
    chains)."""
    inc = torch.cummax(x, dim=dim).values
    pad = torch.full_like(inc.narrow(dim, 0, 1), -1)
    return torch.cat([pad, inc.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def block_bits(levels_zz: torch.Tensor, intra: torch.Tensor) -> torch.Tensor:
    """Exact TCOEFF bits for each block, EXCLUDING EOB and the intra DC FLC.

    Args:
      levels_zz: (..., 64) int levels in zigzag order.
      intra: (...,) bool (ACs start at position 1, no first-coef short form).

    Returns (...,) int32, with the inter first-coefficient (0, +/-1) short
    form accounted.
    """
    lv = levels_zz.to(torch.int32)
    p = torch.arange(64, dtype=torch.int32, device=lv.device)
    start = intra.to(torch.int32).unsqueeze(-1)
    nz = (lv != 0) & (p >= start)
    marks = torch.where(nz, p, -1)
    prev = torch.maximum(_exclusive_cummax(marks), start - 1)
    run = p - prev - 1
    alev = lv.abs()
    clen = _lut(_TC_LEN, run * _TC_LEVELS + alev.clamp(0, _TC_LEVELS - 1))
    total = torch.where(nz, clen, 0).sum(dim=-1, dtype=torch.int32)
    first01 = (~intra) & (alev[..., 0] == 1)
    saving = torch.where(first01, int(luts.FIRST01_SAVING), 0)
    return (total - saving).to(torch.int32)


def wrap_mvd(d: torch.Tensor) -> torch.Tensor:
    """Fold MV - pred into -16..15 by +/-32 (floor-mod, as the reference)."""
    return torch.remainder(d + 16, 32) - 16


def gob_payload_bits_per_mb(codedt: torch.Tensor, mtypet: torch.Tensor,
                            mvt: torch.Tensor, cbpt: torch.Tensor,
                            levelst: torch.Tensor) -> torch.Tensor:
    """Exact per-MB bit cost of GOBs given transmission-ordered arrays.

    Shapes: codedt/mtypet/cbpt (..., 33); mvt (..., 33, 2);
    levelst (..., 33, 6, 64).  Returns (..., 33) int32 per-MB payload bits
    (MBA + MTYPE [+MQUANT] [+MVD] [+CBP] + blocks; GOB header excluded).
    The MBA and MVD chains reset at GOB boundaries, so GOBs are independent.
    """
    dev = codedt.device
    idx = torch.arange(MBS_PER_GOB, dtype=torch.int32, device=dev)
    marks = torch.where(codedt, idx, -1)
    prev_idx = _exclusive_cummax(marks)                    # (..., 33)
    mba = idx - prev_idx                                   # >= 1 where coded
    mba_bits = _lut(_MBA_LEN, mba.clamp(0, MBS_PER_GOB))

    mtype_bits = _lut(_MTYPE_LEN, mtypet)
    is_mc = _lut(_MTYPE_MC, mtypet) & codedt
    has_cbp = _lut(_MTYPE_CBP, mtypet) & codedt
    has_tc = _lut(_MTYPE_TCOEFF, mtypet) & codedt
    is_intra = _lut(_MTYPE_INTRA, mtypet) & codedt
    has_mq = _lut(_MTYPE_MQUANT, mtypet) & codedt

    # MVD predictor: previous MB's MV iff adjacent (gap 1), previous coded
    # MB was MC, and not at the start of an MB row (idx % 11 == 0).
    safe_prev = prev_idx.clamp(0, MBS_PER_GOB - 1).to(torch.int64)
    prev_mv = torch.gather(
        mvt, -2, safe_prev.unsqueeze(-1).expand(mvt.shape))  # (..., 33, 2)
    prev_mc = torch.gather(is_mc, -1, safe_prev)
    use_pred = (mba == 1) & prev_mc & (idx % 11 != 0) & (prev_idx >= 0)
    pred = torch.where(use_pred.unsqueeze(-1), prev_mv, 0)
    mvd = wrap_mvd(mvt - pred)
    mvd_bits = _lut(_MVD_LEN, mvd + 16).sum(dim=-1, dtype=torch.int32)

    cbp_bits = _lut(_CBP_LEN, cbpt.clamp(0, 63))

    # per-block coefficient bits + EOB + intra DC FLC
    intra_b = is_intra.unsqueeze(-1)
    bb = block_bits(levelst, intra_b)                      # (..., 33, 6)
    blk_sent = (intra_b | (levelst != 0).any(dim=-1)) & has_tc.unsqueeze(-1)
    blk_bits = torch.where(
        blk_sent, bb + luts.EOB_LEN + torch.where(intra_b, 8, 0), 0
    ).sum(dim=-1, dtype=torch.int32)

    mb_bits = (mba_bits + mtype_bits
               + torch.where(has_mq, MQUANT_BITS, 0)
               + torch.where(is_mc, mvd_bits, 0)
               + torch.where(has_cbp, cbp_bits, 0)
               + blk_bits)
    return torch.where(codedt, mb_bits, 0).to(torch.int32)


def gob_payload_bits(codedt: torch.Tensor, mtypet: torch.Tensor,
                     mvt: torch.Tensor, cbpt: torch.Tensor,
                     levelst: torch.Tensor) -> torch.Tensor:
    """Exact MB-layer bits of GOBs (sum of gob_payload_bits_per_mb)."""
    return gob_payload_bits_per_mb(codedt, mtypet, mvt, cbpt, levelst).sum(
        dim=-1, dtype=torch.int32)
