"""Shared reconstruction: levels -> dequant -> IDCT -> + prediction -> clip.

Frozen copy of the port's.  The encoder's local decode is what a decoder
must output, so the reference's reconstruction is the decode cells'
answer.  Per MB:

  base  = 0                      for intra-coded MBs
        = MC (optionally filtered) prediction for coded inter MBs
        = zero-MV unfiltered copy of the reference for uncoded MBs
  recon = clip(base + IDCT(dequant(levels)), 0, 255)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .constants import BLOCK_SIZE, Format
from .dct import idct8x8
from .quant import dequantize
from .blocks import mbs_to_luma, tiles_to_plane, yblocks_to_mb
from .predict import mc_predict


def reconstruct_frame(fmt: Format,
                      levels: torch.Tensor,
                      quant_mb: torch.Tensor,
                      intra_mb: torch.Tensor,
                      mv: torch.Tensor,
                      fil: torch.Tensor,
                      ref_y: torch.Tensor,
                      ref_cb: torch.Tensor,
                      ref_cr: torch.Tensor,
                      pred: Optional[Tuple[torch.Tensor, ...]] = None):
    """Reconstruct full planes.

    Args:
      levels:   (S, nMB, 6, 64) int zigzag levels (zeros where not sent).
      quant_mb: (S, nMB) effective QUANT per MB.
      intra_mb: (S, nMB) bool.
      mv:       (S, nMB, 2) (mvx, mvy); zeros for non-MC and uncoded MBs.
      fil:      (S, nMB) bool loop-filter flag (False for uncoded MBs).
      ref_*:    previous reconstructed planes (S, H, W) / (S, H/2, W/2).
      pred:     optional (pred_y, pred_cb, pred_cr) equal to
                mc_predict(ref_*, mv, fil) -- the encoder passes the one it
                already built; the decoder leaves it None.

    Returns:
      (y, cb, cr) uint8 planes.
    """
    if pred is None:
        pred = mc_predict(ref_y, ref_cb, ref_cr, mv, fil, fmt)
    pred_y, pred_cb, pred_cr = pred

    coefs = dequantize(levels, quant_mb[..., None, None].to(torch.int32),
                       intra_mb[..., None, None])
    res = idct8x8(coefs)                                  # (S, nMB, 6, 8, 8)

    intra3 = intra_mb[..., None, None]
    y_mb = (torch.where(intra3, 0, pred_y)
            + yblocks_to_mb(res[:, :, :4])).clamp(0, 255)
    cb_b = (torch.where(intra3, 0, pred_cb) + res[:, :, 4]).clamp(0, 255)
    cr_b = (torch.where(intra3, 0, pred_cr) + res[:, :, 5]).clamp(0, 255)

    y = mbs_to_luma(y_mb, fmt.height, fmt.width).to(torch.uint8)
    cb = tiles_to_plane(cb_b, fmt.chroma_height, fmt.chroma_width,
                        BLOCK_SIZE).to(torch.uint8)
    cr = tiles_to_plane(cr_b, fmt.chroma_height, fmt.chroma_width,
                        BLOCK_SIZE).to(torch.uint8)
    return y, cb, cr
