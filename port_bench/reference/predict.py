"""Motion-compensated prediction, batched over streams and macroblocks.

Frozen copy of the port's gather form.

Conventions:
  * mv = (mvx, mvy); positive x is right, positive y is down.
  * chroma vectors are the luma vector halved with truncation toward zero.
  * MVs never point outside the picture (the ME window clip guarantees it);
    an out-of-range index is an error here, not a silent clamp.
"""

from __future__ import annotations

from typing import Optional

import torch

from .constants import BLOCK_SIZE, MB_SIZE, Format
from .filter import loop_filter8x8
from .blocks import mb_to_yblocks, yblocks_to_mb


def _gather_tiles(plane: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                  tile: int) -> torch.Tensor:
    """plane (S, H, W), per-tile top-left (S, n) -> (S, n, tile, tile)."""
    s, _, w = plane.shape
    ar = torch.arange(tile, dtype=torch.int64, device=plane.device)
    rows = y0.to(torch.int64).unsqueeze(-1) + ar               # (S, n, t)
    cols = x0.to(torch.int64).unsqueeze(-1) + ar
    flat = rows.unsqueeze(-1) * w + cols.unsqueeze(-2)         # (S, n, t, t)
    out = torch.gather(plane.reshape(s, -1), 1, flat.reshape(s, -1))
    return out.reshape(flat.shape)


def _halve_mv(v: torch.Tensor) -> torch.Tensor:
    """Truncate-toward-zero halving for chroma vectors."""
    return torch.sign(v) * torch.div(v.abs(), 2, rounding_mode="floor")


def _apply_filter(pred_y, pred_cb, pred_cr, fil):
    """Loop filter where fil (S, nMB): luma as four 8x8 quadrant blocks,
    chroma per block."""
    f = fil[..., None, None]
    yb = mb_to_yblocks(pred_y)
    yb = torch.where(f.unsqueeze(-1), loop_filter8x8(yb), yb)
    pred_y = yblocks_to_mb(yb)
    pred_cb = torch.where(f, loop_filter8x8(pred_cb), pred_cb)
    pred_cr = torch.where(f, loop_filter8x8(pred_cr), pred_cr)
    return pred_y, pred_cb, pred_cr


def mc_predict(ref_y: torch.Tensor, ref_cb: torch.Tensor,
               ref_cr: torch.Tensor, mv: torch.Tensor,
               fil: Optional[torch.Tensor], fmt: Format):
    """Build per-MB predictions from the reference frame.

    Args:
      ref_y / ref_cb / ref_cr: (S, H, W), (S, H/2, W/2) reference planes.
      mv:  (S, nMB, 2) int (mvx, mvy), raster MB order; zeros for non-MC.
      fil: (S, nMB) bool -- loop-filter this MB's prediction; None skips
           the filter stage (the encoder's decision pass wants raw MC
           predictions and filters later).

    Returns:
      (pred_y (S,nMB,16,16), pred_cb (S,nMB,8,8), pred_cr (S,nMB,8,8)) int32.
    """
    mbc = fmt.mb_cols
    idx = torch.arange(fmt.num_mbs, dtype=torch.int32, device=mv.device)
    row, col = idx // mbc, idx % mbc
    pred_y = _gather_tiles(ref_y.to(torch.int32), row * MB_SIZE + mv[..., 1],
                           col * MB_SIZE + mv[..., 0], MB_SIZE)
    cmv = _halve_mv(mv)
    cy0 = row * BLOCK_SIZE + cmv[..., 1]
    cx0 = col * BLOCK_SIZE + cmv[..., 0]
    pred_cb = _gather_tiles(ref_cb.to(torch.int32), cy0, cx0, BLOCK_SIZE)
    pred_cr = _gather_tiles(ref_cr.to(torch.int32), cy0, cx0, BLOCK_SIZE)
    if fil is None:
        return pred_y, pred_cb, pred_cr
    return _apply_filter(pred_y, pred_cb, pred_cr, fil)
