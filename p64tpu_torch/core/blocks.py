"""Frame <-> macroblock/block tensor layout and H.261 transmission order.

Port of `p64tpu/core/blocks.py`.  Every layout helper works over arbitrary
leading axes, so the stream axis S rides along:

  luma   (S, H, W)        -> (S, nMB, 16, 16)   raster MB order
  luma   (S, nMB, 16, 16) -> (S, nMB, 4, 8, 8)  Y1 Y2 Y3 Y4
  chroma (S, H/2, W/2)    -> (S, nMB, 8, 8)

`transmission_order` and `gob_of_mb` are numpy copies of the originals,
which cannot be imported without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from p64tpu.spec.constants import (
    BLOCK_SIZE,
    GOB_MB_COLS,
    GOB_MB_ROWS,
    MB_SIZE,
    Format,
)


def transmission_order(fmt: Format) -> np.ndarray:
    """perm[k] = raster MB index of the k-th transmitted MB (GOB-major:
    GOBs in GN order, MBA 1..33 raster within each GOB)."""
    perm = []
    for gi in range(fmt.num_gobs):
        grow, gcol = divmod(gi, fmt.gob_cols)
        for idx in range(GOB_MB_ROWS * GOB_MB_COLS):
            r, c = divmod(idx, GOB_MB_COLS)
            mb_row = grow * GOB_MB_ROWS + r
            mb_col = gcol * GOB_MB_COLS + c
            perm.append(mb_row * fmt.mb_cols + mb_col)
    return np.asarray(perm, dtype=np.int32)


def gob_of_mb(fmt: Format) -> np.ndarray:
    """For each raster MB index, its GOB index (0-based, transmission
    order)."""
    out = np.empty(fmt.num_mbs, dtype=np.int32)
    for k, raster in enumerate(transmission_order(fmt)):
        out[raster] = k // (GOB_MB_ROWS * GOB_MB_COLS)
    return out


def to_gob_order(fmt: Format, x: torch.Tensor) -> torch.Tensor:
    """(S, nMB, ...) raster MB order -> (S, nGOB, 33, ...), as a reshape and
    permute (equals x[:, transmission_order(fmt)] reshaped)."""
    gr, gc = fmt.gob_rows, fmt.gob_cols
    s, tail = x.shape[0], x.shape[2:]
    x = x.reshape(s, gr, GOB_MB_ROWS, gc, GOB_MB_COLS, *tail)
    x = x.transpose(2, 3)
    return x.reshape(s, fmt.num_gobs, GOB_MB_ROWS * GOB_MB_COLS, *tail)


def from_gob_order(fmt: Format, xt: torch.Tensor) -> torch.Tensor:
    """Inverse of to_gob_order: (S, nGOB, 33, ...) -> (S, nMB, ...)."""
    gr, gc = fmt.gob_rows, fmt.gob_cols
    s, tail = xt.shape[0], xt.shape[3:]
    x = xt.reshape(s, gr, gc, GOB_MB_ROWS, GOB_MB_COLS, *tail)
    x = x.transpose(2, 3)
    return x.reshape(s, fmt.num_mbs, *tail)


def plane_to_tiles(plane: torch.Tensor, tile: int) -> torch.Tensor:
    """(..., H, W) -> (..., H//t * W//t, t, t) in raster tile order."""
    h, w = plane.shape[-2:]
    lead = plane.shape[:-2]
    x = plane.reshape(*lead, h // tile, tile, w // tile, tile)
    x = x.transpose(-3, -2)
    return x.reshape(*lead, (h // tile) * (w // tile), tile, tile)


def tiles_to_plane(tiles: torch.Tensor, h: int, w: int,
                   tile: int) -> torch.Tensor:
    """Inverse of plane_to_tiles."""
    lead = tiles.shape[:-3]
    x = tiles.reshape(*lead, h // tile, w // tile, tile, tile)
    x = x.transpose(-3, -2)
    return x.reshape(*lead, h, w)


def luma_to_mbs(y: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., nMB, 16, 16), raster MB order."""
    return plane_to_tiles(y, MB_SIZE)


def mbs_to_luma(mbs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return tiles_to_plane(mbs, h, w, MB_SIZE)


def mb_to_yblocks(mbs: torch.Tensor) -> torch.Tensor:
    """(..., 16, 16) -> (..., 4, 8, 8) in H.261 order Y1 Y2 Y3 Y4
    (top-left, top-right, bottom-left, bottom-right)."""
    lead = mbs.shape[:-2]
    x = mbs.reshape(*lead, 2, BLOCK_SIZE, 2, BLOCK_SIZE)
    x = x.transpose(-3, -2)
    return x.reshape(*lead, 4, BLOCK_SIZE, BLOCK_SIZE)


def yblocks_to_mb(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of mb_to_yblocks: (..., 4, 8, 8) -> (..., 16, 16)."""
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, 2, 2, BLOCK_SIZE, BLOCK_SIZE)
    x = x.transpose(-3, -2)
    return x.reshape(*lead, MB_SIZE, MB_SIZE)


def chroma_to_blocks(c: torch.Tensor) -> torch.Tensor:
    """(..., H/2, W/2) -> (..., nMB, 8, 8): one chroma block per MB."""
    return plane_to_tiles(c, BLOCK_SIZE)


def assemble_blocks(y_mbs: torch.Tensor, cb_blocks: torch.Tensor,
                    cr_blocks: torch.Tensor) -> torch.Tensor:
    """(..., 16, 16) luma MBs + (..., 8, 8) chroma blocks
    -> (..., 6, 8, 8) in transmission block order Y1..Y4, Cb, Cr."""
    return torch.cat([mb_to_yblocks(y_mbs), cb_blocks.unsqueeze(-3),
                      cr_blocks.unsqueeze(-3)], dim=-3)


def assemble_mb_blocks(y_mbs: torch.Tensor, cb: torch.Tensor,
                       cr: torch.Tensor) -> torch.Tensor:
    """Like assemble_blocks but taking chroma PLANES (..., H/2, W/2)."""
    return assemble_blocks(y_mbs, chroma_to_blocks(cb), chroma_to_blocks(cr))
