"""Wrappers of the four hand-written SAD-map kernels (`csrc/sad_search.cu`).

Each replaces one TPU kernel of `p64tpu/kernels/me_pallas.py` and returns
the dense (S, (2s+1)^2, nMB) int32 map of `me.sad_map`:

  sad_map_f32_cuda   <- _sad_kernel       (float32 abs-diff, CUDA cores)
  sad_map_rp_cuda    <- _sad_kernel_rp    (16-row column sums first)
  sad_map_i8_cuda    <- _sad_kernel_i8    (biased int8 bytes, dp4a pool)
  sad_map_swar_cuda  <- _sad_kernel_swar  (SWAR: 2 pixels per 32-bit word)

K1 (f32), K4 (i8) and K5 (swar) serve tiles of MBs in the search kernel's
geometry (`map_tiles`, `i8_tiles`, through `me_cuda.tile_geometry`) and
keep their TPU kernel's arithmetic: K1 two FP32 adds per abs-diff, bounded
by the FP32 lanes; K4 the abs-diff biased to int8 and a signed dp4a pool,
2 integer-lane instructions per 4 pixels with the pool on another pipe; K5
|u - v| on 16-bit fields, 2.5 instructions per 2 pixels with Hopper's
16x2 add-max.  K3 (rp) takes one block per dy group and MB row
(`rp_geometry`).  They live in the SAD-search kernel's library, and share
its loader, argument check and launch helper (`me_cuda`); the source says
what bounds each and how it is laid out.  tests/test_torch_me_tiles.py
walks every geometry as the kernels do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..spec.constants import DEFAULT_SEARCH_RANGE, MB_SIZE
from . import me_cuda

#: kernel name -> launches since the count was last reset (a run that
#: claims to have gone through a kernel shows it here)
LAUNCHES: Dict[str, int] = dict.fromkeys(me_cuda.MAP_KERNELS, 0)

#: dy one rp block loops over (its reference rows are staged once)
RP_DY_PER_BLOCK = 8


def rp_geometry(width: int) -> Tuple[int, int]:
    """(dy per block, threads per block) of the rp kernel: one block per
    (dy group, MB row, stream), one thread per 4-pixel column word, in
    whole warps."""
    return RP_DY_PER_BLOCK, -(-(width // 4) // 32) * 32


def map_tile_smem_bytes(tiles: me_cuda.SearchTiles, search: int) -> int:
    """Shared memory of one K1 or K5 block (csrc/sad_search.cu
    map_tile_smem_bytes): the window as one 4-byte element per byte column,
    which the tile's map aliases; 16 elements per current row and MB; and
    the bytes cp.async staged, window and current rows."""
    rows = me_cuda.TILE_DY * tiles.n_dyt + MB_SIZE - 1
    win = 4 * rows * (16 * tiles.mb_tile + 32)
    side = 2 * search + 1
    tile_map = 16 * -(-side * side * tiles.mb_tile // 4)
    cur = 4 * MB_SIZE * MB_SIZE * tiles.mb_tile
    return max(win, tile_map) + cur + win // 4 + cur // 4


def map_tiles(height: int, width: int, search: int) -> me_cuda.SearchTiles:
    """Launch geometry of K1 and K5: the search's tiles, with as many MBs
    per block as their shared memory allows."""
    return me_cuda.tile_geometry(
        height, width, search, lambda t: map_tile_smem_bytes(t, search))


def i8_tiles(height: int, width: int, search: int) -> me_cuda.SearchTiles:
    """Launch geometry of K4: the search's tiles, with as many MBs per block
    as its shared memory (the search's map mode without its keys)
    allows."""
    return me_cuda.tile_geometry(
        height, width, search, lambda t: t.aligned_smem_bytes(search, True))


def _geometry(name: str, height: int, width: int, search: int):
    """The int geometry arguments of map kernel `name`'s entry point, after
    (cur, ref, S, H, W, search); their count is its C signature's."""
    if name == "sad_map_rp":
        return rp_geometry(width)
    if name == "sad_map_i8":
        return i8_tiles(height, width, search).args()
    return map_tiles(height, width, search).args()


def _map(name: str, cur_y: torch.Tensor, ref_y: torch.Tensor,
         search: int) -> torch.Tensor:
    s, h, w = me_cuda.check_planes(name, cur_y, ref_y, search)
    n_mb = (h // MB_SIZE) * (w // MB_SIZE)
    side = 2 * search + 1
    out = torch.empty((s, side * side, n_mb), dtype=torch.int32,
                      device=cur_y.device)
    extra = _geometry(name, h, w, search)
    me_cuda.declare_map(name, len(extra))
    me_cuda.launch(name, cur_y.device, cur_y.data_ptr(), ref_y.data_ptr(),
                   s, h, w, search, *extra, out.data_ptr())
    LAUNCHES[name] += 1
    return out


def sad_map_f32_cuda(cur_y: torch.Tensor, ref_y: torch.Tensor,
                     search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 1's map on the card: (S, H, W) uint8 CUDA planes ->
    (S, (2s+1)^2, nMB) int32."""
    return _map("sad_map_f32", cur_y, ref_y, search)


def sad_map_rp_cuda(cur_y: torch.Tensor, ref_y: torch.Tensor,
                    search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 3's map on the card.  It stages whole rows in shared memory
    and takes pictures up to CIF's width; the kernel refuses a wider one
    with a CUDA error."""
    return _map("sad_map_rp", cur_y, ref_y, search)


def sad_map_i8_cuda(cur_y: torch.Tensor, ref_y: torch.Tensor,
                    search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 4's map on the card."""
    return _map("sad_map_i8", cur_y, ref_y, search)


def sad_map_swar_cuda(cur_y: torch.Tensor, ref_y: torch.Tensor,
                      search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 5's map on the card."""
    return _map("sad_map_swar", cur_y, ref_y, search)
