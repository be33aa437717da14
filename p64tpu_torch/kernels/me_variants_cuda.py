"""Wrappers of the four hand-written SAD-map kernels (`csrc/sad_search.cu`).

Each replaces one TPU kernel of `p64tpu/kernels/me_pallas.py` and returns
the dense (S, (2s+1)^2, nMB) int32 map of `me.sad_map`:

  sad_map_f32_cuda   <- _sad_kernel       (float32 abs-diff, CUDA cores)
  sad_map_rp_cuda    <- _sad_kernel_rp    (16-row column sums first)
  sad_map_i8_cuda    <- _sad_kernel_i8    (biased int8 bytes, dp4a pool)
  sad_map_swar_cuda  <- _sad_kernel_swar  (SWAR in 32-bit integer ops)

They live in the SAD-search kernel's library, and share its loader,
argument check and launch helper (`me_cuda`).  See the source for what
bounds them and how they are laid out.  `rp_geometry` computes the rp
kernel's launch geometry; tests/test_torch_me_tiles.py walks it as the
kernel does.
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


def _map(name: str, cur_y: torch.Tensor, ref_y: torch.Tensor,
         search: int) -> torch.Tensor:
    rp = name == "sad_map_rp"
    s, h, w = me_cuda.check_planes(name, cur_y, ref_y, search,
                                   align=16 if rp else 4)
    n_mb = (h // MB_SIZE) * (w // MB_SIZE)
    side = 2 * search + 1
    out = torch.empty((s, side * side, n_mb), dtype=torch.int32,
                      device=cur_y.device)
    extra = rp_geometry(w) if rp else ()
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
