"""Full-search integer-pel motion estimation, batched over streams and MBs.

Port of `p64tpu/kernels/me.py`.  The choice contract is the reference's:

  * scan order: dy from -search..+search (outer), dx from -search..+search
    (inner); the FIRST minimum in that order wins ties.
  * offsets whose 16x16 window leaves the picture are excluded (SAD 1<<30).
  * no zero-MV bias here; the mode decisions apply it.

`full_search` dispatches on the tensor's device alone: a CUDA tensor goes
through the hand-written kernel (`me_cuda.sad_search_cuda`, which raises if
it cannot launch), a CPU tensor through the plain torch `sad_map` below.
The plain version is also what the kernel is held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from p64tpu.spec.constants import DEFAULT_SEARCH_RANGE, MB_SIZE

from .me_cuda import sad_search_cuda

#: SAD given to offsets whose window leaves the picture
INVALID_SAD = 1 << 30


def offset_table(search: int = DEFAULT_SEARCH_RANGE) -> np.ndarray:
    """(num_offsets, 2) array of (dy, dx) in the documented scan order."""
    r = np.arange(-search, search + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    return np.stack([dy.ravel(), dx.ravel()], axis=-1).astype(np.int32)


def zero_offset_index(search: int = DEFAULT_SEARCH_RANGE) -> int:
    side = 2 * search + 1
    return search * side + search


def _validity_mask(h: int, w: int, search: int,
                   device: torch.device) -> torch.Tensor:
    """(num_offsets, nMB) bool: the offset's window lies inside the picture."""
    mb_cols = w // MB_SIZE
    n_mb = (h // MB_SIZE) * mb_cols
    idx = torch.arange(n_mb, dtype=torch.int32, device=device)
    y0 = (idx // mb_cols) * MB_SIZE
    x0 = (idx % mb_cols) * MB_SIZE
    offs = torch.as_tensor(offset_table(search), device=device)
    oy, ox = offs[:, 0:1], offs[:, 1:2]
    return ((y0 + oy >= 0) & (y0 + oy + MB_SIZE <= h)
            & (x0 + ox >= 0) & (x0 + ox + MB_SIZE <= w))


def sad_map(cur_y: torch.Tensor, ref_y: torch.Tensor,
            search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Dense SAD tensor, plain torch.

    Args:
      cur_y, ref_y: (S, H, W) luma planes (any integer dtype).

    Returns:
      (S, num_offsets, nMB) int32; invalid (out-of-picture) offsets 1<<30.
    """
    s, h, w = cur_y.shape
    mb_rows, mb_cols = h // MB_SIZE, w // MB_SIZE
    side = 2 * search + 1
    cur = cur_y.to(torch.int16).unsqueeze(2)                  # (S, H, 1, W)
    ref_pad = torch.nn.functional.pad(ref_y.to(torch.int16),
                                      (search, search, search, search))
    rows = []
    for dy in range(side):
        # (S, H, side, W): every dx shift of this dy's reference rows
        win = ref_pad[:, dy:dy + h, :].unfold(2, w, 1)
        ad = (cur - win).abs()
        box = ad.reshape(s, mb_rows, MB_SIZE, side, mb_cols, MB_SIZE).sum(
            dim=(2, 5), dtype=torch.int32)                 # (S, R, side, C)
        rows.append(box.permute(0, 2, 1, 3).reshape(s, side, -1))
    sads = torch.stack(rows, dim=1).reshape(s, side * side, -1)
    valid = _validity_mask(h, w, search, cur_y.device)
    return torch.where(valid, sads, torch.full_like(sads, INVALID_SAD))


def search_from_map(sads: torch.Tensor, search: int):
    """(S, num_offsets, nMB) SAD map -> (mv, best_sad, sad0) with the
    first-minimum tie-break (`torch.argmin` returns the first minimum)."""
    offs = torch.as_tensor(offset_table(search), device=sads.device)
    best_idx = torch.argmin(sads, dim=1)                       # (S, nMB)
    best_sad = torch.gather(sads, 1, best_idx.unsqueeze(1)).squeeze(1)
    sad0 = sads[:, zero_offset_index(search)]
    dydx = offs[best_idx]                                      # (S, nMB, 2)
    mv = torch.stack([dydx[..., 1], dydx[..., 0]], dim=-1)     # (mvx, mvy)
    return mv, best_sad, sad0


def full_search(cur_y: torch.Tensor, ref_y: torch.Tensor,
                search: int = DEFAULT_SEARCH_RANGE):
    """Returns (mv, best_sad, sad0):

      mv:       (S, nMB, 2) int32 (mvx, mvy) -- horizontal, vertical
      best_sad: (S, nMB) int32 SAD at mv
      sad0:     (S, nMB) int32 SAD at (0, 0)

    CUDA tensors run the fused SAD-search kernel (uint8 planes); CPU
    tensors the plain map + argmin.
    """
    if cur_y.is_cuda:
        return sad_search_cuda(cur_y, ref_y, search)
    if cur_y.device.type != "cpu":
        raise ValueError(f"full_search: no path for device {cur_y.device}")
    return search_from_map(sad_map(cur_y, ref_y, search), search)
