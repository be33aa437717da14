"""H.261 loop filter: separable 1/4*[1 2 1] on 8x8 prediction blocks.

The two 1-D passes are combined
WITHOUT intermediate rounding, then rounded once:

    h[i][j] = p[i][j-1] + 2 p[i][j] + p[i][j+1]   (interior j)   else 4 p[i][j]
    out[i][j] = (h[i-1][j] + 2 h[i][j] + h[i+1][j] + 8) >> 4  (interior i)
                (4 h[i][j] + 8) >> 4                           (edge i)
"""

from __future__ import annotations

import torch


def _pass(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One unnormalized [1 2 1] pass along `dim`; edges scaled by 4."""
    x = x.movedim(dim, -1)
    interior = x[..., :-2] + 2 * x[..., 1:-1] + x[..., 2:]
    out = torch.cat([4 * x[..., :1], interior, 4 * x[..., -1:]], dim=-1)
    return out.movedim(-1, dim)


def loop_filter8x8(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) integer -> filtered (..., 8, 8) int32."""
    b = blocks.to(torch.int32)
    return (_pass(_pass(b, -1), -2) + 8) >> 4
