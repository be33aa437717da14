"""Zigzag scan order for 8x8 transform blocks (H.261 Figure 10).

ZIGZAG[k] = (row-major index into the 8x8 block) of the k-th transmitted
coefficient.  INV_ZIGZAG is the inverse permutation.  The order is
normative.
"""

from __future__ import annotations

import numpy as np


def _build_zigzag() -> np.ndarray:
    order = []
    r = c = 0
    for _ in range(64):
        order.append(r * 8 + c)
        if (r + c) % 2 == 0:  # moving up-right
            if c == 7:
                r += 1
            elif r == 0:
                c += 1
            else:
                r -= 1
                c += 1
        else:  # moving down-left
            if r == 7:
                c += 1
            elif c == 0:
                r += 1
            else:
                r += 1
                c -= 1
    return np.asarray(order, dtype=np.int32)


#: flat-index permutation: zigzag position k -> row-major position
ZIGZAG: np.ndarray = _build_zigzag()

#: row-major position -> zigzag position
INV_ZIGZAG: np.ndarray = np.argsort(ZIGZAG).astype(np.int32)
