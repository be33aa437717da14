"""Batched 8x8 integer DCT / IDCT.

Port of `p64tpu/kernels/dct.py`, same fully specified integer transform:

  basis   M[u, x] = c(u)/2 * cos((2x+1) u pi / 16),  c(0)=1/sqrt(2), else 1
  rshift_round(v, s) = (v + 2^(s-1)) >> s            (arithmetic shift)

  forward:  MI2 = round(kron(M, M) * 2^15)
            vec(F) = rshift_round(MI2 @ vec(f), 15)   # one rounding
  inverse:  MI = round(M * 2^13)
            t = rshift_round(MI^T @ F, 9)
            f = rshift_round(t @ MI,   17)

The constants are recomputed here with the reference's numpy expressions
(the reference module imports JAX).  CUDA has no integer matmul, so the
products run in float64, which is exact: every product and partial sum is
an integer below 2^53 (forward sums < 2^25.8, inverse stage-2 sums < 2^34),
and float64 adds such integers without rounding in any order.  The bf16
hi/lo split of the reference was a TPU workaround and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spec.zigzag import ZIGZAG
from ..utils import device_const

SCALE_BITS = 13
FWD_SCALE_BITS = 15
INV_SHIFT1, INV_SHIFT2 = 9, 17


def _float_basis() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    m[0, :] *= 1.0 / np.sqrt(2.0)
    return m


M_FLOAT: np.ndarray = _float_basis()
MI: np.ndarray = np.round(M_FLOAT * (1 << SCALE_BITS)).astype(np.int32)
MI2: np.ndarray = np.round(np.kron(M_FLOAT, M_FLOAT)
                           * (1 << FWD_SCALE_BITS)).astype(np.int32)
#: zigzag-ordered forward basis: row k produces the k-th zigzag coefficient
MI2_ZZ: np.ndarray = MI2[np.asarray(ZIGZAG)]

_MI_F64 = MI.astype(np.float64)
_MI2_T_F64 = np.ascontiguousarray(MI2.T, dtype=np.float64)
_MI2_ZZ_T_F64 = np.ascontiguousarray(MI2_ZZ.T, dtype=np.float64)


def rshift_round(v: torch.Tensor, s: int) -> torch.Tensor:
    """(v + 2^(s-1)) >> s with arithmetic shift: round-half-up in value."""
    return (v + (1 << (s - 1))) >> s


def _fdct(blocks: torch.Tensor, basis_t: np.ndarray) -> torch.Tensor:
    """(..., 8, 8) integer -> (..., 64) int32 through a (64, 64) basis."""
    shp = blocks.shape[:-2]
    v = blocks.reshape(-1, 64).to(torch.float64)
    s = torch.matmul(v, device_const(basis_t, blocks.device)).to(torch.int64)
    return rshift_round(s, FWD_SCALE_BITS).to(torch.int32).reshape(*shp, 64)


def fdct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Forward integer DCT: (..., 8, 8) integer -> (..., 8, 8) int32, in
    natural order."""
    return _fdct(blocks, _MI2_T_F64).reshape(blocks.shape)


def fdct8x8_zz(blocks: torch.Tensor) -> torch.Tensor:
    """Forward integer DCT emitting zigzag-ordered coefficients:
    (..., 8, 8) integer -> (..., 64) int32."""
    return _fdct(blocks, _MI2_ZZ_T_F64)


def idct8x8(coefs: torch.Tensor) -> torch.Tensor:
    """Inverse integer DCT over (..., 8, 8) integer -> (..., 8, 8) int32."""
    mi = device_const(_MI_F64, coefs.device)
    t = torch.matmul(mi.T, coefs.to(torch.float64)).to(torch.int64)
    t = rshift_round(t, INV_SHIFT1).to(torch.float64)
    f = torch.matmul(t, mi).to(torch.int64)
    return rshift_round(f, INV_SHIFT2).to(torch.int32)
