"""Quantization / inverse quantization and zigzag, batched over blocks.

Port of `p64tpu/kernels/quant.py` (H.261 section 4.2.4):

  forward AC/inter:  level = trunc_toward_zero(coef / (2*QUANT)), clamped to
                     +/-127
  forward intra DC:  level = clamp((coef + 4) >> 3, 1, 254)
  inverse:           level == 0 -> 0; else QUANT*(2*level + sign) minus sign
                     on even QUANT; clamp to [-2048, 2047]; intra DC 8*level

The reference divides with a magic-multiply table because the TPU has no
integer divide; here it is an integer division truncating toward zero.
"""

from __future__ import annotations

import numpy as np
import torch

from p64tpu.spec.constants import (
    COEFF_CLAMP_MAX,
    COEFF_CLAMP_MIN,
    INTRA_DC_MAX,
    INTRA_DC_MIN,
    LEVEL_CLAMP,
)
from p64tpu.spec.zigzag import INV_ZIGZAG, ZIGZAG

from ..utils import device_const

_ZIGZAG = ZIGZAG.astype(np.int64)
_INV_ZIGZAG = INV_ZIGZAG.astype(np.int64)


def _slot0(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device) == 0


def zigzag_scan(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) -> (..., 64) in zigzag transmission order."""
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    return flat[..., device_const(_ZIGZAG, blocks.device)]


def zigzag_unscan(zz: torch.Tensor) -> torch.Tensor:
    """(..., 64) zigzag order -> (..., 8, 8) row-major."""
    flat = zz[..., device_const(_INV_ZIGZAG, zz.device)]
    return flat.reshape(*zz.shape[:-1], 8, 8)


def quantize_zz(coefs_zz: torch.Tensor, quant: torch.Tensor,
                intra: torch.Tensor) -> torch.Tensor:
    """Quantize zigzag-ordered DCT coefficients.

    Args:
      coefs_zz: (..., 64) integer transform coefficients, zigzag order.
      quant: broadcastable integer QUANT (1..31), e.g. (..., 1).
      intra: broadcastable bool against (..., 64); where True slot 0 (the
        DC) takes the intra-DC rule.

    Returns (..., 64) int32 zigzag levels.
    """
    coefs = coefs_zz.to(torch.int32)
    q2 = 2 * torch.as_tensor(quant, device=coefs.device).to(torch.int32)
    ac = torch.sign(coefs) * torch.div(coefs.abs(), q2, rounding_mode="trunc")
    ac = ac.clamp(-LEVEL_CLAMP, LEVEL_CLAMP)
    dc_intra = ((coefs + 4) >> 3).clamp(INTRA_DC_MIN, INTRA_DC_MAX)
    return torch.where(intra & _slot0(64, coefs.device), dc_intra, ac)


def dequantize(levels_zz: torch.Tensor, quant: torch.Tensor,
               intra: torch.Tensor) -> torch.Tensor:
    """(..., 64) zigzag levels -> (..., 8, 8) reconstructed coefficients
    (int32, clamped).  `quant`/`intra` broadcast as (..., 1)."""
    lv = levels_zz.to(torch.int32)
    q = torch.as_tensor(quant, device=lv.device).to(torch.int32)
    s = torch.sign(lv)
    even_adj = torch.where(q % 2 == 0, s, 0)
    rec = torch.where(lv == 0, 0, q * (2 * lv + s) - even_adj)
    rec = rec.clamp(COEFF_CLAMP_MIN, COEFF_CLAMP_MAX)
    dc = 8 * lv[..., :1]
    rec = torch.where(intra & _slot0(lv.shape[-1], lv.device), dc, rec)
    return zigzag_unscan(rec)
