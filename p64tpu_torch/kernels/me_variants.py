"""The other four dense SAD-map formulations of the JAX package.

Port of the TPU kernels in `p64tpu/kernels/me_pallas.py` that compute the
same contract as `me.sad_map` by other data paths:

  * `sad_map_f32`  -- `_sad_kernel`: float32 abs-diff, 0/1 pooling matmuls
  * `sad_map_rp`   -- `_sad_kernel_rp`: 16-row sums first, then a hi/lo
                      split column pool
  * `sad_map_i8`   -- `_sad_kernel_i8`: abs-diff - 128 as int8, an integer
                      column pool plus 128 * 16 per box, hi/lo row pool
  * `sad_map_swar` -- `_sad_kernel_swar`: 4 pixels per 32-bit word, bytewise
                      |a - b| by the 16-bit-field trick (`pair_absdiff`)

Each takes (S, H, W) integer planes and returns the (S, (2s+1)^2, nMB)
int32 map, offsets in dy-major order, out-of-picture offsets 1<<30.  On a
CUDA tensor each dispatches to its hand-written kernel (`me_variants_cuda`,
which raises if it cannot launch); on a CPU tensor it runs its `*_plain`
version below, which follows the TPU kernel's data path in torch ops.  The
plain versions also run on the card, where the kernels are held against
them.

The TPU's bf16 operands exist because its matrix unit is fastest in bf16;
torch returns a bf16 matmul in bf16, which would round sums above 256, so
the plain versions keep the hi/lo splits but multiply in float32, which is
exact here (every partial sum is an integer below 2^24).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..spec.constants import DEFAULT_SEARCH_RANGE, MB_SIZE
from ..utils import device_const
from . import me_variants_cuda
from .me import INVALID_SAD, _validity_mask

_M00FF = 0x00FF00FF
_BIAS = 0x01000100
_BIT8 = 0x00010001


@functools.lru_cache(maxsize=None)
def _pool_matrices(h: int, w: int):
    """0/1 pooling matrices in float32: P_r (h/16, h) sums the 16 rows of
    each MB row, P_c (w, w/16) the 16 columns of each MB column."""
    pr = np.kron(np.eye(h // MB_SIZE, dtype=np.float32),
                 np.ones((1, MB_SIZE), np.float32))
    pc = np.kron(np.eye(w // MB_SIZE, dtype=np.float32),
                 np.ones((MB_SIZE, 1), np.float32))
    return pr, pc


@functools.lru_cache(maxsize=None)
def _word_pool_matrix(w: int) -> np.ndarray:
    """(w/4, w/16) float32: sums the 4 packed words of each MB column."""
    return np.kron(np.eye(w // MB_SIZE, dtype=np.float32),
                   np.ones((MB_SIZE // 4, 1), np.float32))


def _finish(sads: torch.Tensor, h: int, w: int, search: int) -> torch.Tensor:
    """(S, side_dy, side_dx, R, C) sums -> the (S, side^2, nMB) int32 map
    with out-of-picture offsets masked."""
    s, side = sads.shape[0], 2 * search + 1
    sads = sads.reshape(s, side * side, -1).to(torch.int32)
    valid = _validity_mask(h, w, search, sads.device)
    return torch.where(valid, sads, torch.full_like(sads, INVALID_SAD))


def _dx_windows(ref_pad: torch.Tensor, dy: int, h: int, w: int):
    """(S, H, side, W): every dx shift of this dy's reference rows."""
    return ref_pad[:, dy:dy + h, :].unfold(2, w, 1)


def _hi_lo_pool(x: torch.Tensor, pool: torch.Tensor,
                equation: str) -> torch.Tensor:
    """Pool integer-valued x (<= 16320) with a 0/1 matrix through the hi/lo
    split the TPU kernels use (x = 64 * hi + lo), recombined exactly."""
    hi = torch.floor(x * (1.0 / 64.0))
    lo = x - 64.0 * hi
    return (64.0 * torch.einsum(equation, pool, hi)
            + torch.einsum(equation, pool, lo))


def sad_map_f32_plain(cur_y: torch.Tensor, ref_y: torch.Tensor,
                      search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 1's data path: float32 |cur - ref|, column pool then row pool
    as float32 matmuls with 0/1 matrices (exact: sums <= 65,280 < 2^24)."""
    s, h, w = cur_y.shape
    side = 2 * search + 1
    pr_np, pc_np = _pool_matrices(h, w)
    pr = device_const(pr_np, cur_y.device)
    pc = device_const(pc_np, cur_y.device)
    cur = cur_y.to(torch.float32).unsqueeze(2)                # (S, H, 1, W)
    ref_pad = F.pad(ref_y.to(torch.float32), (search,) * 4)
    rows = []
    for dy in range(side):
        ad = (cur - _dx_windows(ref_pad, dy, h, w)).abs()     # (S, H, dx, W)
        part = torch.matmul(ad, pc)                           # (S, H, dx, C)
        rows.append(torch.einsum("rh,shdc->sdrc", pr, part))  # (S, dx, R, C)
    return _finish(torch.stack(rows, dim=1), h, w, search)


def sad_map_rp_plain(cur_y: torch.Tensor, ref_y: torch.Tensor,
                     search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 3's data path: each dy's |cur - ref| rows reduced to 16-row
    sums (<= 4080) by a reshape-sum, then one hi/lo split column pool."""
    s, h, w = cur_y.shape
    side = 2 * search + 1
    rr = h // MB_SIZE
    _, pc_np = _pool_matrices(h, w)
    pc = device_const(pc_np, cur_y.device)
    cur = cur_y.to(torch.float32).unsqueeze(2)
    ref_pad = F.pad(ref_y.to(torch.float32), (search,) * 4)
    rows = []
    for dy in range(side):
        ad = (cur - _dx_windows(ref_pad, dy, h, w)).abs()     # (S, H, dx, W)
        rsum = ad.reshape(s, rr, MB_SIZE, side, w).sum(dim=2)  # (S, R, dx, W)
        rows.append(_hi_lo_pool(rsum, pc, "wc,srdw->sdrc"))   # (S, dx, R, C)
    return _finish(torch.stack(rows, dim=1), h, w, search)


def sad_map_i8_plain(cur_y: torch.Tensor, ref_y: torch.Tensor,
                     search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 4's data path: ad - 128 as int8 (ad = |cur - ref| <= 255),
    an integer 16-column pool plus 128 * 16 per box (a reshape-sum: CUDA
    has no integer matmul), then the hi/lo split row pool."""
    s, h, w = cur_y.shape
    side = 2 * search + 1
    mbc = w // MB_SIZE
    pr_np, _ = _pool_matrices(h, w)
    pr = device_const(pr_np, cur_y.device)
    cur = cur_y.to(torch.int16).unsqueeze(2)
    ref_pad = F.pad(ref_y.to(torch.int16), (search,) * 4)
    rows = []
    for dy in range(side):
        ad = (cur - _dx_windows(ref_pad, dy, h, w)).abs()
        biased = (ad - 128).to(torch.int8)                    # exact: -128..127
        part = biased.reshape(s, h, side, mbc, MB_SIZE).sum(
            dim=-1, dtype=torch.int32) + 128 * MB_SIZE        # (S, H, dx, C)
        rows.append(_hi_lo_pool(part.to(torch.float32), pr,
                                "rh,shdc->sdrc"))             # (S, dx, R, C)
    return _finish(torch.stack(rows, dim=1), h, w, search)


def pack4(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) integer plane -> (..., H, W/4) int32, 4 bytes per word
    (byte k of word j = pixel 4j + k), the bit pattern of
    `me_pallas._pack4`.  Built in int64 and wrapped to int32 explicitly:
    byte 3 << 24 does not fit a signed 32-bit int."""
    p = plane.to(torch.int64)
    v = (p[..., 0::4] | (p[..., 1::4] << 8) | (p[..., 2::4] << 16)
         | (p[..., 3::4] << 24))
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def pair_absdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bytewise |a - b| of two 16-bit fields per word (bytes at bits 0 and
    16, each 0..255), as `me_pallas._sad_kernel_swar`'s `pair_absdiff`:

        d1 = (u | 256) - v,  d2 = (v | 256) - u   (both in 1..511)
        |u - v| = (the one with bit 8 set) & 255

    The words are non-negative 32-bit patterns held in int64, so every
    shift is logical and the field-mask multiply cannot overflow."""
    d1 = (a | _BIAS) - b
    d2 = (b | _BIAS) - a
    mask = ((d1 >> 8) & _BIT8) * 0xFFFF
    return ((d1 & mask) | (d2 & ~mask)) & _M00FF


def sad_map_swar_plain(cur_y: torch.Tensor, ref_y: torch.Tensor,
                       search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 5's data path: both planes packed 4 px per word, |a - b| for
    bytes 0,2 and 1,3 as two `pair_absdiff`s (fields <= 510), 16-row sums of
    the packed words (fields <= 8160), unpack, then a hi/lo split pool of
    the 4 words of each MB."""
    s, h, w = cur_y.shape
    side = 2 * search + 1
    rr, wp = h // MB_SIZE, w // 4
    pw = device_const(_word_pool_matrix(w), cur_y.device)
    cw = pack4(cur_y).to(torch.int64) & 0xFFFFFFFF            # (S, H, Wp)
    a0 = (cw & _M00FF).unsqueeze(1)
    a1 = ((cw >> 8) & _M00FF).unsqueeze(1)
    ref_pad = F.pad(ref_y.to(torch.int32), (search,) * 4)
    cols = []
    for dx in range(side):
        sh = pack4(ref_pad[:, :, dx:dx + w]).to(torch.int64) & 0xFFFFFFFF
        win = sh.unfold(1, h, 1).transpose(2, 3)              # (S, dy, H, Wp)
        ad = (pair_absdiff(a0, win & _M00FF)
              + pair_absdiff(a1, (win >> 8) & _M00FF))        # fields <= 510
        rows = ad.reshape(s, side, rr, MB_SIZE, wp).sum(dim=3)
        v = ((rows & 0xFFFF) + (rows >> 16)).to(torch.float32)  # <= 16320
        cols.append(_hi_lo_pool(v, pw, "pc,sdrp->sdrc"))      # (S, dy, R, C)
    return _finish(torch.stack(cols, dim=2), h, w, search)


def _dispatch(name: str, plain, cur_y, ref_y, search):
    if cur_y.is_cuda:
        return getattr(me_variants_cuda, name + "_cuda")(cur_y, ref_y, search)
    if cur_y.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {cur_y.device}")
    return plain(cur_y, ref_y, search)


def sad_map_f32(cur_y: torch.Tensor, ref_y: torch.Tensor,
                search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 1: the CUDA kernel on a CUDA tensor, the plain version on
    the CPU."""
    return _dispatch("sad_map_f32", sad_map_f32_plain, cur_y, ref_y, search)


def sad_map_rp(cur_y: torch.Tensor, ref_y: torch.Tensor,
               search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 3: the CUDA kernel on a CUDA tensor, the plain version on
    the CPU."""
    return _dispatch("sad_map_rp", sad_map_rp_plain, cur_y, ref_y, search)


def sad_map_i8(cur_y: torch.Tensor, ref_y: torch.Tensor,
               search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 4: the CUDA kernel on a CUDA tensor, the plain version on
    the CPU."""
    return _dispatch("sad_map_i8", sad_map_i8_plain, cur_y, ref_y, search)


def sad_map_swar(cur_y: torch.Tensor, ref_y: torch.Tensor,
                 search: int = DEFAULT_SEARCH_RANGE) -> torch.Tensor:
    """Kernel 5: the CUDA kernel on a CUDA tensor, the plain version on
    the CPU."""
    return _dispatch("sad_map_swar", sad_map_swar_plain, cur_y, ref_y,
                     search)


#: name -> (dispatching function, plain version), for the parity gate
VARIANTS = {
    "sad_map_f32": (sad_map_f32, sad_map_f32_plain),
    "sad_map_rp": (sad_map_rp, sad_map_rp_plain),
    "sad_map_i8": (sad_map_i8, sad_map_i8_plain),
    "sad_map_swar": (sad_map_swar, sad_map_swar_plain),
}
