"""Wrapper of the hand-written SAD-search kernel (`csrc/sad_search.cu`).

The kernel replaces the TPU's `me_pallas.sad_map_pallas_bf16` plus the
argmin of `me.full_search`: it returns (mv, best_sad, sad0) directly, and
writes the dense (S, 961, nMB) SAD map only when asked (`with_map=True`,
for parity checks against the plain `me.sad_map`).  See the source for
what bounds it and how it is laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from p64tpu.spec.constants import DEFAULT_SEARCH_RANGE, MB_SIZE

from . import _build

#: kernel launches since the count was last reset (a run that claims to
#: have gone through the kernel shows it here)
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build and load the kernel's library and declare its C signatures,
    once per process."""
    lib = _build.load("sad_search")
    fn = lib.p64_sad_search
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.p64_cuda_error_string.argtypes = [ctypes.c_int]
    lib.p64_cuda_error_string.restype = ctypes.c_char_p
    return lib


def sad_search_cuda(cur_y: torch.Tensor, ref_y: torch.Tensor,
                    search: int = DEFAULT_SEARCH_RANGE, *,
                    with_map: bool = False):
    """Fused full search on the card.

    Args:
      cur_y, ref_y: (S, H, W) uint8 CUDA tensors, contiguous, same device;
        H and W multiples of 16.
      search: 0..15.

    Returns (mv (S, nMB, 2) int32 as (mvx, mvy), best_sad (S, nMB) int32,
    sad0 (S, nMB) int32), plus the (S, (2s+1)^2, nMB) int32 SAD map as a
    fourth element when with_map is set.
    """
    global LAUNCHES
    for name, t in (("cur_y", cur_y), ("ref_y", ref_y)):
        if not t.is_cuda:
            raise ValueError(f"sad_search_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.dtype != torch.uint8:
            raise ValueError(f"sad_search_cuda: {name} is {t.dtype}, "
                             "needs torch.uint8")
        if t.dim() != 3:
            raise ValueError(f"sad_search_cuda: {name} has shape "
                             f"{tuple(t.shape)}, needs (S, H, W)")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"sad_search_cuda: {name} must be contiguous "
                             "and 4-byte aligned")
    if cur_y.shape != ref_y.shape or cur_y.device != ref_y.device:
        raise ValueError("sad_search_cuda: cur_y and ref_y differ in shape "
                         "or device")
    s, h, w = cur_y.shape
    if h % MB_SIZE or w % MB_SIZE or not 1 <= s <= 65535:
        raise ValueError(f"sad_search_cuda: unsupported shape {(s, h, w)}")
    if not 0 <= search <= DEFAULT_SEARCH_RANGE:
        raise ValueError(f"sad_search_cuda: search {search} not in 0..15")

    n_mb = (h // MB_SIZE) * (w // MB_SIZE)
    side = 2 * search + 1
    dev = cur_y.device
    mv = torch.empty((s, n_mb, 2), dtype=torch.int32, device=dev)
    best = torch.empty((s, n_mb), dtype=torch.int32, device=dev)
    sad0 = torch.empty((s, n_mb), dtype=torch.int32, device=dev)
    sads = (torch.empty((s, side * side, n_mb), dtype=torch.int32,
                        device=dev) if with_map else None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.p64_sad_search(
            cur_y.data_ptr(), ref_y.data_ptr(), s, h, w, search,
            mv.data_ptr(), best.data_ptr(), sad0.data_ptr(),
            sads.data_ptr() if with_map else None, stream)
    if rc != 0:
        msg = lib.p64_cuda_error_string(rc).decode()
        raise RuntimeError(f"sad_search kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES += 1
    if with_map:
        return mv, best, sad0, sads
    return mv, best, sad0
