"""Wrapper of the hand-written SAD-search kernel (`csrc/sad_search.cu`).

The kernel replaces the TPU's `me_pallas.sad_map_pallas_bf16` plus the
argmin of `me.full_search`: it returns (mv, best_sad, sad0) directly, and
writes the dense (S, 961, nMB) SAD map only when asked (`with_map=True`,
for parity checks against the plain `me.sad_map`).  See the source for
what bounds it and how it is laid out.

The same library holds the four SAD-map kernels that `me_variants_cuda`
wraps; both share its loader, argument check and launch helper here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from p64tpu.spec.constants import DEFAULT_SEARCH_RANGE, MB_SIZE

from . import _build

#: kernel launches since the count was last reset (a run that claims to
#: have gone through the kernel shows it here)
LAUNCHES = 0

#: the library's SAD-map kernels (entry points p64_<name>)
MAP_KERNELS = ("sad_map_f32", "sad_map_rp", "sad_map_i8", "sad_map_swar")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build and load the kernels' library and declare its C signatures,
    once per process."""
    lib = _build.load("sad_search")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    planes = [ptr, ptr, i32, i32, i32, i32]  # cur, ref, S, H, W, search
    lib.p64_sad_search.argtypes = planes + [ptr] * 5
    lib.p64_sad_search.restype = i32
    for name in MAP_KERNELS:
        fn = getattr(lib, "p64_" + name)
        fn.argtypes = planes + [ptr, ptr]
        fn.restype = i32
    lib.p64_cuda_error_string.argtypes = [i32]
    lib.p64_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_planes(kernel: str, cur_y: torch.Tensor, ref_y: torch.Tensor,
                 search: int) -> Tuple[int, int, int]:
    """Raise ValueError unless cur_y and ref_y are (S, H, W) uint8 CUDA
    tensors the kernels take; returns (S, H, W)."""
    for name, t in (("cur_y", cur_y), ("ref_y", ref_y)):
        if not t.is_cuda:
            raise ValueError(f"{kernel}_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.dtype != torch.uint8:
            raise ValueError(f"{kernel}_cuda: {name} is {t.dtype}, "
                             "needs torch.uint8")
        if t.dim() != 3:
            raise ValueError(f"{kernel}_cuda: {name} has shape "
                             f"{tuple(t.shape)}, needs (S, H, W)")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{kernel}_cuda: {name} must be contiguous "
                             "and 4-byte aligned")
    if cur_y.shape != ref_y.shape or cur_y.device != ref_y.device:
        raise ValueError(f"{kernel}_cuda: cur_y and ref_y differ in shape "
                         "or device")
    s, h, w = cur_y.shape
    if h % MB_SIZE or w % MB_SIZE or not 1 <= s <= 65535:
        raise ValueError(f"{kernel}_cuda: unsupported shape {(s, h, w)}")
    if not 0 <= search <= DEFAULT_SEARCH_RANGE:
        raise ValueError(f"{kernel}_cuda: search {search} not in 0..15")
    return s, h, w


def launch(kernel: str, device: torch.device, *args) -> None:
    """Call the entry point p64_<kernel>(*args, stream) on the device's
    current stream; raise RuntimeError on a non-zero CUDA error code."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "p64_" + kernel)(*args, stream)
    if rc != 0:
        msg = lib.p64_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


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
    s, h, w = check_planes("sad_search", cur_y, ref_y, search)
    n_mb = (h // MB_SIZE) * (w // MB_SIZE)
    side = 2 * search + 1
    dev = cur_y.device
    mv = torch.empty((s, n_mb, 2), dtype=torch.int32, device=dev)
    best = torch.empty((s, n_mb), dtype=torch.int32, device=dev)
    sad0 = torch.empty((s, n_mb), dtype=torch.int32, device=dev)
    sads = (torch.empty((s, side * side, n_mb), dtype=torch.int32,
                        device=dev) if with_map else None)
    launch("sad_search", dev, cur_y.data_ptr(), ref_y.data_ptr(), s, h, w,
           search, mv.data_ptr(), best.data_ptr(), sad0.data_ptr(),
           sads.data_ptr() if with_map else None)
    LAUNCHES += 1
    if with_map:
        return mv, best, sad0, sads
    return mv, best, sad0
