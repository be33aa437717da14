"""Wrapper of the hand-written SAD-search kernel (`csrc/sad_search.cu`).

The kernel replaces the TPU's `me_pallas.sad_map_pallas_bf16` plus the
argmin of `me.full_search`: it returns (mv, best_sad, sad0) directly, and
writes the dense (S, 961, nMB) SAD map only when asked (`with_map=True`,
for parity checks against the plain `me.sad_map`).  See the source for
what bounds it and how it is laid out.

`search_tiles` computes the kernel's launch geometry (MB tiles, the word
columns and dy tiles a thread owns) through `tile_geometry`, which the K1,
K4 and K5 map kernels share; tests/test_torch_me_tiles.py walks it as the
kernels do.

The same library holds the four SAD-map kernels that `me_variants_cuda`
wraps; both share its loader, argument check and launch helper here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Tuple

import torch

from ..spec.constants import DEFAULT_SEARCH_RANGE, MB_SIZE
from . import _build

#: kernel launches since the count was last reset (a run that claims to
#: have gone through the kernel shows it here)
LAUNCHES = 0

#: the library's SAD-map kernels (entry points p64_<name>)
MAP_KERNELS = ("sad_map_f32", "sad_map_rp", "sad_map_i8", "sad_map_swar")

#: the kernel's limits (csrc/sad_search.cu kThreads, kTileDy, kStaticSmem)
THREADS, TILE_DY, SMEM_LIMIT = 256, 8, 48 * 1024
#: byte alignments of the window the kernel keeps in shared memory
ALIGNS = 4
#: most MBs one block's window serves
MAX_TILE_MBS = 32


@dataclasses.dataclass(frozen=True)
class SearchTiles:
    """Launch geometry of a kernel that serves MB tiles (the search, the K1,
    K4 and K5 maps) for one (H, W, search).

    A block serves `mb_tile` horizontally adjacent MBs of one MB row
    (`tiles_per_row` blocks per row, the last one ragged when mb_tile does
    not divide the MB columns).  Per MB, `n_dxg` threads own word columns
    g_lo .. g_lo + n_dxg - 1 of the window, byte columns 4g .. 4g+3, i.e.
    dx = 4g + j - 16 for j in 0..3, and `n_dyt` dy tiles own dy + search =
    TILE_DY t + i for i below TILE_DY.  The block is (dx group, MB, dy
    tile), dx group fastest; the grid (tile, MB row, stream)."""

    tiles_per_row: int
    mb_tile: int
    g_lo: int
    n_dxg: int
    n_dyt: int

    @property
    def threads(self) -> int:
        return self.n_dxg * self.mb_tile * self.n_dyt

    def aligned_smem_bytes(self, search: int, with_map: bool) -> int:
        """Shared memory of a tile read in ALIGNS byte alignments (the
        search, K4; csrc/sad_search.cu aligned_tile_smem_bytes): the window
        in ALIGNS copies, which the tile's map reuses, and the current
        rows."""
        win = 4 * ALIGNS * ((TILE_DY * self.n_dyt + MB_SIZE - 1)
                            * (4 * self.mb_tile + 8))
        side = 2 * search + 1
        tile_map = 16 * -(-side * side * self.mb_tile // 4) if with_map else 0
        return max(win, tile_map) + 4 * MB_SIZE * 4 * self.mb_tile

    def smem_bytes(self, search: int, with_map: bool) -> int:
        """Dynamic shared memory of one search block: the aligned tile and
        one 8-byte key per thread."""
        return self.aligned_smem_bytes(search, with_map) + 8 * self.threads

    def args(self) -> Tuple[int, ...]:
        return (self.tiles_per_row, self.mb_tile, self.g_lo, self.n_dxg,
                self.n_dyt)


def tile_geometry(height: int, width: int, search: int,
                  smem_bytes: Callable[[SearchTiles], int]) -> SearchTiles:
    """The tile geometry of a kernel that serves MB tiles (the search, and
    the K1, K4 and K5 maps) for (H, W) planes and a search range: word columns
    covering byte columns 16 - search .. 16 + search, dy tiles covering
    the 2 search + 1 dy, and as many MBs per block as 256 threads,
    MAX_TILE_MBS and the kernel's shared memory, `smem_bytes(tiles)`,
    allow."""
    g_lo = (16 - search) // 4
    n_dxg = (16 + search) // 4 - g_lo + 1
    n_dyt = -(-(2 * search + 1) // TILE_DY)
    mb_cols = width // MB_SIZE
    mb_tile = max(1, min(THREADS // (n_dxg * n_dyt), mb_cols, MAX_TILE_MBS))
    while True:
        tiles = SearchTiles(-(-mb_cols // mb_tile), mb_tile, g_lo, n_dxg,
                            n_dyt)
        if mb_tile == 1 or smem_bytes(tiles) <= SMEM_LIMIT:
            return tiles
        mb_tile -= 1


def search_tiles(height: int, width: int, search: int) -> SearchTiles:
    """The search kernel's tile geometry; its MB tile fits map mode's
    shared memory."""
    return tile_geometry(height, width, search,
                         lambda t: t.smem_bytes(search, True))


#: the C arguments every entry point starts with: cur, ref, S, H, W, search
_PLANE_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build and load the kernels' library and declare the search's and the
    error string's C signatures, once per process."""
    lib = _build.load("sad_search")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.p64_sad_search.argtypes = _PLANE_ARGTYPES + [i32] * 5 + [ptr] * 5
    lib.p64_sad_search.restype = i32
    lib.p64_cuda_error_string.argtypes = [i32]
    lib.p64_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def declare_map(kernel: str, n_geometry: int) -> None:
    """Declare the C signature of the map entry point p64_<kernel>: the
    planes, `n_geometry` int geometry arguments, the map and the stream."""
    fn = getattr(_lib(), "p64_" + kernel)
    fn.argtypes = (_PLANE_ARGTYPES + [ctypes.c_int] * n_geometry
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int


def check_planes(kernel: str, cur_y: torch.Tensor, ref_y: torch.Tensor,
                 search: int) -> Tuple[int, int, int]:
    """Raise ValueError unless cur_y and ref_y are (S, H, W) uint8 CUDA
    tensors the kernels take, 16-byte aligned (every kernel stages its
    planes with cp.async); returns (S, H, W)."""
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
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}_cuda: {name} must be contiguous "
                             "and 16-byte aligned")
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
    tiles = search_tiles(h, w, search)
    side = 2 * search + 1
    dev = cur_y.device
    mv = torch.empty((s, n_mb, 2), dtype=torch.int32, device=dev)
    best = torch.empty((s, n_mb), dtype=torch.int32, device=dev)
    sad0 = torch.empty((s, n_mb), dtype=torch.int32, device=dev)
    sads = (torch.empty((s, side * side, n_mb), dtype=torch.int32,
                        device=dev) if with_map else None)
    launch("sad_search", dev, cur_y.data_ptr(), ref_y.data_ptr(), s, h, w,
           search, *tiles.args(), mv.data_ptr(), best.data_ptr(),
           sad0.data_ptr(), sads.data_ptr() if with_map else None)
    LAUNCHES += 1
    if with_map:
        return mv, best, sad0, sads
    return mv, best, sad0
