"""The decode's levels expanded from their packed form
(`native.binding.NativeBitIO.pack_levels`, stacked by
`core.decoder.stack_seqs`) to the dense (T, S, nMB, 6, 64) int8 levels8 the
reconstruct step reads.

`expand_levels` launches the hand-written kernel (`csrc/levels_expand.cu`,
which says what bounds it) on CUDA tensors and runs the plain version,
`expand_levels_plain`, on CPU tensors.  On a CUDA tensor it launches or
raises: nothing falls back.  It runs once a decode batch, before the
replays, never inside a captured step.

The packed batch, as the kernel reads it:

  mbs     (T, S, nMB) uint8, bit b set where block b of the MB holds a
          nonzero level
  blocks  (B,) int64 (the packer's uint64 bits), one per such block, bit j
          set where slot j is nonzero; a frame's in (MB, block) order
  values  (V,) int8, the nonzero levels; a frame's in (MB, block, slot)
          order
  bases   (T, S, 2) int64, the first block mask and the first level of each
          (frame, stream)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: kernel launches since the count was last reset, one a decode batch
LAUNCHES = 0

#: macroblocks a frame may have (CIF; the kernel's kMaxMbs)
MAX_MBS = 396


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build and load the kernel's library and declare its C signature,
    once per process."""
    lib = _build.load("levels_expand")
    ptr = ctypes.c_void_p
    lib.p64_levels_expand.argtypes = [ptr] * 4 + [ctypes.c_longlong,
                                                  ctypes.c_int, ptr, ptr]
    lib.p64_levels_expand.restype = ctypes.c_int
    lib.p64_cuda_error_string.argtypes = [ctypes.c_int]
    lib.p64_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(mbs: torch.Tensor, blocks: torch.Tensor,
                 values: torch.Tensor, bases: torch.Tensor) -> None:
    """Raise ValueError unless the packed batch is what expand_levels
    takes: mbs (T, S, nMB) uint8 with nMB <= MAX_MBS, blocks (B,) int64,
    values (V,) int8, bases (T, S, 2) int64, all contiguous and on one
    device."""
    if mbs.dim() != 3 or mbs.dtype != torch.uint8:
        raise ValueError(f"expand_levels: mbs must be (T, S, nMB) uint8; "
                         f"got {mbs.dtype}{tuple(mbs.shape)}")
    if not 0 < mbs.shape[2] <= MAX_MBS:
        raise ValueError(f"expand_levels: {mbs.shape[2]} MBs a frame; at "
                         f"most {MAX_MBS}")
    want = {"blocks": (blocks, 1, torch.int64),
            "values": (values, 1, torch.int8),
            "bases": (bases, 3, torch.int64)}
    for name, (t, dims, dtype) in want.items():
        if t.dim() != dims or t.dtype != dtype:
            raise ValueError(f"expand_levels: {name} is {t.dtype}"
                             f"{tuple(t.shape)}, needs {dims} dims of "
                             f"{dtype}")
    if tuple(bases.shape) != (*mbs.shape[:2], 2):
        raise ValueError(f"expand_levels: bases {tuple(bases.shape)} for "
                         f"mbs {tuple(mbs.shape)}")
    for name, t in (("mbs", mbs), ("blocks", blocks), ("values", values),
                    ("bases", bases)):
        if not t.is_contiguous():
            raise ValueError(f"expand_levels: {name} must be contiguous")
        if t.device != mbs.device:
            raise ValueError(f"expand_levels: {name} is on {t.device}, mbs "
                             f"on {mbs.device}")


def expand_levels(mbs: torch.Tensor, blocks: torch.Tensor,
                  values: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """The dense (T, S, nMB, 6, 64) int8 levels of a packed batch, on its
    device: the kernel on a CUDA device, the plain version on the CPU.
    Raises ValueError on inputs it does not take (check_inputs) and
    RuntimeError on a launch that fails."""
    check_inputs(mbs, blocks, values, bases)
    if not mbs.is_cuda:
        return expand_levels_plain(mbs, blocks, values, bases)
    return expand_levels_cuda(mbs, blocks, values, bases)


def expand_levels_cuda(mbs: torch.Tensor, blocks: torch.Tensor,
                       values: torch.Tensor,
                       bases: torch.Tensor) -> torch.Tensor:
    """expand_levels through the kernel, on the device's current stream."""
    global LAUNCHES
    t, s, m = mbs.shape
    dev = mbs.device
    out = torch.empty((t, s, m, 6, 64), dtype=torch.int8, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.p64_levels_expand(mbs.data_ptr(), blocks.data_ptr(),
                                   values.data_ptr(), bases.data_ptr(),
                                   t * s, m, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.p64_cuda_error_string(rc).decode()
        raise RuntimeError(f"levels expand kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES += 1
    return out


def _ranks(mask: torch.Tensor):
    """(row, rank in its row) of each True of a 2-D bool mask, in
    row-major order."""
    row = mask.nonzero()[:, 0]
    per_row = mask.sum(1)
    first = torch.cumsum(per_row, 0) - per_row
    return row, torch.arange(row.numel(), device=mask.device) - first[row]


def expand_levels_plain(mbs: torch.Tensor, blocks: torch.Tensor,
                        values: torch.Tensor,
                        bases: torch.Tensor) -> torch.Tensor:
    """expand_levels in plain torch: the masks unpacked to a dense mask of
    the nonzero slots, each level's index in `values` from its frame's base
    and its rank in the frame, then zeros and one index_put_."""
    t, s, m = mbs.shape
    dev = mbs.device
    frames = t * s
    base = bases.reshape(frames, 2)
    has = ((mbs.reshape(frames, m, 1).to(torch.int64)
            >> torch.arange(6, device=dev)) & 1).bool().reshape(frames, -1)
    frame, rank = _ranks(has)
    masks = blocks[base[frame, 0] + rank]
    nonzero = torch.zeros((frames, m * 6, 64), dtype=torch.bool, device=dev)
    nonzero[has] = ((masks[:, None] >> torch.arange(64, device=dev))
                    & 1).bool()
    frame, rank = _ranks(nonzero.reshape(frames, -1))
    out = torch.zeros((frames, m * 6, 64), dtype=torch.int8, device=dev)
    out.index_put_((nonzero,), values[base[frame, 1] + rank])
    return out.reshape(t, s, m, 6, 64)
