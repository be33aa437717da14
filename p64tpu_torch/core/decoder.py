"""H.261 decoder: host VLC parse -> batched reconstruction on the device.

Port of `p64tpu/core/decoder.py`.  The bit-serial parse runs on the host in
the C++ engine (`native.binding`), producing dense per-frame symbol arrays;
everything numeric (dequantize, IDCT, MC, loop filter, add, clip) runs on
the device through the SAME `core.reconstruct.reconstruct_frame` the
encoder uses for its local decode -- so encoder reconstruction and decoder
output are identical by construction.

Batch-first, like the rest of the port: `decode_seq_batch` stacks S
equal-length parsed streams on the host, their levels packed (the nonzero
levels and the masks that place them, packed by the parse threads), copies
them to the device once, expands the levels there with one kernel
(`kernels.levels_cuda`), and runs the T frames (the reference's
`lax.scan` under `vmap`) carrying the (S, H, W) planes: on a CUDA device
as one captured reconstruct step replayed per frame (core.graphs, the
counterpart of the reference's jitted `_decode_scan`), on the CPU as a
host loop.  The planes stay on the device until one copy back at the end,
into pinned host memory on a CUDA device.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..spec.constants import MB_SIZE, Format
from ..entropy.parse import ParsedFrame
from ..kernels.levels_cuda import expand_levels
from ..native import PACKED_KEYS, load
from ..utils import fan_map
from . import graphs
from .reconstruct import reconstruct_frame

#: keys of a parsed sequence dict (parse_to_tensors, frames_to_tensors)
#: that the reconstruct step reads; the dict also holds PACKED_KEYS
#: (native.binding.NativeBitIO.pack_levels), which stack_seqs ships
SEQ_KEYS = ("levels8", "dc", "quant", "intra", "mv", "fil")
#: the keys stack_seqs stacks as they are: all but levels8, which crosses
#: to the device packed
STACKED_KEYS = SEQ_KEYS[1:]
#: the parts of stack_seqs' staging buffer, in order, with their dtypes on
#: the host and on the device (the block masks' bits cross as int64); each
#: part starts on a multiple of _ALIGN bytes
_STAGE = dict(nz_blocks=(np.uint64, torch.int64),
              nz_bases=(np.int64, torch.int64), dc=(np.uint8, torch.uint8),
              quant=(np.int32, torch.int32), intra=(np.bool_, torch.bool),
              mv=(np.int32, torch.int32), fil=(np.bool_, torch.bool),
              nz_mbs=(np.uint8, torch.uint8), nz_levels=(np.int8, torch.int8))
_ALIGN = 16

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _device(device: torch.device | str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; decode with "
                           "device='cpu'")
    return dev


def _check_mv(fmt: Format, mv: np.ndarray) -> None:
    """Every MV must keep its 16x16 luma block inside the picture (then the
    halved chroma vector keeps its 8x8 block inside too).  Both parsers
    reject other MVs (H.261 3.2.1); this turns one from elsewhere into a
    clear error instead of an out-of-range gather (an illegal memory
    access on a CUDA device).  mv: (..., nMB, 2) (mvx, mvy)."""
    idx = np.arange(fmt.num_mbs)
    y0 = (idx // fmt.mb_cols) * MB_SIZE
    x0 = (idx % fmt.mb_cols) * MB_SIZE

    def outside(lo, hi):
        return ((y0 + lo[..., 1] < 0)
                | (y0 + hi[..., 1] + MB_SIZE > fmt.height)
                | (x0 + lo[..., 0] < 0)
                | (x0 + hi[..., 0] + MB_SIZE > fmt.width))

    # each MB's extreme vectors over the batch first: one pass
    flat = mv.reshape(-1, fmt.num_mbs, 2)
    if flat.size and outside(flat.min(axis=0), flat.max(axis=0)).any():
        raise ValueError(f"{int(outside(mv, mv).sum())} motion vectors "
                         f"reference outside the {fmt.name} picture")


def _stage_layout(fmt: Format, seqs: Sequence[Mapping[str, np.ndarray]]
                  ) -> Tuple[Dict[str, Tuple[int, int, tuple]], int]:
    """Where each part of a batch lies in the staging buffer: key ->
    (byte offset, bytes, shape), and the buffer's bytes."""
    t, s, m = np.shape(seqs[0]["levels8"])[0], len(seqs), fmt.num_mbs
    nb = nv = 0
    for seq in seqs:
        total = np.asarray(seq["nz_offsets"])[-1]
        if (len(seq["nz_blocks"]), len(seq["nz_levels"])) != tuple(total):
            raise ValueError("packed levels do not add up to their offsets")
        nb, nv = nb + int(total[0]), nv + int(total[1])
    shapes = dict(nz_blocks=(nb,), nz_bases=(t, s, 2), dc=(t, s, m, 6),
                  quant=(t, s, m), intra=(t, s, m), mv=(t, s, m, 2),
                  fil=(t, s, m), nz_mbs=(t, s, m), nz_levels=(nv,))
    layout, at = {}, 0
    for k, (dtype, _) in _STAGE.items():
        size = int(np.prod(shapes[k])) * np.dtype(dtype).itemsize
        layout[k] = (at, size, shapes[k])
        at += -(-size // _ALIGN) * _ALIGN
    return layout, at


def _sections(buf, layout: Mapping[str, Tuple[int, int, tuple]]) -> dict:
    """Views of a uint8 staging buffer as its parts (_stage_layout): numpy
    arrays in the host dtypes for an array, tensors in the device dtypes
    for a tensor."""
    side = int(isinstance(buf, torch.Tensor))
    return {k: buf[at:at + size].view(_STAGE[k][side]).reshape(shape)
            for k, (at, size, shape) in layout.items()}


def ship_packed(fmt: Format, seqs: Sequence[Mapping[str, np.ndarray]],
                device: torch.device | str) -> Dict[str, torch.Tensor]:
    """S equal-length parsed sequences -> their STACKED_KEYS as (T, S, ...)
    tensors on `device`, and their levels packed: the PACKED_KEYS but
    `nz_offsets` (nz_mbs (T, S, nMB), nz_blocks as int64, nz_levels) and
    nz_bases (T, S, 2), each (frame, stream)'s first block mask and first
    level (kernels.levels_cuda).

    Everything is written into one staging buffer (pinned on a CUDA
    device) and copied to the device at once.  levels8 itself is never
    read here, only its shape.  The packed keys must be pack_levels's
    own: the kernel trusts that the masks count the blocks and levels the
    offsets give.  The pinned buffer comes from torch's caching host
    allocator, which hands it out again only after the copy out of it has
    ended."""
    dev = _device(device)
    if not seqs:
        raise ValueError("no streams to decode")
    lengths = {np.shape(s["levels8"])[0] for s in seqs}
    if len(lengths) != 1:
        raise ValueError(f"streams of unequal length {sorted(lengths)} in "
                         "one batch")
    if np.shape(seqs[0]["levels8"])[1] != fmt.num_mbs:
        raise ValueError(f"sequence is not {fmt.name}")
    layout, nbytes = _stage_layout(fmt, seqs)
    buf = torch.empty(nbytes, dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    host = _sections(buf.numpy(), layout)
    for k in STACKED_KEYS + ("nz_mbs",):
        np.stack([s[k] for s in seqs], axis=1, out=host[k])
    _check_mv(fmt, host["mv"])
    for k in ("nz_blocks", "nz_levels"):
        np.concatenate([s[k] for s in seqs], out=host[k])
    np.stack([s["nz_offsets"][:-1] for s in seqs], axis=1,
             out=host["nz_bases"])
    firsts = np.cumsum([s["nz_offsets"][-1] for s in seqs], axis=0)
    host["nz_bases"][:, 1:] += firsts[:-1]
    trace.count_copy(buf, dev, nbytes)
    return _sections(buf.to(dev, non_blocking=True), layout)


def stack_seqs(fmt: Format, seqs: Sequence[Mapping[str, np.ndarray]],
               device: torch.device | str) -> Dict[str, torch.Tensor]:
    """S equal-length parsed sequences -> their SEQ_KEYS as (T, S, ...)
    tensors on `device`: the levels cross packed (ship_packed), and
    `kernels.levels_cuda.expand_levels` makes the dense levels8 there, one
    launch on a CUDA device."""
    with trace.span("p64.decode.stack"):
        parts = ship_packed(fmt, seqs, device)
        batch = {k: parts[k] for k in STACKED_KEYS}
        batch["levels8"] = expand_levels(parts["nz_mbs"], parts["nz_blocks"],
                                         parts["nz_levels"],
                                         parts["nz_bases"])
        trace.count("p64.decode.packed_mbs", parts["nz_mbs"].numel())
        return {k: batch[k] for k in SEQ_KEYS}


def _init_planes(fmt: Format, batch: Mapping[str, torch.Tensor],
                 init: Optional[Tuple[torch.Tensor, ...]]):
    s, dev = batch["levels8"].shape[1], batch["levels8"].device
    if init is not None:
        return tuple(init)
    luma, chroma = (fmt.height, fmt.width), (fmt.chroma_height,
                                             fmt.chroma_width)
    return tuple(torch.zeros((s, *hw), dtype=torch.uint8, device=dev)
                 for hw in (luma, chroma, chroma))


def _reconstruct_step(fmt: Format, planes: Mapping[str, torch.Tensor],
                      fr: Mapping[str, torch.Tensor]):
    """One frame of every stream: (new planes, the same planes as output).
    Levels travel at half width: int8 zigzag levels plus a uint8 intra-DC
    sidecar; slot 0 of an intra block is 0 in levels8 and the sidecar is 0
    everywhere else, so one add reassembles them."""
    levels = fr["levels8"].to(torch.int32)
    levels[..., 0] += fr["dc"].to(torch.int32)
    y, cb, cr = reconstruct_frame(
        fmt, levels, fr["quant"], fr["intra"], fr["mv"], fr["fil"],
        planes["y"], planes["cb"], planes["cr"])
    new = dict(y=y, cb=cb, cr=cr)
    return new, new


def reconstruct_seq(fmt: Format, batch: Mapping[str, torch.Tensor],
                    init: Optional[Tuple[torch.Tensor, ...]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reconstruct a stacked batch (stack_seqs) on its device.

    init: (y, cb, cr) reference planes (S, H, W) / (S, H/2, W/2) uint8 on
    the batch's device, zeros when None.  Returns (y, cb, cr) uint8
    (S, T, ...) tensors on the device.  On a CUDA device the reconstruct
    step is a captured graph, replayed per frame (reconstruct_seq_graphed);
    on the CPU, reconstruct_seq_eager."""
    if batch["levels8"].is_cuda:
        return reconstruct_seq_graphed(fmt, batch, init)
    return reconstruct_seq_eager(fmt, batch, init)


def reconstruct_seq_graphed(fmt: Format, batch: Mapping[str, torch.Tensor],
                            init: Optional[Tuple[torch.Tensor, ...]] = None,
                            cache: graphs.ProgramCache = graphs.PROGRAMS
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """reconstruct_seq through `core.graphs`: one program per (fmt, S,
    device), replayed once per frame.  On the CPU the program runs with
    capture off (the tests hold that bookkeeping to
    reconstruct_seq_eager)."""
    s, dev = batch["levels8"].shape[1], batch["levels8"].device
    y, cb, cr = _init_planes(fmt, batch, init)
    _, out = graphs.run(("decode", fmt, s, dev),
                        functools.partial(_reconstruct_step, fmt),
                        dict(y=y, cb=cb, cr=cr),
                        {k: batch[k] for k in SEQ_KEYS}, axis=0,
                        cache=cache)
    return out["y"], out["cb"], out["cr"]


def reconstruct_seq_eager(fmt: Format, batch: Mapping[str, torch.Tensor],
                          init: Optional[Tuple[torch.Tensor, ...]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """reconstruct_seq as a host loop that launches every frame's
    operations from Python: the plain version the graphs are held to."""
    t, s = batch["levels8"].shape[:2]
    dev = batch["levels8"].device
    luma, chroma = (fmt.height, fmt.width), (fmt.chroma_height,
                                             fmt.chroma_width)
    planes = dict(zip(("y", "cb", "cr"), _init_planes(fmt, batch, init)))
    out = tuple(torch.empty((s, t, *hw), dtype=torch.uint8, device=dev)
                for hw in (luma, chroma, chroma))
    for i in range(t):
        planes, _ = _reconstruct_step(fmt, planes,
                                      {k: batch[k][i] for k in SEQ_KEYS})
        for o, k in zip(out, ("y", "cb", "cr")):
            o[:, i] = planes[k]
    return out


def decode_seq_batch(fmt: Format, seqs: Sequence[Mapping[str, np.ndarray]],
                     *, device: torch.device | str) -> List[Planes]:
    """Reconstruct many equal-length streams in one batch on `device`.

    seqs: parse_to_tensors seq dicts, all of format fmt and of one frame
    count.  Returns, per stream, (y, cb, cr) uint8 (T, ...) arrays.

    On a CUDA device the arrays are views of three pinned blocks (one per
    plane, each (S, T, ...)) from torch's caching host allocator, filled
    by one non_blocking copy each on the current stream.  The allocator
    hands a block out again only once every tensor on it is freed, and an
    array holds its tensor as its base, so a returned array never views a
    block a later call writes; and a caller that keeps one stream's planes
    keeps the whole batch's blocks.  The blocks are taken while the
    replays run, so pinning a fresh one (a first call, or one whose
    earlier blocks are all still held) overlaps the card's work.  On the
    CPU the arrays view the reconstructed planes themselves.

    Spans (trace): the stack (stack_seqs), the replays (core.graphs), then
    `p64.decode.wait` for the card to finish them and
    `p64.decode.planes_out` for the copy of the planes to host memory."""
    batch = stack_seqs(fmt, seqs, device)
    trace.count("p64.decode.macroblocks",
                batch["levels8"].shape[0] * len(seqs) * fmt.num_mbs)
    planes = reconstruct_seq(fmt, batch)
    on_card = planes[0].is_cuda
    host = (tuple(torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                  for p in planes) if on_card else planes)
    with trace.span("p64.decode.wait"):
        if on_card:
            torch.cuda.current_stream(planes[0].device).synchronize()
    with trace.span("p64.decode.planes_out"):
        if on_card:
            for h, p in zip(host, planes):
                trace.count_copy(p, h, p.nbytes)
                h.copy_(p, non_blocking=True)
            torch.cuda.current_stream(planes[0].device).synchronize()
        y, cb, cr = (h.numpy() for h in host)
    return [(y[i], cb[i], cr[i]) for i in range(len(seqs))]


def decode_seq(fmt: Format, seq: Mapping[str, np.ndarray], *,
               device: torch.device | str) -> Planes:
    """Reconstruct planes from one parse_to_tensors seq dict (a batch of
    one).  Returns uint8 (T, ...) arrays."""
    return decode_seq_batch(fmt, [seq], device=device)[0]


def split_levels(levels: np.ndarray, intra_mb: np.ndarray):
    """(T, nMB, 6, 64) int16 levels -> (levels8 int8, dc uint8) halves.

    Host-side mirror of the C++ parser's direct int8 output, for the
    ParsedFrame paths.  intra_mb: (T, nMB) bool (intra & coded).

    Slot 0 rides the uint8 sidecar where the MB is intra and slot 0 is not
    negative, or where slot 0 exceeds 127.  A resync parse can keep a
    partially decoded intra MB whose DC (128..254) landed in slot 0 with
    coded=False, which would wrap in the int8 cast; and a damaged re-parse
    can write a negative inter coefficient into slot 0 of an MB whose
    intra and coded flags stay set, which would wrap in the uint8 cast
    (the reference's mask sends it there, and its ParsedFrame decode path
    then diverges from its native path).  Every other slot 0 value is
    int8-safe; device reassembly adds the two halves, so either placement
    of a value in 0..127 gives the same level."""
    slot0 = levels[..., 0]
    to_dc = (intra_mb[..., None] & (slot0 >= 0)) | (slot0 > 127)
    dc = np.where(to_dc, slot0, 0).astype(np.uint8)
    levels8 = levels.copy()
    levels8[..., 0] = np.where(to_dc, 0, slot0)
    return levels8.astype(np.int8), dc


def frames_to_tensors(frames: Sequence[ParsedFrame]) -> Dict[str, np.ndarray]:
    """Stack parsed frames into the (T, ...) seq dict parse_to_tensors
    gives (same keys and dtypes, the packed levels from the same
    native entry)."""
    intra = np.stack([f.intra & f.coded for f in frames])
    levels8, dc = split_levels(np.stack([f.levels for f in frames]), intra)
    return dict(
        levels8=levels8,
        dc=dc,
        quant=np.stack([f.quant for f in frames]).astype(np.int32),
        intra=intra,
        mv=np.stack([f.mv for f in frames]).astype(np.int32),
        fil=np.stack([f.fil & f.coded for f in frames]),
        **load().pack_levels(levels8),
    )


def decode_frames(frames: Sequence[ParsedFrame], init=None, *,
                  device: torch.device | str) -> Planes:
    """Reconstruct planes for already-parsed frames (single format).

    init: optional (y, cb, cr) reference planes, (H, W) and (H/2, W/2)
    uint8 as numpy arrays or tensors -- a decode can resume from planes
    another decoder (the JAX package's, for one) produced.  Returns
    (y (T, H, W), cb, cr) uint8 arrays."""
    if not frames:
        raise ValueError("no frames")
    fmt = frames[0].fmt
    if any(f.fmt is not fmt for f in frames):
        raise ValueError("mixed picture formats in one sequence")
    batch = stack_seqs(fmt, [frames_to_tensors(frames)], device)
    trace.count("p64.decode.macroblocks", len(frames) * fmt.num_mbs)
    if init is not None:
        dev = batch["levels8"].device
        shapes = ((fmt.height, fmt.width),
                  (fmt.chroma_height, fmt.chroma_width),
                  (fmt.chroma_height, fmt.chroma_width))
        init = tuple((p if isinstance(p, torch.Tensor)
                      else torch.from_numpy(np.array(p))).to(dev)
                     for p in init)
        if tuple(tuple(p.shape) for p in init) != shapes or any(
                p.dtype != torch.uint8 for p in init):
            raise ValueError(f"init planes must be uint8 {shapes}")
        init = tuple(p[None].contiguous() for p in init)
    y, cb, cr = (p[0].cpu().numpy()
                 for p in reconstruct_seq(fmt, batch, init))
    return y, cb, cr


def parse_any(data: bytes, resync: bool = False) -> List[ParsedFrame]:
    """Parse with the C++ engine into ParsedFrames.

    resync=True enables start-code error recovery: damaged GOBs keep
    their already-decoded MBs, the rest reconstruct as copy-from-reference
    (see entropy.parse.parse_stream(strict=False))."""
    return load().parse(data, resync=resync)


def parse_to_tensors(data: bytes, resync: bool = False):
    """Parse one single-format stream straight to the stacked (T, ...)
    arrays decode_seq consumes, with no per-frame ParsedFrame objects
    (see native.binding.NativeBitIO.parse_tensors).

    Returns (fmt, tr (T,) np.ndarray, seq dict)."""
    return load().parse_tensors(data, resync=resync)


def parse_many(datas: Sequence[bytes]) -> List[List[ParsedFrame]]:
    """Parse multiple independent streams, fanned across a thread pool
    (the ctypes C++ parse releases the GIL)."""
    load()  # build/load once before fanning out
    return fan_map(parse_any, datas)


def decode_stream(data: bytes, resync: bool = False, *,
                  device: torch.device | str
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             List[ParsedFrame]]:
    """bytes -> (y, cb, cr) uint8 arrays (T, ...) + the parsed symbol view."""
    frames = parse_any(data, resync=resync)
    y, cb, cr = decode_frames(frames, device=device)
    return y, cb, cr, frames
