"""H.261 decoder: host VLC parse -> batched reconstruction on the device.

Port of `p64tpu/core/decoder.py`.  The bit-serial parse runs on the host in
the C++ engine (`native.binding`), producing dense per-frame symbol arrays;
everything numeric (dequantize, IDCT, MC, loop filter, add, clip) runs on
the device through the SAME `core.reconstruct.reconstruct_frame` the
encoder uses for its local decode -- so encoder reconstruction and decoder
output are identical by construction.

Batch-first, like the rest of the port: `decode_seq_batch` stacks S
equal-length parsed streams on the host, copies them to the device once,
and runs the T frames (the reference's `lax.scan` under `vmap`) carrying
the (S, H, W) planes: on a CUDA device as one captured reconstruct step
replayed per frame (core.graphs, the counterpart of the reference's
jitted `_decode_scan`), on the CPU as a host loop.  The planes stay on the
device until one copy back at the end.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..spec.constants import MB_SIZE, Format
from ..entropy.parse import ParsedFrame
from ..native import load
from ..utils import fan_map
from . import graphs
from .reconstruct import reconstruct_frame

#: keys of a parsed sequence dict (parse_to_tensors, frames_to_tensors)
SEQ_KEYS = ("levels8", "dc", "quant", "intra", "mv", "fil")

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
    y = y0 + mv[..., 1]
    x = x0 + mv[..., 0]
    bad = ((y < 0) | (y + MB_SIZE > fmt.height)
           | (x < 0) | (x + MB_SIZE > fmt.width))
    if bad.any():
        raise ValueError(f"{int(bad.sum())} motion vectors reference "
                         f"outside the {fmt.name} picture")


def stack_seqs(fmt: Format, seqs: Sequence[Mapping[str, np.ndarray]],
               device: torch.device | str) -> Dict[str, torch.Tensor]:
    """S equal-length parsed sequences -> (T, S, ...) tensors on `device`:
    stacked on the host (the parser's strided int8 views become one
    contiguous array per key), then copied to the device once."""
    dev = _device(device)
    if not seqs:
        raise ValueError("no streams to decode")
    lengths = {np.shape(s["levels8"])[0] for s in seqs}
    if len(lengths) != 1:
        raise ValueError(f"streams of unequal length {sorted(lengths)} in "
                         "one batch")
    if np.shape(seqs[0]["levels8"])[1] != fmt.num_mbs:
        raise ValueError(f"sequence is not {fmt.name}")
    with trace.span("p64.decode.stack"):
        host = {k: np.stack([np.asarray(s[k]) for s in seqs], axis=1)
                for k in SEQ_KEYS}
        _check_mv(fmt, host["mv"])
        for v in host.values():
            trace.count_copy(v, dev, v.nbytes)
        return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


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

    Spans (trace): the stack (stack_seqs), the replays (core.graphs), then
    `p64.decode.wait` for the card to finish them and
    `p64.decode.planes_out` for the copy of the planes to host memory."""
    batch = stack_seqs(fmt, seqs, device)
    trace.count("p64.decode.macroblocks",
                batch["levels8"].shape[0] * len(seqs) * fmt.num_mbs)
    planes = reconstruct_seq(fmt, batch)
    with trace.span("p64.decode.wait"):
        if planes[0].is_cuda:
            torch.cuda.current_stream(planes[0].device).synchronize()
    with trace.span("p64.decode.planes_out"):
        for p in planes:
            trace.count_copy(p, torch.device("cpu"), p.nbytes)
        y, cb, cr = (p.cpu().numpy() for p in planes)
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
    gives (same keys and dtypes)."""
    intra = np.stack([f.intra & f.coded for f in frames])
    levels8, dc = split_levels(np.stack([f.levels for f in frames]), intra)
    return dict(
        levels8=levels8,
        dc=dc,
        quant=np.stack([f.quant for f in frames]).astype(np.int32),
        intra=intra,
        mv=np.stack([f.mv for f in frames]).astype(np.int32),
        fil=np.stack([f.fil & f.coded for f in frames]),
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
