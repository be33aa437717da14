"""Frame I/O: raw planar YUV 4:2:0 files, PVRG per-frame .Y/.U/.V triples,
and YUV4MPEG2 (.y4m) containers.

The port's copy of `p64tpu.io.yuv`.  PVRG reads one file per frame per
component with a `<prefix><n>.<suffix>` naming convention; here whole
sequences load into (T, H, W) uint8 arrays up front (one copy to the
device, not one per MB), beside the two modern container formats.
"""

from __future__ import annotations

import os

from typing import Dict, Optional, Tuple

import numpy as np

from ..spec.constants import FORMATS, Format, format_for_size


def frame_nbytes(fmt: Format) -> int:
    return fmt.width * fmt.height * 3 // 2


def _split_frames(raw: np.ndarray, fmt: Format) -> Dict[str, np.ndarray]:
    n = frame_nbytes(fmt)
    t = raw.size // n
    raw = raw[: t * n].reshape(t, n)
    ysz = fmt.width * fmt.height
    csz = ysz // 4
    y = raw[:, :ysz].reshape(t, fmt.height, fmt.width)
    cb = raw[:, ysz:ysz + csz].reshape(t, fmt.chroma_height, fmt.chroma_width)
    cr = raw[:, ysz + csz:].reshape(t, fmt.chroma_height, fmt.chroma_width)
    return dict(y=y, cb=cb, cr=cr)


def read_raw(path: str, fmt: Format,
             max_frames: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Concatenated planar I420 file -> dict of (T,...) uint8 arrays."""
    count = -1 if max_frames is None else max_frames * frame_nbytes(fmt)
    raw = np.fromfile(path, dtype=np.uint8, count=count)
    frames = _split_frames(raw, fmt)
    if max_frames is not None:
        frames = {k: v[:max_frames] for k, v in frames.items()}
    return frames


def write_raw(path: str, frames: Dict[str, np.ndarray]) -> None:
    t = frames["y"].shape[0]
    with open(path, "wb") as f:
        for i in range(t):
            f.write(np.ascontiguousarray(frames["y"][i]).tobytes())
            f.write(np.ascontiguousarray(frames["cb"][i]).tobytes())
            f.write(np.ascontiguousarray(frames["cr"][i]).tobytes())


# ---------------------------------------------------------------------------
# PVRG-style per-frame component files: <prefix><n>.Y / .U / .V
# ---------------------------------------------------------------------------


def read_pvrg(prefix: str, fmt: Format, first: int,
              last: int) -> Dict[str, np.ndarray]:
    ys, cbs, crs = [], [], []
    for n in range(first, last + 1):
        y = np.fromfile(f"{prefix}{n}.Y", dtype=np.uint8)
        u = np.fromfile(f"{prefix}{n}.U", dtype=np.uint8)
        v = np.fromfile(f"{prefix}{n}.V", dtype=np.uint8)
        ys.append(y.reshape(fmt.height, fmt.width))
        cbs.append(u.reshape(fmt.chroma_height, fmt.chroma_width))
        crs.append(v.reshape(fmt.chroma_height, fmt.chroma_width))
    return dict(y=np.stack(ys), cb=np.stack(cbs), cr=np.stack(crs))


def write_pvrg(prefix: str, frames: Dict[str, np.ndarray],
               first: int = 0) -> None:
    for i in range(frames["y"].shape[0]):
        frames["y"][i].tofile(f"{prefix}{first + i}.Y")
        frames["cb"][i].tofile(f"{prefix}{first + i}.U")
        frames["cr"][i].tofile(f"{prefix}{first + i}.V")


# ---------------------------------------------------------------------------
# YUV4MPEG2
# ---------------------------------------------------------------------------

_Y4M_MAGIC = b"YUV4MPEG2"


def read_y4m(path: str,
             max_frames: Optional[int] = None
             ) -> Tuple[Dict[str, np.ndarray], Format]:
    with open(path, "rb") as f:
        header = f.readline()
        if not header.startswith(_Y4M_MAGIC):
            raise ValueError(f"{path}: not a YUV4MPEG2 file")
        w = h = None
        for tok in header.split()[1:]:
            if tok.startswith(b"W"):
                w = int(tok[1:])
            elif tok.startswith(b"H"):
                h = int(tok[1:])
            elif tok.startswith(b"C") and tok not in (
                    b"C420", b"C420jpeg", b"C420paldv", b"C420mpeg2"):
                # NOTE: a bare startswith(C420) would also accept the
                # 10/12-bit tags (C420p10, ...) and misparse 16-bit
                # samples as 8-bit pixels
                raise ValueError(f"{path}: only 8-bit 4:2:0 y4m supported, "
                                 f"got {tok!r}")
        if w is None or h is None:
            raise ValueError(f"{path}: missing W/H in y4m header")
        fmt = format_for_size(w, h)
        n = frame_nbytes(fmt)
        ys, cbs, crs = [], [], []
        while max_frames is None or len(ys) < max_frames:
            fh = f.readline()
            if not fh:
                break
            if not fh.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad frame header {fh!r}")
            buf = f.read(n)
            if len(buf) < n:
                break
            fr = _split_frames(np.frombuffer(buf, np.uint8), fmt)
            ys.append(fr["y"][0])
            cbs.append(fr["cb"][0])
            crs.append(fr["cr"][0])
    if not ys:
        raise ValueError(f"{path}: no frames after the y4m header")
    return dict(y=np.stack(ys), cb=np.stack(cbs), cr=np.stack(crs)), fmt


def write_y4m(path: str, frames: Dict[str, np.ndarray],
              fps: Tuple[int, int] = (30000, 1001)) -> None:
    t, h, w = frames["y"].shape
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420\n"
                % (w, h, fps[0], fps[1]))
        for i in range(t):
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(frames["y"][i]).tobytes())
            f.write(np.ascontiguousarray(frames["cb"][i]).tobytes())
            f.write(np.ascontiguousarray(frames["cr"][i]).tobytes())


def load_input(path: str, fmt: Optional[Format] = None,
               first: int = 0, last: Optional[int] = None
               ) -> Tuple[Dict[str, np.ndarray], Format]:
    """Auto-detecting loader: .y4m, raw .yuv/.i420 (needs fmt), or a PVRG
    prefix (needs fmt).  Applies the [first, last] frame range."""
    stop = None if last is None else last + 1
    if path.endswith(".y4m"):
        want = fmt
        frames, fmt = read_y4m(path, max_frames=stop)
        if want is not None and want is not fmt:
            raise ValueError(
                f"{path} is {fmt.name} ({fmt.width}x{fmt.height}) but "
                f"-x {want.name} was requested -- remove -x or fix the "
                f"input")
    elif os.path.exists(path):
        if fmt is None:
            raise ValueError("raw YUV input needs an explicit format "
                             "(CIF/QCIF)")
        frames = read_raw(path, fmt, max_frames=stop)
    else:
        if path.endswith((".yuv", ".i420", ".raw", ".y4m")):
            raise FileNotFoundError(f"input file not found: {path}")
        if not os.path.exists(f"{path}{first}.Y"):
            raise FileNotFoundError(
                f"no such input: {path} (not a file, and no PVRG frame "
                f"{path}{first}.Y either)")
        if fmt is None:
            raise ValueError("PVRG prefix input needs an explicit format "
                             "(-x CIF|QCIF)")
        if last is None:
            last = first
            while os.path.exists(f"{path}{last + 1}.Y"):
                last += 1
        frames = read_pvrg(path, fmt, first, last)
        return frames, fmt
    frames = {k: v[first:stop] for k, v in frames.items()}
    return frames, fmt


def parse_format(name: str) -> Format:
    try:
        return FORMATS[name.upper()]
    except KeyError:
        raise ValueError(f"unknown format {name!r} (CIF or QCIF)") from None


