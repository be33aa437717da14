"""Reference playback of streams that a channel may have damaged: each
stream parsed by `parse.parse_resync`, its pictures reconstructed through
`reconstruct.reconstruct_frame`, every picture the parse kept output.

An MB is reconstructed from what its picture's record holds (`parse`):
intra where it is coded and intra, with its loop filter where it is coded
and filtered, and with its record's vector, coefficients and quantizer
whether coded or not.  An MB that no GOB reached is a copy of the
reference picture; an MB whose parse failed keeps the vector and the
coefficients it wrote before the damage, and is reconstructed with them.
The first picture predicts from zero planes."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .constants import Format
from .parse import Picture, parse_resync, refusal
from .reconstruct import reconstruct_frame

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


def parse_streams(datas: Sequence[bytes]
                  ) -> List[Optional[List[Picture]]]:
    """Each stream's pictures, or None where a decoder has no answer for
    it (`parse.refusal`)."""
    out: List[Optional[List[Picture]]] = []
    for data in datas:
        pictures = parse_resync(data)
        out.append(None if refusal(pictures) else pictures)
    return out


def reconstruct_pictures(fmt: Format, streams: Sequence[List[Picture]],
                         device: torch.device) -> List[Planes]:
    """(y, cb, cr) uint8 (T, ...) host arrays of S streams of T pictures
    each, all of `fmt`, reconstructed together on `device`."""
    s, t = len(streams), len(streams[0])
    chroma = (fmt.chroma_height, fmt.chroma_width)
    planes = (torch.zeros((s, fmt.height, fmt.width), dtype=torch.uint8,
                          device=device),
              torch.zeros((s, *chroma), dtype=torch.uint8, device=device),
              torch.zeros((s, *chroma), dtype=torch.uint8, device=device))
    out = [np.empty((s, t, *p.shape[1:]), np.uint8) for p in planes]

    def stacked(field: str, i: int) -> torch.Tensor:
        return torch.from_numpy(np.stack(
            [getattr(pics[i], field) for pics in streams])).to(device)
    for i in range(t):
        levels = torch.from_numpy(np.stack(
            [pics[i].dense_levels() for pics in streams])).to(device)
        coded = stacked("coded", i)
        planes = reconstruct_frame(
            fmt, levels.to(torch.int32), stacked("quant", i),
            stacked("intra", i) & coded, stacked("mv", i),
            stacked("fil", i) & coded, *planes)
        for o, p in zip(out, planes):
            o[:, i] = p.cpu().numpy()
    return [(out[0][j], out[1][j], out[2][j]) for j in range(s)]


def play(parsed: Sequence[Optional[List[Picture]]], device: torch.device,
         streams_at_once: int) -> List[Optional[Planes]]:
    """Each stream's planes, or None where `parsed` holds none; streams of
    one format and picture count are reconstructed together,
    `streams_at_once` at a time."""
    groups: Dict[tuple, List[int]] = {}
    for i, pics in enumerate(parsed):
        if pics is not None:
            groups.setdefault((pics[0].fmt.name, len(pics)), []).append(i)
    out: List[Optional[Planes]] = [None] * len(parsed)
    for idxs in groups.values():
        fmt = parsed[idxs[0]][0].fmt
        for b in range(0, len(idxs), streams_at_once):
            part = idxs[b:b + streams_at_once]
            for i, planes in zip(part, reconstruct_pictures(
                    fmt, [parsed[i] for i in part], device)):
                out[i] = planes
    return out
