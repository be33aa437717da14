"""Reference decode from symbols: the planes a decoder must output for the
encoder's symbols, frame by frame through `reconstruct.reconstruct_frame`.

The benchmark's decode answer is the encoder's own reconstruction
(`encoder.encode_sequence`'s RECON_KEYS); this loop rebuilds it from the
symbols alone, as a decoder does after its parse, so that the control can
run it at a lower precision (`dct.precision`)."""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from . import luts
from .constants import Format
from .reconstruct import reconstruct_frame
from .util import device_const


def reconstruct_sequence(fmt: Format, outputs: Mapping[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(S, T, ...) encoder outputs -> (y, cb, cr) uint8 (S, T, ...) planes;
    a frame a stream skipped repeats its reference planes."""
    s, t = outputs["coded"].shape[:2]
    dev = outputs["coded"].device
    chroma = (fmt.chroma_height, fmt.chroma_width)
    planes = (torch.zeros((s, fmt.height, fmt.width), dtype=torch.uint8,
                          device=dev),
              torch.zeros((s, *chroma), dtype=torch.uint8, device=dev),
              torch.zeros((s, *chroma), dtype=torch.uint8, device=dev))
    out = tuple(torch.empty((s, t, *p.shape[1:]), dtype=torch.uint8,
                            device=dev) for p in planes)
    is_intra = device_const(luts.MTYPE_INTRA, dev)
    is_fil = device_const(luts.MTYPE_FIL, dev)
    for i in range(t):
        coded = outputs["coded"][:, i]
        mtype = outputs["mtype"][:, i].long()
        new = reconstruct_frame(
            fmt, outputs["levels"][:, i].to(torch.int32),
            outputs["quant_mb"][:, i], is_intra[mtype] & coded,
            outputs["mv"][:, i], is_fil[mtype] & coded, *planes)
        keep = outputs["frame_coded"][:, i].view(-1, 1, 1)
        planes = tuple(torch.where(keep, n, p) for n, p in zip(new, planes))
        for o, p in zip(out, planes):
            o[:, i] = p
    return out
