"""The benchmark's seeded content: CIF or QCIF frames with real motion.

A copy of the port's bench content (`tools/bench.py::make_content`): a
48x48 block, 50 brighter, moving over a diagonal gradient, with uniform
texture noise 0..noise-1 on every pixel, and chroma derived from luma.
The seed draws the noise and where each stream's block starts; every seed
gives the same sizes and the same motion per frame.  The frames are made
on the device in a few large calls, with a generator seeded there.
"""

from __future__ import annotations

from typing import Dict

import torch


def make_content(height: int, width: int, streams: int, frames: int,
                 noise: int, seed: int,
                 device: torch.device | str) -> Dict[str, torch.Tensor]:
    """uint8 planes y (S, T, H, W), cb and cr (S, T, H/2, W/2) on
    `device`; the same seed and device give the same planes."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 63))
    off = torch.randint(0, 1 << 16, (2,), generator=gen, device=dev)
    yy = torch.arange(height, device=dev)[:, None]
    xx = torch.arange(width, device=dev)[None, :]
    base = (16 + (xx * 3 + yy * 2) // 8) % 200                 # (H, W)
    s = torch.arange(streams, device=dev)[:, None]
    t = torch.arange(frames, device=dev)[None, :]
    x0 = ((10 + 7 * t + 13 * s + off[0]) % (width - 48))[..., None, None]
    y0 = ((20 + 5 * t + 7 * s + off[1]) % (height - 48))[..., None, None]
    block = ((yy >= y0) & (yy < y0 + 48) & (xx >= x0) & (xx < x0 + 48))
    y = torch.randint(0, noise, (streams, frames, height, width),
                      generator=gen, device=dev, dtype=torch.int16)
    y += base.to(torch.int16)
    y += 50 * block.to(torch.int16)
    y = y.clamp_(0, 255).to(torch.uint8)
    cb = (y[:, :, ::2, ::2] // 2 + 64).to(torch.uint8)
    cr = (255 - y[:, :, 1::2, ::2] // 2).to(torch.uint8)
    return dict(y=y, cb=cb.contiguous(), cr=cr.contiguous())
