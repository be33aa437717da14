"""The port's bench content: the JAX package's `bench.py` content, bit for
bit (`make_content`), and the decode content mix encoded from it
(`make_decode_content`).  The tests and `chip_smoke.py` build their
frames here; the benchmark (`port_bench/`) has a seeded copy of its own.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from ..control.ratecontrol import RateConfig
from ..core import encoder as enc
from ..spec.constants import CIF, Format
from ..spec.luts import MTYPE_MQUANT

#: the motion search range of the decode content's encodes
SEARCH = 15


def make_content(fmt: Format, streams: int, frames_t: int,
                 noise: int = 5) -> Dict[str, np.ndarray]:
    """The benchmark's deterministic content with real motion, as uint8
    numpy planes y (S, T, H, W), cb and cr (S, T, H/2, W/2).  One
    generator, streams outer and frames inner: only equal (streams,
    frames_t) give equal planes, and stream 0's first frames are the same
    at every shape.  `noise` is the per-pixel texture amplitude: 5 for the
    encode configurations, 40 for the decode content's rate-controlled
    groups, so their bit targets bind on content and not on stuffing."""
    rng = np.random.default_rng(0)
    h, w = fmt.height, fmt.width
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((16 + (xx * 3 + yy * 2) // 8) % 200).astype(np.int32)
    ys = np.empty((streams, frames_t, h, w), np.uint8)
    for s in range(streams):
        for t in range(frames_t):
            b = base.copy()
            x0 = (10 + 7 * t + 13 * s) % (w - 48)
            y0 = (20 + 5 * t + 7 * s) % (h - 48)
            b[y0:y0 + 48, x0:x0 + 48] += 50
            ys[s, t] = np.clip(b + rng.integers(0, noise, (h, w)), 0, 255)
    return dict(y=ys, cb=(ys[:, :, ::2, ::2] // 2 + 64).astype(np.uint8),
                cr=(255 - ys[:, :, 1::2, ::2] // 2).astype(np.uint8))


def make_decode_content(streams: int, frames_t: int, quant: int, *,
                        device: torch.device | str):
    """Mixed compliant CIF streams, the JAX decode benchmark's mix, encoded
    on `device` and serialized by the port's native serializer:

      * half: fixed quantizer, texture noise 5;
      * one in 16: 4 Mbit/s rate control, noise 40 -- MBA stuffing fill on
        nearly every frame;
      * the rest: 2 Mbit/s with 3 mid-GOB MQUANT segments and initial
        quantizer 12, noise 40.

    Every frame must be coded and the mix must hold stuffing and MQUANT
    MBs, so a parse of them meets both.  Returns (stream bytes, stuffing
    codes, MQUANT MBs, recon) with recon the encoder's reconstruction
    (y, cb, cr) as (S, T, ...) tensors on `device`."""
    if streams < 4:
        raise ValueError(
            f"decode bench needs >= 4 streams for the fixed-q/stuffing/"
            f"MQUANT mix, got {streams}")
    dev = torch.device(device)
    n_a = streams // 2
    # one stuffing-stress stream per 16: more would let stuffing dominate
    # the byte mix
    n_b = max(1, streams // 16)
    groups = (
        (n_a, RateConfig(fixed_quant=quant), 5),
        (n_b, RateConfig(bit_rate=4_000_000, frame_rate=30), 40),
        (streams - n_a - n_b,
         RateConfig(bit_rate=2_000_000, frame_rate=30, mquant_segments=3,
                    initial_quant=12), 40),
    )
    mq_types = torch.as_tensor(np.flatnonzero(MTYPE_MQUANT), device=dev)
    datas: List[bytes] = []
    recons = []
    n_stuff = n_mq = 0
    for n, rate, noise in groups:
        if n == 0:
            continue
        cfg = enc.EncoderConfig(fmt=CIF, search=SEARCH, rate=rate)
        data, outputs, _ = enc.encode_to_bytes(
            cfg, make_content(CIF, n, frames_t, noise), device=dev)
        if not bool(outputs["frame_coded"].all()):
            raise RuntimeError("decode-bench content group skipped frames; "
                               f"retune rates (rate={rate})")
        n_stuff += int(outputs["n_stuff"].sum())
        n_mq += int(torch.isin(outputs["mtype"], mq_types).sum())
        datas.extend(data)
        recons.append([outputs[k] for k in enc.RECON_KEYS])
    if n_stuff == 0:
        raise RuntimeError("mix contains no MBA stuffing; retune group B rate")
    if n_mq == 0:
        raise RuntimeError("mix contains no MQUANT MBs; retune group C rate")
    print(f"decode content: {len(datas)} streams, {n_stuff} stuffing codes, "
          f"{n_mq} MQUANT MBs", file=sys.stderr, flush=True)
    return datas, n_stuff, n_mq, tuple(torch.cat(p) for p in zip(*recons))
