"""A single-device compile check and a multi-device dry run of the
production-shape encode.

Counterpart of the repository's `__graft_entry__.py`, which does both for
the JAX package:

  entry()             -> (fn, example_args): one encoder frame step
                         (`core.encoder.encode_frame_step`: motion search,
                         decisions, DCT, rate control, reconstruction) on
                         QCIF at search 15 under rate control at 256,000
                         bit/s, with a batch-first state of one stream and
                         zero frames; compile_check(fn, args) builds it as
                         one captured program on a card and replays it once
  dryrun_multichip(n) -> the production-shape encode (QCIF, search 15, two
                         frames, 128,000 bit/s with three MQUANT segments
                         and minimum-rate fill) of n streams over an
                         n-shard stream mesh (`distrib.mesh`), the host
                         finalize held to the device bit model per stream

    python -m p64tpu_torch.tools.dryrun [n] [--device cuda|cpu]

runs the dry run (n = 8 by default) on n logical shards of the visible
cards (distinct cards first, then repeats), or of the CPU with
`--device cpu`, and prints one line, then the card's name and power limit
when it ran on a card.  Without a card and without `--device cpu` it
raises: it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..control.ratecontrol import RateConfig
from ..core import encoder as enc
from ..core import graphs
from ..distrib import mesh as dm
from ..spec.constants import QCIF
from ..utils import card_line

#: frames of the dry run: two, so that the inter path (search, MC and the
#: reconstruction carried as the reference) runs
T = 2


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def entry(device=None) -> Tuple[Callable, Tuple[enc.State,
                                                Dict[str, torch.Tensor]]]:
    """(fn, (state, frame)) for a single-device compile check: fn(state,
    frame) -> (new state, outputs) is encode_frame_step on QCIF, search 15,
    rate control at 256,000 bit/s; the state is init_state's for one
    stream and the frame is zeros, both on `device` (default cuda)."""
    dev = _device(device)
    cfg = enc.EncoderConfig(fmt=QCIF, search=15,
                            rate=RateConfig(bit_rate=256_000, frame_rate=30))

    def fn(state, frame):
        return enc.encode_frame_step(cfg, state, frame["y"], frame["cb"],
                                     frame["cr"])

    chroma = (1, QCIF.chroma_height, QCIF.chroma_width)
    frame = dict(
        y=torch.zeros((1, QCIF.height, QCIF.width), dtype=torch.uint8,
                      device=dev),
        cb=torch.zeros(chroma, dtype=torch.uint8, device=dev),
        cr=torch.zeros(chroma, dtype=torch.uint8, device=dev))
    return fn, (enc.init_state(cfg, 1, dev), frame)


def compile_check(fn: Callable, args) -> Tuple[enc.State,
                                                Dict[str, torch.Tensor]]:
    """On a card: build `fn` over `args` as one captured program
    (`core.graphs.Program`) in a cache of its own, which evicts nothing
    from `graphs.PROGRAMS`, and replay it once.  On the CPU: fn(*args).
    Returns (new state, outputs) as fn does."""
    state, frame = args
    if frame["y"].device.type != "cuda":
        return fn(state, frame)
    new_state, out = graphs.run(
        "entry", fn, state, {k: v[:, None] for k, v in frame.items()},
        axis=1, cache=graphs.ProgramCache(1))
    return new_state, {k: v[:, 0] for k, v in out.items()}


def dryrun_config() -> enc.EncoderConfig:
    """The production shape: full +/-15 search, rate control with mid-GOB
    MQUANT segments and minimum-rate stuffing fill."""
    return enc.EncoderConfig(fmt=QCIF, search=15,
                             rate=RateConfig(bit_rate=128_000, frame_rate=30,
                                             mquant_segments=3))


def dryrun_content(n_streams: int) -> Dict[str, np.ndarray]:
    """(n_streams, T, H, W) uint8 planes: random luma with a shifted second
    frame, so that the search finds real vectors and both the coded and
    the skip branches run; random chroma, cr the row-flipped cb."""
    rng = np.random.default_rng(0)
    y0 = rng.integers(0, 256, (n_streams, QCIF.height, QCIF.width),
                      np.uint8)
    y = np.stack([y0, np.roll(y0, 3, axis=2)], axis=1)[:, :T]
    c0 = rng.integers(0, 256,
                      (n_streams, T, QCIF.chroma_height, QCIF.chroma_width),
                      np.uint8)
    return dict(y=y, cb=c0, cr=np.flip(c0, axis=2).copy())


def shard_devices(n: int) -> Tuple[torch.device, ...]:
    """n logical shards over the visible cards: each card once, then again
    in the same order.  Raises without a card."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is visible; pass devices=['cpu'] "
                           "* n (--device cpu) for CPU shards")
    return tuple(torch.device("cuda", i % count) for i in range(n))


def dryrun_multichip(n: int = 8, devices: Optional[Sequence] = None
                     ) -> dict:
    """Encode n streams of dryrun_content over a mesh of `devices` (default
    shard_devices(n)) with dryrun_config and check the result: every
    stream codes its first frame and at most T (rate control may skip the
    second), the bit total is positive, and each stream's serializer count
    equals its device bit total.  Prints one line; returns dict(total_bits,
    frames_coded, streams: per-stream (bytes, nbits), devices)."""
    mesh = dm.make_mesh(devices=shard_devices(n) if devices is None
                        else devices)
    cfg = dryrun_config()
    run = dm.make_sharded_encoder(cfg, mesh)
    _, outputs, agg = run(dm.shard_batch(mesh, dm.init_states(cfg, n)),
                          dm.shard_batch(mesh, dryrun_content(n)))
    coded = int(agg["frames_coded"])
    if not n <= coded <= n * T:
        raise AssertionError(f"{coded} frames coded, expected {n}..{n * T}")
    total_bits = dm.agg_total_bits(agg)
    if total_bits <= 0:
        raise AssertionError(f"{total_bits} total bits")
    streams = dm.serialize_streams(cfg, outputs)
    device_bits = torch.cat([o["total_bits"].sum(dim=1).cpu()
                             for o in outputs]).tolist()
    for s, ((_, nbits), want) in enumerate(zip(streams, device_bits)):
        if nbits != want:
            raise AssertionError(f"stream {s}: serializer {nbits} bits, "
                                 f"device bit model {want}")
    print(f"dryrun_multichip OK: {len(mesh)} devices "
          f"({len(set(mesh))} distinct: "
          f"{', '.join(str(d) for d in dict.fromkeys(mesh))}), production "
          f"shape (search={cfg.search}, t={T}, rate control "
          f"mquant_segments={cfg.rate.mquant_segments}, min_rate_fill, "
          f"{coded} frames coded), {total_bits} total bits", flush=True)
    return dict(total_bits=total_bits, frames_coded=coded, streams=streams,
                devices=mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="p64tpu_torch.tools.dryrun",
        description="multi-device dry run of the production-shape encode")
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="streams, one per shard (default 8)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="shards on the visible cards (default) or the CPU")
    args = ap.parse_args(argv)
    devices = ["cpu"] * args.n if args.device == "cpu" else None
    result = dryrun_multichip(args.n, devices)
    if any(d.type == "cuda" for d in result["devices"]):
        print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
