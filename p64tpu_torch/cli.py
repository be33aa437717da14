"""Command-line encoder of the PyTorch port, mirroring `p64tpu/cli.py`.

Examples:
  python -m p64tpu_torch -s out.p64 -q 10 input.y4m
  python -m p64tpu_torch -s out.p64 -q 8 -x QCIF -v input.yuv
  python -m p64tpu_torch -s out.p64 -x QCIF -r 256000 input.yuv
  python -m p64tpu_torch -s out.p64 -r 1024000 -m 3 --device cpu input.y4m

Only the encoder is ported: decode (-d) and resync (-e) exit with status 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from p64tpu import stats
from p64tpu.io import yuv
from p64tpu.spec.constants import DEFAULT_SEARCH_RANGE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="p64tpu_torch",
        description="H.261 (p x 64) encoder, PyTorch/CUDA port")
    p.add_argument("-d", "--decode", action="store_true",
                   help="decode mode (not yet ported)")
    p.add_argument("-s", "--stream", required=True,
                   help="H.261 stream file to write")
    p.add_argument("-q", "--quant", type=int, default=8,
                   help="fixed quantizer 1..31 (default 8)")
    p.add_argument("-r", "--rate", type=int, default=0,
                   help="bit rate in bit/s; enables rate control")
    p.add_argument("-f", "--frame-rate", type=int, default=30,
                   help="input frame rate for rate control (default 30)")
    p.add_argument("-a", "--first", type=int, default=0,
                   help="first frame index")
    p.add_argument("-b", "--last", type=int, default=None,
                   help="last frame index (inclusive)")
    p.add_argument("-x", "--format", default=None,
                   help="picture format CIF or QCIF (raw/PVRG inputs)")
    p.add_argument("-i", "--search", type=int, default=DEFAULT_SEARCH_RANGE,
                   help="ME search range 0..15 (0 = intra only)")
    p.add_argument("-I", "--intra-period", type=int, default=0,
                   help="force an all-intra frame every N frames")
    p.add_argument("-m", "--mquant-segments", type=int, default=1,
                   help="mid-GOB quantizer adaptation: segments per GOB "
                        "(1 = GQUANT only; needs -r)")
    p.add_argument("-l", "--no-filter", action="store_true",
                   help="disable the H.261 loop filter (no FIL MTYPEs)")
    p.add_argument("-e", "--resync", action="store_true",
                   help="decode with start-code resync (not yet ported)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-frame statistics")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode on (default cuda)")
    p.add_argument("input", nargs="?",
                   help="input: .y4m, raw .yuv, or PVRG prefix")
    return p


def _not_ported(args) -> Optional[str]:
    if args.decode:
        return "decode (-d)"
    if args.resync:
        return "resync (-e)"
    return None


def _validate(args) -> Optional[str]:
    if not 1 <= args.quant <= 31:
        return f"-q/--quant must be 1..31 (got {args.quant})"
    if not 0 <= args.search <= DEFAULT_SEARCH_RANGE:
        return (f"-i/--search must be 0..{DEFAULT_SEARCH_RANGE} "
                f"(got {args.search})")
    if args.rate < 0:
        return f"-r/--rate must be >= 0 (got {args.rate})"
    if args.frame_rate <= 0:
        return f"-f/--frame-rate must be positive (got {args.frame_rate})"
    if args.intra_period < 0:
        return f"-I/--intra-period must be >= 0 (got {args.intra_period})"
    if not 1 <= args.mquant_segments <= 33:
        return ("-m/--mquant-segments must be 1..33 "
                f"(got {args.mquant_segments})")
    if args.mquant_segments > 1 and args.rate <= 0:
        return "-m/--mquant-segments > 1 needs rate control (-r)"
    if args.first < 0 or (args.last is not None and args.last < args.first):
        return f"bad frame range -a {args.first} -b {args.last}"
    return None


def run_encode(args) -> int:
    import torch

    from .control.decisions import DecisionConfig
    from .control.ratecontrol import RateConfig
    from .core.encoder import EncoderConfig, encode_to_bytes

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("p64tpu_torch: no CUDA device is available; pass --device cpu "
              "to encode on the CPU", file=sys.stderr)
        return 2
    fmt = yuv.parse_format(args.format) if args.format else None
    frames, fmt = yuv.load_input(args.input, fmt, args.first, args.last)
    t = frames["y"].shape[0]
    if t == 0:
        print("no input frames", file=sys.stderr)
        return 1
    rate = RateConfig(bit_rate=args.rate, frame_rate=args.frame_rate,
                      fixed_quant=args.quant,
                      mquant_segments=args.mquant_segments)
    cfg = EncoderConfig(fmt=fmt, search=max(args.search, 0), rate=rate,
                        intra_only=args.search <= 0,
                        intra_period=args.intra_period,
                        decisions=DecisionConfig(
                            filter_with_mc=not args.no_filter),
                        emit_recon=args.verbose)
    data, outputs, _ = encode_to_bytes(
        cfg, {k: v[None] for k, v in frames.items()}, device=device)
    with open(args.stream, "wb") as f:
        f.write(data[0])
    coded = outputs["frame_coded"][0].cpu().numpy()
    bits = outputs["total_bits"][0].cpu().numpy()
    if args.verbose:
        rec = {k: outputs["recon_" + k][0].cpu().numpy()
               for k in ("y", "cb", "cr")}
        for i in range(t):
            print(stats.frame_report(
                i, bool(coded[i]), int(bits[i]), {k: rec[k][i] for k in rec},
                {k: frames[k][i] for k in frames}))
    print(stats.sequence_report(int(np.sum(bits)), int(coded.sum()), t,
                                args.frame_rate))
    print(f"wrote {len(data[0])} bytes to {args.stream}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    missing = _not_ported(args)
    if missing:
        print(f"p64tpu_torch: {missing} is not yet ported; use the JAX "
              "package (python -m p64tpu)", file=sys.stderr)
        return 2
    err = _validate(args)
    if err:
        print(f"p64tpu_torch: {err}", file=sys.stderr)
        return 2
    if not args.input:
        print("encode mode needs an input", file=sys.stderr)
        return 1
    try:
        return run_encode(args)
    except (ValueError, FileNotFoundError) as e:
        print(f"p64tpu_torch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
