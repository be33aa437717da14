"""Command-line encoder/decoder of the PyTorch port, mirroring
`p64tpu/cli.py`.

Examples:
  encode: python -m p64tpu_torch -s out.p64 -q 10 input.y4m
          python -m p64tpu_torch -s out.p64 -q 8 -x QCIF -v input.yuv
          python -m p64tpu_torch -s out.p64 -x QCIF -r 256000 input.yuv
          python -m p64tpu_torch -s out.p64 -r 1024000 -m 3 --device cpu \
              input.y4m
  decode: python -m p64tpu_torch -d -s in.p64 -o out.y4m [--device cpu]
          python -m p64tpu_torch -d -e -s damaged.p64 -o out.y4m
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from . import stats
from .io import yuv
from .spec.constants import DEFAULT_SEARCH_RANGE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="p64tpu_torch",
        description="H.261 (p x 64) encoder/decoder, PyTorch/CUDA port")
    p.add_argument("-d", "--decode", action="store_true",
                   help="decode mode (default: encode)")
    p.add_argument("-s", "--stream", required=True,
                   help="H.261 stream file (encode: output, decode: input)")
    p.add_argument("-o", "--output",
                   help="decode output (.y4m, .yuv, or PVRG prefix)")
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
                   help="decode with start-code error recovery: damaged "
                        "GOBs/pictures are concealed and decoding "
                        "continues at the next PSC/GBSC (default: strict, "
                        "fail on the first invalid code)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-frame statistics")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode or decode on "
                        "(default cuda)")
    p.add_argument("input", nargs="?",
                   help="encode input: .y4m, raw .yuv, or PVRG prefix; "
                        "decode: optional source for PSNR reporting")
    return p


def _validate(args) -> Optional[str]:
    if not args.decode and not 1 <= args.quant <= 31:
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


def _device(args):
    """The --device as a torch.device, or None (after saying why) when it
    names CUDA and no card is present."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        what = "decode" if args.decode else "encode"
        print(f"p64tpu_torch: no CUDA device is available; pass --device cpu "
              f"to {what} on the CPU", file=sys.stderr)
        return None
    return device


def run_encode(args) -> int:
    from .control.decisions import DecisionConfig
    from .control.ratecontrol import RateConfig
    from .core.encoder import EncoderConfig, encode_to_bytes

    device = _device(args)
    if device is None:
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


def run_decode(args) -> int:
    from .core.decoder import decode_stream
    from .entropy.parse import StreamError

    device = _device(args)
    if device is None:
        return 2
    with open(args.stream, "rb") as f:
        data = f.read()
    try:
        y, cb, cr, parsed = decode_stream(data, resync=args.resync,
                                          device=device)
    except StreamError as e:
        print(f"p64tpu_torch: invalid H.261 stream: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        # resync mode never raises StreamError; a stream with no start
        # code at all yields zero frames
        print(f"p64tpu_torch: {e}", file=sys.stderr)
        return 1
    n_damaged = sum(bool(p.damaged) for p in parsed)
    if n_damaged:
        print(f"p64tpu_torch: {n_damaged}/{len(parsed)} damaged pictures "
              f"concealed (resync)", file=sys.stderr)
    frames = dict(y=y, cb=cb, cr=cr)
    out = args.output
    fmt = parsed[0].fmt
    if not out:
        print(f"decoded {len(parsed)} frames ({fmt.name}); no -o given, "
              "not writing", flush=True)
        return 0
    if out.endswith(".y4m"):
        yuv.write_y4m(out, frames, (args.frame_rate, 1))
    elif out.endswith((".yuv", ".i420", ".raw")):
        yuv.write_raw(out, frames)
    else:
        yuv.write_pvrg(out, frames, args.first)
    if args.input:
        # decode-mode PSNR against the original source
        src, sfmt = yuv.load_input(args.input, fmt, args.first, args.last)
        if sfmt is not fmt:
            print(f"p64tpu_torch: source is {sfmt.name}, stream is "
                  f"{fmt.name}", file=sys.stderr)
            return 1
        n = min(len(parsed), src["y"].shape[0])
        for i in range(n):
            print(stats.frame_report(
                i, True, 0, dict(y=y[i], cb=cb[i], cr=cr[i]),
                {k: src[k][i] for k in ("y", "cb", "cr")}))
        print(f"sequence Y PSNR {stats.psnr(y[:n], src['y'][:n]):.2f} dB "
              f"over {n} frames")
    if args.verbose:
        for i, p in enumerate(parsed):
            print(f"frame {i:4d}: TR {p.tr:2d} {p.fmt.name} "
                  f"coded MBs {int(p.coded.sum())}/{p.fmt.num_mbs} "
                  f"intra {int((p.intra & p.coded).sum())}")
    print(f"decoded {len(parsed)} frames to {out}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    err = _validate(args)
    if err:
        print(f"p64tpu_torch: {err}", file=sys.stderr)
        return 2
    try:
        if args.decode:
            return run_decode(args)
        if not args.input:
            print("encode mode needs an input", file=sys.stderr)
            return 1
        return run_encode(args)
    except (ValueError, FileNotFoundError) as e:
        print(f"p64tpu_torch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
