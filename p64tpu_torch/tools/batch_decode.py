"""Multi-stream batch decoder of the PyTorch port.

  python -m p64tpu_torch.tools.batch_decode -o outdir a.p64 b.p64 ...
  python -m p64tpu_torch.tools.batch_decode -o outdir --device cpu '*.p64'

Port of `p64tpu/tools/batch_decode.py`.  The host VLC parse fans across
threads straight into stacked symbol arrays (core.decoder
.parse_to_tensors, in the C++ engine); reconstruction batches every group
of equal-shaped streams into one `decode_seq_batch` call on the device,
whose planes come back in pinned host memory from a card.  One .y4m per
input is written to outdir.

A stream the parser refuses (a StreamError: no picture, two picture
formats, or with strict parsing any error) gets no .y4m; the others are
decoded and written all the same, and the exit code is then 1, as
`batch_encode` reports streams that failed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List

from ..io import yuv
from ..utils import expand_inputs, fan_map


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="p64tpu_torch.tools.batch_decode")
    ap.add_argument("inputs", nargs="+", help="input .p64 files or globs")
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("-f", "--frame-rate", type=int, default=30,
                    help="frame rate stamped into the .y4m headers")
    ap.add_argument("-e", "--resync", action="store_true",
                    help="start-code error recovery: conceal damaged "
                         "GOBs/pictures and continue (default: strict)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to decode on (default cuda)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from ..core.decoder import decode_seq_batch, parse_to_tensors
    from ..entropy.parse import StreamError
    from ..native import load

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("batch_decode: no CUDA device is available; pass --device cpu "
              "to decode on the CPU", file=sys.stderr)
        return 2
    paths: List[str] = expand_inputs(args.inputs)
    datas = []
    for p in paths:
        with open(p, "rb") as f:
            datas.append(f.read())

    def parse_one(data):
        try:
            return parse_to_tensors(data, resync=args.resync)
        except StreamError as e:
            return e

    load()  # build/load the engine once before fanning out
    t0 = time.perf_counter()
    parsed = fan_map(parse_one, datas)
    t_parse = time.perf_counter() - t0
    refused = []
    for path, got in zip(paths, parsed):
        if isinstance(got, StreamError):
            refused.append(path)
            print(f"batch_decode: {path}: invalid H.261 stream: {got}",
                  file=sys.stderr)

    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.perf_counter()
    # group equal-shaped streams into one batched decode each
    groups = {}
    for i, got in enumerate(parsed):
        if not isinstance(got, StreamError):
            fmt, _, seq = got
            groups.setdefault((fmt, seq["levels8"].shape[0]), []).append(i)
    planes = [None] * len(parsed)
    for (fmt, _), idxs in groups.items():
        for i, p in zip(idxs, decode_seq_batch(
                fmt, [parsed[i][2] for i in idxs], device=device)):
            planes[i] = p
    n_frames = 0
    for path, got, p in zip(paths, parsed, planes):
        if p is None:
            continue
        fmt, (y, cb, cr) = got[0], p
        n_frames += y.shape[0]
        out = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(path))[0] + ".y4m")
        yuv.write_y4m(out, dict(y=y, cb=cb, cr=cr), (args.frame_rate, 1))
        if args.verbose:
            print(f"{out}: {y.shape[0]} frames {fmt.name}", file=sys.stderr)
    t_dev = time.perf_counter() - t0
    if args.verbose:
        print(f"{len(paths) - len(refused)} streams, {n_frames} frames: "
              f"parse {t_parse * 1e3:.0f} ms, decode+write "
              f"{t_dev * 1e3:.0f} ms on {device}", file=sys.stderr)
    if refused:
        print(f"{len(refused)} stream(s) REFUSED: " + " ".join(refused),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
