"""Multi-stream batch decoder of the PyTorch port.

  python -m p64tpu_torch.tools.batch_decode -o outdir a.p64 b.p64 ...
  python -m p64tpu_torch.tools.batch_decode -o outdir --device cpu '*.p64'

Port of `p64tpu/tools/batch_decode.py`.  The host VLC parse fans across
threads straight into stacked symbol arrays (core.decoder
.parse_to_tensors, in the C++ engine); reconstruction batches every group
of equal-shaped streams into one `decode_seq_batch` call on the device,
whose planes come back in pinned host memory from a card.  One .y4m per
input is written to outdir.
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

    load()  # build/load the engine once before fanning out
    t0 = time.perf_counter()
    try:
        parsed = fan_map(
            lambda d: parse_to_tensors(d, resync=args.resync), datas)
    except StreamError as e:
        print(f"batch_decode: invalid H.261 stream: {e}", file=sys.stderr)
        return 1
    t_parse = time.perf_counter() - t0

    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.perf_counter()
    # group equal-shaped streams into one batched decode each
    groups = {}
    for i, (fmt, _, seq) in enumerate(parsed):
        groups.setdefault((fmt, seq["levels8"].shape[0]), []).append(i)
    planes = [None] * len(parsed)
    for (fmt, _), idxs in groups.items():
        for i, p in zip(idxs, decode_seq_batch(
                fmt, [parsed[i][2] for i in idxs], device=device)):
            planes[i] = p
    n_frames = 0
    for path, (fmt, _, _), (y, cb, cr) in zip(paths, parsed, planes):
        n_frames += y.shape[0]
        out = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(path))[0] + ".y4m")
        yuv.write_y4m(out, dict(y=y, cb=cb, cr=cr), (args.frame_rate, 1))
        if args.verbose:
            print(f"{out}: {y.shape[0]} frames {fmt.name}", file=sys.stderr)
    t_dev = time.perf_counter() - t0
    if args.verbose:
        print(f"{len(paths)} streams, {n_frames} frames: parse "
              f"{t_parse * 1e3:.0f} ms, decode+write {t_dev * 1e3:.0f} ms "
              f"on {device}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
