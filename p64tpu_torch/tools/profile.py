"""Profiling harness of the PyTorch port.

  python -m p64tpu_torch.tools.profile --streams 8 --frames 4 --trace-dir tr
  python -m p64tpu_torch.tools.profile --device cpu --format QCIF

Port of `p64tpu/tools/profile.py`.  Encodes random content (S streams x T
frames, fixed quantizer) through `core.encoder.encode_sequence` and prints
the steady-state encode rate: best of 3 runs, each ending in a
device-to-host read of the bit total.  With --trace-dir, one more run is
traced with `torch.profiler` (CPU and, on a card, CUDA activity): a Chrome
trace (chrome://tracing, Perfetto) lands in the directory, and the top
operators by self device time (self CPU time on the CPU) are printed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

#: operators listed from the profiler's key_averages
TOP_OPS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="p64tpu_torch.tools.profile")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--format", default="CIF")
    ap.add_argument("--quant", type=int, default=10)
    ap.add_argument("--trace-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to encode on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..io.yuv import parse_format

    from ..control.ratecontrol import RateConfig
    from ..core import encoder as enc

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("profile: no CUDA device is available; pass --device cpu to "
              "profile the CPU path", file=sys.stderr)
        return 2
    fmt = parse_format(args.format)
    S, T = args.streams, args.frames
    rng = np.random.default_rng(0)
    ys = rng.integers(0, 256, (S, T, fmt.height, fmt.width), dtype=np.uint8)
    frames = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        y=ys, cb=ys[:, :, ::2, ::2] // 2 + np.uint8(1),
        cr=ys[:, :, 1::2, ::2] // 2 + np.uint8(1)).items()}
    cfg = enc.EncoderConfig(fmt=fmt, rate=RateConfig(fixed_quant=args.quant))

    def run() -> int:
        _, out = enc.encode_sequence(cfg, frames, device=dev)
        return int(out["total_bits"].sum())      # waits for the device

    t0 = time.perf_counter()
    bits = run()
    print(f"first run: {time.perf_counter() - t0:.1f}s ({bits} bits)")

    def timed() -> float:
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    best = min(timed() for _ in range(3))
    n_mb = S * T * fmt.num_mbs
    print(f"steady state: {best * 1e3:.1f} ms for {n_mb} MBs "
          f"({n_mb / best:.0f} MB/s) on {dev}")

    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        on_card = dev.type == "cuda"
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            run()
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        sort = "self_device_time_total" if on_card else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=sort, row_limit=TOP_OPS))
        print(f"trace written to {path} (chrome://tracing or Perfetto)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
