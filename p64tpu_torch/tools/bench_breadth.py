"""Benchmark breadth of the PyTorch port: every configuration, stream-count
scaling, decode and host finalize on one card.

    python -m p64tpu_torch.tools.bench_breadth            (every section)
    python -m p64tpu_torch.tools.bench_breadth configs knee

Port of the repository's `tools/bench_breadth.py`, with the same sections
chosen by the same arguments:

  configs      the four encode configurations at 16 streams
  scaling      the headline configuration at 4, 32 and 64 streams
  knee         ... and at 96, 128, 192 and 256 streams
  reconab      128 streams with and without the per-frame recon outputs
  decode       the decode configuration (16 streams)
  pipeline     the pipeline configuration (64 streams, chunk 16)
  pipeline128  the pipeline at 128 streams, chunks 16 and 32, recon off
  finalize     host serialize of 64 CIF streams x 8 frames

It prints a markdown table on stdout (progress on stderr).  A stream count
that runs out of device memory ends the scaling sections with a FAILED
row, as the reference records OOM as data; any other error ends the tool
with a non-zero exit.  Needs a card; exits 2 without one.
"""

from __future__ import annotations

import sys
import time

import torch

from ..control.ratecontrol import RateConfig
from ..core import encoder as enc
from ..entropy.encode import serialize_sequence
from ..native import load
from ..spec.constants import CIF
from . import bench

#: every section, in the order the table lists them
SECTIONS = ("configs", "scaling", "knee", "reconab", "decode", "pipeline",
            "pipeline128", "finalize")


def measure_finalize(streams: int = 64, frames_t: int = 8, *,
                     device: torch.device | str) -> dict:
    """Host finalize cost at scale: the benchmark content encoded on
    `device` and copied to the host once, then per stream
    `outputs_to_symbols` + the native `serialize_sequence` in a serial
    loop, best of 3.  Returns dict(streams, ms, bytes)."""
    cfg = enc.EncoderConfig(fmt=CIF, search=bench.SEARCH,
                            rate=RateConfig(fixed_quant=10))
    _, outputs = enc.encode_sequence(
        cfg, bench.make_content(CIF, streams, frames_t), device=device)
    outputs = {k: outputs[k].cpu().numpy() for k in enc.SYMBOL_KEYS}
    load()
    best, nbytes = float("inf"), 0
    for _ in range(3):
        t0 = time.perf_counter()
        nbytes = 0
        for s in range(streams):
            (syms,) = enc.outputs_to_symbols(
                cfg, {k: v[s:s + 1] for k, v in outputs.items()})
            data, _ = serialize_sequence(cfg.fmt, syms)
            nbytes += len(data)
        best = min(best, time.perf_counter() - t0)
    return dict(streams=streams, ms=best * 1e3, bytes=nbytes)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("bench_breadth: no CUDA device -- the table holds the card's "
              "numbers", file=sys.stderr)
        return 2
    unknown = [a for a in argv if a not in SECTIONS]
    if unknown:
        print(f"bench_breadth: unknown sections {unknown}; expected some of "
              f"{SECTIONS}", file=sys.stderr)
        return 2
    only = argv or None

    def want(tag):
        return only is None or tag in only

    dev = torch.device("cuda", 0)
    bench.log(f"{bench.card_line()} | torch {torch.__version__} cuda "
              f"{torch.version.cuda}")
    rows = []
    if want("configs"):
        for config in bench.ENCODE_CONFIGS:
            rows.append((f"{config} (16 streams)",
                         bench.measure(config, device=dev)))
    if want("scaling") or want("knee"):
        counts = [4, 32, 64] if want("scaling") else []
        if want("knee"):
            counts += [96, 128, 192, 256]
        for streams in counts:
            try:
                r = bench.measure("cif", streams=streams, device=dev)
            except torch.cuda.OutOfMemoryError as e:
                rows.append((f"cif ({streams} streams)",
                             f"FAILED: {type(e).__name__}: {str(e)[:120]}"))
                break
            rows.append((f"cif ({streams} streams)", r))
    if want("reconab"):
        for er in (True, False):
            rows.append((f"cif (128 streams, emit_recon={er})",
                         bench.measure("cif", streams=128, emit_recon=er,
                                       device=dev)))
    if want("decode"):
        rows.append(("decode (16 streams)", bench.measure_decode(device=dev)))
    if want("pipeline"):
        rows.append(("pipeline (64 streams)",
                     bench.measure_pipeline(device=dev)))
    if want("pipeline128"):
        for chunk in (16, 32):
            rows.append((f"pipeline (128 streams, chunk {chunk}, recon off)",
                         bench.measure_pipeline(streams=128, chunk=chunk,
                                                emit_recon=False,
                                                device=dev)))

    print(f"card: {bench.card_line()}")
    print("| config | MB/s/chip | ms/run | total bits | compile s |")
    print("|---|---|---|---|---|")
    for name, r in rows:
        if isinstance(r, str):
            print(f"| {name} | {r} |")
            continue
        extra = ""
        if "parse_ms" in r:
            extra = (f" (stages: parse {r['parse_ms']:.0f} + device "
                     f"{r['device_ms']:.0f}; "
                     f"{r['overlap_hidden'] * 100:.0f}% parse hidden)")
        elif "finalize_ms" in r:
            extra = (f" (stages: device {r['device_ms']:.0f} + finalize "
                     f"{r['finalize_ms']:.0f}; "
                     f"{r['overlap_hidden'] * 100:.0f}% finalize hidden)")
        print(f"| {name} | {r['mbs']:,.0f} | {r['ms']:.1f}{extra} "
              f"| {r['bits']} | {r.get('compile_s', float('nan')):.0f} |",
              flush=True)

    if want("finalize"):
        f = measure_finalize(device=dev)
        print(f"\nhost finalize: {f['streams']} CIF streams x 8 frames = "
              f"{f['ms']:.1f} ms host-serial ({f['bytes']} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
