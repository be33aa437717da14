"""Benchmark of the PyTorch port: multi-stream encode and decode throughput
on one card.

    python -m p64tpu_torch.tools.bench
    P64_BENCH_CONFIG=cif_rc python -m p64tpu_torch.tools.bench

Port of the repository's `bench.py`: the same configurations, content,
timing method, metric names and output.  Prints exactly ONE JSON line on
stdout,

  {"metric": "cif_encode_macroblocks_per_sec_per_chip", "value": N,
   "unit": "MB/s", "compile_s": C}

and everything else on stderr, whose first line is the card's name and
power limit (nvidia-smi) with the torch and CUDA versions.  The hardware
parity gate (`python -m p64tpu_torch.tools.parity`) runs first, in a
subprocess; if it fails, no number is printed.

Environment (the reference's, plus the two stream counts its `main`
already read):

  P64_BENCH_CONFIG      cif (default), cif_rc, cif_intra, qcif, decode,
                        pipeline
  P64_BENCH_STREAMS     encode streams (128: the reference's batch knee)
  P64_BENCH_FRAMES      frames per stream (32)
  P64_BENCH_REPS        timed reps after one warm-up (3); best rep counts
  P64_BENCH_QUANT       fixed quantizer (10)
  P64_DECODE_STREAMS    streams of the decode configuration (16)
  P64_PIPELINE_STREAMS  streams of the pipeline configuration (64)
  P64_SKIP_PARITY=1     skip the gate (said so on stderr)

`main` needs a card and exits 2 without one: a CPU number must never
appear under a `..._per_chip` name.  The `measure*` functions take an
explicit `device`, so the tests run them on the CPU at small shapes.
Encode configurations stage their frames on the device before the clock
starts; each rep is timed on the host clock and ends in a device-to-host
read of the bit total.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..control.ratecontrol import RateConfig
from ..core import decoder
from ..core import encoder as enc
from ..distrib import mesh as dm
from ..native import load
from ..spec.constants import CIF, QCIF, Format
from ..spec.luts import MTYPE_MQUANT
from ..utils import fan_map
from . import batch_encode as be

#: the encode configurations of `measure` (the reference's bench.py:366-370)
ENCODE_CONFIGS = ("cif", "cif_rc", "cif_intra", "qcif")
#: every configuration `main` takes
CONFIGS = ENCODE_CONFIGS + ("decode", "pipeline")
SEARCH = 15
#: the repository root: `python -m p64tpu_torch...` resolves from here
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def device_name(device: torch.device | str) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_parity_gate() -> None:
    """Run the hardware parity gate (`python -m p64tpu_torch.tools.parity`)
    in a subprocess, its output on stderr.  A failing gate ends the
    benchmark with exit 1: a fast wrong encoder is worthless.  Skipped only
    when the caller sets P64_SKIP_PARITY=1."""
    if os.environ.get("P64_SKIP_PARITY") == "1":
        log("parity gate SKIPPED (P64_SKIP_PARITY=1)")
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "p64tpu_torch.tools.parity"],
                       cwd=ROOT, env=env, stdout=sys.stderr,
                       stderr=sys.stderr)
    if r.returncode != 0:
        log("PARITY GATE FAILED -- benchmark aborted "
            "(a fast wrong encoder is worthless)")
        raise SystemExit(1)


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


def encoder_config(config: str, quant: int = 10,
                   emit_recon: bool = True) -> enc.EncoderConfig:
    """The EncoderConfig of an encode configuration (see `measure`)."""
    if config not in ENCODE_CONFIGS:
        raise ValueError(f"unknown encode configuration {config!r}; "
                         f"expected one of {ENCODE_CONFIGS}")
    rate = (RateConfig(bit_rate=1024000) if config == "cif_rc"
            else RateConfig(fixed_quant=quant))
    return enc.EncoderConfig(fmt=QCIF if config == "qcif" else CIF,
                             search=SEARCH, rate=rate,
                             intra_only=config == "cif_intra",
                             emit_recon=emit_recon)


def measure(config: str = "cif", streams: int = 16, frames_t: int = 32,
            reps: int = 3, quant: int = 10, emit_recon: bool = True, *,
            device: torch.device | str) -> dict:
    """Time one encode configuration on `device`:
      cif       -- CIF, search 15, fixed quantizer (the headline)
      cif_rc    -- CIF, per-GOB rate control at 1,024,000 bit/s (p = 16)
      cif_intra -- CIF, all intra (no motion search)
      qcif      -- QCIF, search 15, fixed quantizer

    The frames and the initial state are staged on the device first.  One
    warm-up run follows, its seconds reported as `compile_s`: on a card it
    builds the frame step's captured program (core.graphs: an eager
    warm-up step, the capture) and replays it for every frame, so
    `compile_s` means what the reference's "compile+first run" means.
    Then `reps` runs, each replaying the program once per frame, timed on
    the host clock up to the device-to-host read of the bit total (which
    waits for the device); the best counts.  reps=0 returns the warm-up's
    bits with ms = inf and mbs = 0.

    Returns dict(config, streams, mbs, bits, ms, compile_s, rep_ms,
    stream0_frame_bits (stream 0's bits per frame, read after the clock
    stopped), device (the device's name))."""
    cfg = encoder_config(config, quant, emit_recon)
    fmt = cfg.fmt
    dev = torch.device(device)
    name = device_name(dev)
    log(f"device={name} config={config} streams={streams} "
        f"frames={frames_t} quant={quant}")
    frames = {k: torch.as_tensor(v, device=dev) for k, v in
              make_content(fmt, streams, frames_t).items()}
    state0 = enc.init_state(cfg, streams, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    def run() -> Tuple[int, Dict[str, torch.Tensor]]:
        _, out = enc.encode_sequence(cfg, frames, state0, device=dev)
        return int(out["total_bits"].sum()), out      # waits for the device

    t0 = time.perf_counter()
    bits, out = run()
    compile_s = time.perf_counter() - t0
    log(f"warm-up (first run): {compile_s:.1f}s")

    best, rep_ms = float("inf"), []
    for r in range(reps):
        del out
        t0 = time.perf_counter()
        bits, out = run()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        rep_ms.append(dt * 1e3)
        log(f"rep {r}: {dt * 1e3:.1f} ms")
    first = out["total_bits"][0].tolist()

    n_mb = streams * frames_t * fmt.num_mbs
    log(f"total bits: {bits}, {n_mb} MBs in {best * 1e3:.1f} ms on {name}")
    return dict(config=config, streams=streams, mbs=n_mb / best, bits=bits,
                ms=best * 1e3, compile_s=compile_s, rep_ms=rep_ms,
                stream0_frame_bits=first, device=name)


def make_decode_content(streams: int, frames_t: int, quant: int, *,
                        device: torch.device | str):
    """Mixed compliant CIF streams for the decode benchmark, encoded on
    `device` and serialized by the port's native serializer:

      * half: fixed quantizer, texture noise 5;
      * one in 16: 4 Mbit/s rate control, noise 40 -- MBA stuffing fill on
        nearly every frame;
      * the rest: 2 Mbit/s with 3 mid-GOB MQUANT segments and initial
        quantizer 12, noise 40.

    Every frame must be coded and the mix must hold stuffing and MQUANT
    MBs, so the timed parse is honest.  Returns (stream bytes, stuffing
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
    log(f"decode content: {len(datas)} streams, {n_stuff} stuffing codes, "
        f"{n_mq} MQUANT MBs")
    return datas, n_stuff, n_mq, tuple(torch.cat(p) for p in zip(*recons))


def measure_decode(streams: int = 16, frames_t: int = 32, reps: int = 3,
                   quant: int = 10, chunk: int = 16, *,
                   device: torch.device | str) -> dict:
    """End-to-end decoder throughput at CIF on `device`: host parse (native
    engine, one thread per stream) and host stack + one copy to the device
    per chunk of `chunk` streams (`parse_chunk`), PIPELINED with the
    device reconstruction of the previous chunk -- one wall-clock number --
    plus the isolated stages for the overlap split.

    The device step reconstructs the chunk (`core.decoder.reconstruct_seq`)
    and reduces its luma planes to one integer sum on the device, read as
    one scalar: no plane is copied back.  The stack and its pageable copy
    are part of the parse stage, as the reference's stack is.

    Returns dict(config="decode", streams, mbs, bits (stream bytes x 8),
    ms, parse_ms, device_ms, overlap_hidden, checksum (the luma sum of the
    last pipelined pass), rep_ms, device)."""
    dev = torch.device(device)
    name = device_name(dev)
    fmt = CIF
    datas = make_decode_content(streams, frames_t, quant, device=dev)[0]
    total_bytes = sum(len(d) for d in datas)
    n_mb = streams * frames_t * fmt.num_mbs
    chunks = [datas[i:i + chunk] for i in range(0, len(datas), chunk)]
    load()

    def drun(batch) -> torch.Tensor:
        y = decoder.reconstruct_seq(fmt, batch)[0]
        return y.sum(dtype=torch.int64)               # stays on the device

    def parse_chunk(ch):
        parsed = fan_map(decoder.parse_to_tensors, ch)
        if any(s["levels8"].shape[0] != frames_t for _, _, s in parsed):
            raise RuntimeError("a decode-bench stream lost frames")
        return decoder.stack_seqs(fmt, [s for _, _, s in parsed], dev)

    t0 = time.perf_counter()
    chk = 0
    for ln in sorted({len(c) for c in chunks}):
        chk += int(drun(parse_chunk(next(c for c in chunks if len(c) == ln))))
    log(f"decode warm-up (first run per chunk size): "
        f"{time.perf_counter() - t0:.1f}s")

    # pipelined: parse chunk i+1 on host threads while the device
    # reconstructs chunk i; the scalar read forces chunk i
    wall_best, rep_ms = float("inf"), []
    for r in range(reps):
        t0 = time.perf_counter()
        chk = 0
        nxt = parse_chunk(chunks[0])
        for i in range(len(chunks)):
            fut = drun(nxt)
            if i + 1 < len(chunks):
                nxt = parse_chunk(chunks[i + 1])
            chk += int(fut)
        dt = time.perf_counter() - t0
        wall_best = min(wall_best, dt)
        rep_ms.append(dt * 1e3)
        log(f"decode rep {r}: {dt * 1e3:.1f} ms")

    parse_best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for ch in chunks:
            parse_chunk(ch)
        parse_best = min(parse_best, time.perf_counter() - t0)
    dev_best = float("inf")
    batches = [parse_chunk(ch) for ch in chunks]
    for _ in range(reps):
        t0 = time.perf_counter()
        for b in batches:
            int(drun(b))
        dev_best = min(dev_best, time.perf_counter() - t0)

    hidden = min(1.0, max(0.0, (parse_best + dev_best - wall_best)
                          / max(parse_best, 1e-9)))
    log(f"decode end-to-end: {wall_best * 1e3:.1f} ms wall for {n_mb} MBs "
        f"({total_bytes} bytes, checksum {chk & 0xffff}); isolated stages: "
        f"parse {parse_best * 1e3:.1f} + device {dev_best * 1e3:.1f} ms "
        f"-> {hidden * 100:.0f}% of parse hidden by overlap, on {name}")
    return dict(config="decode", streams=streams, mbs=n_mb / wall_best,
                bits=total_bytes * 8, ms=wall_best * 1e3,
                parse_ms=parse_best * 1e3, device_ms=dev_best * 1e3,
                overlap_hidden=hidden, checksum=chk, rep_ms=rep_ms,
                device=name)


def measure_pipeline(streams: int = 64, frames_t: int = 32, chunk: int = 16,
                     reps: int = 3, quant: int = 10, emit_recon: bool = True,
                     *, device: torch.device | str) -> dict:
    """End-to-end production encode wall on `device`: the pipelined
    `tools.batch_encode.encode_resilient` path (chunked device encode,
    pinned host copy of the symbol outputs, threaded native serialize
    overlapped with the next chunk's device work) plus the .p64 file
    writes, timed as a user sees it.  The mesh is every visible card for
    device "cuda", else `device` alone.

    The isolated splits: device-only runs each chunk through the sharded
    encoder (`distrib.mesh.make_sharded_encoder`) and reads its aggregate
    bit total, so it holds the host-to-device copy of the frames but NOT
    the host copy of the symbol outputs that `_dispatch_shard` queues;
    finalize-only encodes fresh outputs first (untimed), then times that
    host copy, the serialize and the file writes.

    Returns dict(config="pipeline", streams, mbs, bits, ms, device_ms,
    finalize_ms, overlap_hidden, compile_s, rep_ms, device)."""
    dev = torch.device(device)
    mesh = dm.make_mesh() if dev == torch.device("cuda") \
        else dm.make_mesh(devices=[dev])
    name = ", ".join(sorted({device_name(d) for d in mesh}))
    fmt = CIF
    cfg = enc.EncoderConfig(fmt=fmt, search=SEARCH, emit_recon=emit_recon,
                            rate=RateConfig(fixed_quant=quant))
    batch = make_content(fmt, streams, frames_t)
    n_mb = streams * frames_t * fmt.num_mbs
    starts = range(0, streams, chunk)
    outdir = tempfile.mkdtemp(prefix="p64bench_pipe_")

    def sub(s: int) -> Dict[str, np.ndarray]:
        return {k: v[s:s + chunk] for k, v in batch.items()}

    def write(prefix: str, s: int, results) -> int:
        nbytes = 0
        for i, r in enumerate(results):
            if r is None:
                raise RuntimeError(f"pipeline: stream {s + i} failed")
            data, _ = r
            with open(os.path.join(outdir, f"{prefix}{s + i:03d}.p64"),
                      "wb") as f:
                f.write(data)
            nbytes += len(data)
        return nbytes

    def run_once() -> int:
        return write("s", 0, be.encode_resilient(cfg, batch, mesh,
                                                 chunk=chunk))

    try:
        t0 = time.perf_counter()
        nbytes = run_once()
        compile_s = time.perf_counter() - t0
        log(f"pipeline warm-up (first run): {compile_s:.1f}s "
            f"({nbytes} bytes)")

        wall_best, rep_ms = float("inf"), []
        for r in range(reps):
            t0 = time.perf_counter()
            nbytes = run_once()
            dt = time.perf_counter() - t0
            wall_best = min(wall_best, dt)
            rep_ms.append(dt * 1e3)
            log(f"pipeline rep {r}: {dt * 1e3:.1f} ms")

        def encode_chunk(s: int):
            n = min(chunk, streams - s)
            sh = mesh[:min(len(mesh), n)]
            _, outputs, agg = dm.make_sharded_encoder(cfg, sh)(
                dm.shard_batch(sh, dm.init_states(cfg, n)),
                dm.shard_batch(sh, sub(s)))
            dm.agg_total_bits(agg)                    # waits for the device
            return outputs

        dev_best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for s in starts:
                encode_chunk(s)
            dev_best = min(dev_best, time.perf_counter() - t0)

        fin_best = float("inf")
        for _ in range(reps):
            outs = [(s, encode_chunk(s)) for s in starts]
            t0 = time.perf_counter()
            for s, outputs in outs:
                write("f", s, be._collect(
                    cfg, [enc.outputs_to_host(o) for o in outputs]))
            fin_best = min(fin_best, time.perf_counter() - t0)
            del outs
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    hidden = min(1.0, max(0.0, (dev_best + fin_best - wall_best)
                          / max(fin_best, 1e-9)))
    log(f"pipeline end-to-end: {wall_best * 1e3:.1f} ms wall "
        f"({streams / wall_best:.1f} streams/s, {nbytes} bytes); isolated: "
        f"device {dev_best * 1e3:.1f} + fetch+finalize {fin_best * 1e3:.1f}"
        f" ms -> {hidden * 100:.0f}% of finalize hidden by overlap, on "
        f"{name}")
    return dict(config="pipeline", streams=streams, mbs=n_mb / wall_best,
                bits=nbytes * 8, ms=wall_best * 1e3,
                device_ms=dev_best * 1e3, finalize_ms=fin_best * 1e3,
                overlap_hidden=hidden, compile_s=compile_s, rep_ms=rep_ms,
                device=name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv:
        print("usage: python -m p64tpu_torch.tools.bench (no arguments; "
              "configure by environment, see the module docstring)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench: no CUDA device -- the benchmark measures the card and "
              "prints no CPU number under a per-chip metric",
              file=sys.stderr)
        return 2
    log(f"{card_line()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    config = os.environ.get("P64_BENCH_CONFIG", "cif")
    if config not in CONFIGS:
        print(f"bench: unknown P64_BENCH_CONFIG {config!r}; expected one of "
              f"{CONFIGS}", file=sys.stderr)
        return 2
    run_parity_gate()
    streams = int(os.environ.get("P64_BENCH_STREAMS", "128"))
    frames_t = int(os.environ.get("P64_BENCH_FRAMES", "32"))
    reps = int(os.environ.get("P64_BENCH_REPS", "3"))
    quant = int(os.environ.get("P64_BENCH_QUANT", "10"))
    dev = torch.device("cuda", 0)                     # one chip

    # stdout carries the JSON line alone
    with contextlib.redirect_stdout(sys.stderr):
        if config == "decode":
            r = measure_decode(int(os.environ.get("P64_DECODE_STREAMS",
                                                  "16")),
                               frames_t, reps, quant, device=dev)
            metric = "cif_decode_macroblocks_per_sec_per_chip"
        elif config == "pipeline":
            r = measure_pipeline(int(os.environ.get("P64_PIPELINE_STREAMS",
                                                    "64")),
                                 frames_t, reps=reps, quant=quant,
                                 device=dev)
            metric = "cif_pipeline_encode_macroblocks_per_sec_per_chip"
        else:
            r = measure(config, streams, frames_t, reps, quant, device=dev)
            metric = f"{config}_encode_macroblocks_per_sec_per_chip"
    out = {"metric": metric, "value": round(r["mbs"], 1), "unit": "MB/s"}
    if "compile_s" in r:
        out["compile_s"] = round(r["compile_s"], 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
