"""Multi-stream data-parallel batch encoder of the PyTorch port.

  python -m p64tpu_torch.tools.batch_encode -o outdir -q 10 'seq/*.y4m'
  python -m p64tpu_torch.tools.batch_encode -o outdir -r 256000 a.y4m ...
  python -m p64tpu_torch.tools.batch_encode -o outdir --device cpu a.y4m

Port of `p64tpu/tools/batch_encode.py`.  Encodes N input files as one
batch: all streams must share one format and frame count (longer inputs
are truncated to the common minimum).  With `--device cuda` (the default)
the streams are sharded over every visible card (distrib.mesh); one .p64
per input is written to outdir.  Under `torch.distributed` each process
runs this on its local streams (distrib.multihost).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..io import yuv
from ..control.ratecontrol import RateConfig
from ..core import encoder as enc
from ..distrib import mesh as dm
from ..kernels._build import BuildError

#: a dispatched shard: per mesh shard, (host outputs, event) from
#: core.encoder.outputs_to_host
Pending = List[Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]]


def _dispatch_shard(cfg: enc.EncoderConfig, batch: Dict[str, np.ndarray],
                    mesh: dm.Mesh) -> Pending:
    """Queue the encode of a contiguous range of streams on the mesh (at
    most one shard per stream) and the copy of its symbol outputs to host
    memory; returns without waiting for the device.  Device errors surface
    in _collect, or in a later CUDA call."""
    n, t = batch["y"].shape[:2]
    sub = mesh[:min(len(mesh), n)]
    run = dm.make_sharded_encoder(cfg, sub)
    with trace.span("p64.encode.dispatch"):
        trace.count("p64.encode.macroblocks", n * t * cfg.fmt.num_mbs)
        with trace.span("p64.encode.frames_in"):
            states = dm.shard_batch(sub, dm.init_states(cfg, n))
            frames = dm.shard_batch(sub, batch)
        _, outputs, _ = run(states, frames)
        return [enc.outputs_to_host(out) for out in outputs]


def _collect(cfg: enc.EncoderConfig,
             pending: Pending) -> List[Tuple[bytes, int]]:
    """Wait for a dispatched shard's host copies (its events alone, not
    the work queued after them) and serialize its streams."""
    with trace.span("p64.encode.wait"):
        for _, event in pending:
            if event is not None:
                event.synchronize()
    return dm.serialize_streams(cfg, [host for host, _ in pending])


def encode_shard(cfg: enc.EncoderConfig, batch: Dict[str, np.ndarray],
                 mesh: dm.Mesh) -> List[Tuple[bytes, int]]:
    """One dispatch over a contiguous range of streams.

    Returns per-stream (bytes, nbits).  Streams are independent, so any
    sub-range of the batch produces byte-identical output to the same
    streams inside a larger dispatch -- the property the retry logic in
    encode_resilient relies on.
    """
    return _collect(cfg, _dispatch_shard(cfg, batch, mesh))


def encode_resilient(
        cfg: enc.EncoderConfig, batch: Dict[str, np.ndarray],
        mesh: dm.Mesh, retries: int = 2,
        fail_hook: Optional[Callable[[int, int, int], None]] = None,
        log: Callable[[str], None] = lambda s: None,
        chunk: int = 0,
) -> List[Optional[Tuple[bytes, int]]]:
    """Shard-level failure recovery: per-range re-dispatch is cheap because
    streams are independent.

    Encodes streams [0, n) of the host batch on `mesh`.  A failed dispatch
    is retried up to `retries` times; if a range keeps failing it is
    bisected so one poison stream cannot take down its neighbours.  Slots
    that still fail at width 1 are returned as None.  fail_hook(start,
    stop, attempt) is a test-only fault injector called before each
    dispatch; it raising == that dispatch failing.  A BuildError (a kernel
    or the native engine that cannot be built or loaded) is not retried:
    it ends the call.

    What a retry can recover from on a card: torch.cuda.OutOfMemoryError
    (a range too wide for device memory fails at allocation, its tensors
    are freed, and bisection finds a width that fits).  What it cannot: a
    kernel fault such as an illegal address poisons the CUDA context, and
    every later dispatch in the process fails with it, so every remaining
    range ends as None.

    The call is one `p64.encode.job` span, the root of its chunks' spans
    (`trace`: dispatch, frames in, replays, copies to host, wait, symbols,
    serialize).

    chunk > 0 splits the batch into `chunk`-stream pieces and PIPELINES
    them, at most two in flight: after a chunk's frame loop is queued and
    its symbol outputs' copies to pinned host memory are queued behind it
    (core.encoder.outputs_to_host), the next chunk is dispatched before
    the host waits on the first chunk's event and serializes it.  Whether
    the device then works while the host serializes depends on the device
    being behind the host: on a card each frame is one replay of a
    captured frame step (core.graphs), so queuing a chunk costs the host
    little.  Both chunks in flight replay the same program; every copy
    into and out of its static buffers is queued on the one stream, so
    they cannot overwrite each other.  chunk == 0 keeps the
    single-dispatch behavior.

    Fault attribution under pipelining: CUDA reports a kernel's fault
    asynchronously, at the next call that synchronizes (an event wait, a
    pageable copy, an allocation that has to wait), so a fault of chunk
    i's kernels can surface while chunk i+1 is dispatched or collected,
    and a fault of chunk i+1's at chunk i's wait, charging a retry to the
    healthy neighbour.  Recovery from a recoverable error still converges
    (both ranges re-dispatch, and re-dispatching a healthy range is
    byte-exact), but logs may misattribute the first failure and the
    retry budget is approximate across in-flight neighbours.
    """
    with trace.span("p64.encode.job"):
        return _encode_resilient(cfg, batch, mesh, retries, fail_hook, log,
                                 chunk)


def _encode_resilient(cfg, batch, mesh, retries, fail_hook, log, chunk):
    """encode_resilient's work, inside its job span."""
    n = batch["y"].shape[0]
    results: List[Optional[Tuple[bytes, int]]] = [None] * n
    if chunk > 0:
        work = [(s, min(s + chunk, n), 0) for s in range(0, n, chunk)]
        work.reverse()          # .pop() serves ranges in ascending order
    else:
        work = [(0, n, 0)]      # (start, stop, attempt)

    def fail(s, e, att, exc):
        if att < retries:
            log(f"shard [{s},{e}) attempt {att} failed ({exc!r}); retrying")
            work.append((s, e, att + 1))
        elif e - s > 1:
            mid = (s + e) // 2
            log(f"shard [{s},{e}) failed {retries + 1} times; bisecting")
            work.append((mid, e, 0))
            work.append((s, mid, 0))
        else:
            log(f"stream {s} failed permanently: {exc!r}")

    inflight: List[Tuple[int, int, int, Pending]] = []  # FIFO, depth 2

    def drain_one():
        s, e, att, pending = inflight.pop(0)
        try:
            results[s:e] = _collect(cfg, pending)
        except BuildError:
            raise
        except Exception as exc:  # noqa: BLE001 -- device fault surfaced
            fail(s, e, att, exc)

    while work or inflight:
        while work and len(inflight) < 2:
            s, e, att = work.pop()
            try:
                if fail_hook is not None:
                    fail_hook(s, e, att)
                sub = {k: v[s:e] for k, v in batch.items()}
                pending = _dispatch_shard(cfg, sub, mesh)
            except BuildError:
                raise
            except Exception as exc:  # noqa: BLE001 -- dispatch-time fault
                fail(s, e, att, exc)
                continue
            inflight.append((s, e, att, pending))
        if inflight:
            drain_one()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="p64tpu_torch.tools.batch_encode")
    ap.add_argument("inputs", nargs="+", help="input files or globs (.y4m)")
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("-q", "--quant", type=int, default=8)
    ap.add_argument("-r", "--rate", type=int, default=0)
    ap.add_argument("-f", "--frame-rate", type=int, default=30)
    ap.add_argument("-i", "--search", type=int, default=15)
    ap.add_argument("--retries", type=int, default=2,
                    help="re-dispatch attempts per failed shard (then "
                         "bisect to isolate a poison stream)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="streams per pipelined chunk (0 = one dispatch); "
                         "with chunking, host serialization of chunk i "
                         "follows the dispatch of chunk i+1")
    ap.add_argument("--device", default="cuda",
                    help="torch device to encode on (default cuda: every "
                         "visible card; cuda:N one card; cpu)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if not 0 <= args.search <= 15:
        print(f"-i/--search must be 0..15 (H.261 MV range), got "
              f"{args.search}", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("batch_encode: no CUDA device is available; pass --device cpu "
              "to encode on the CPU", file=sys.stderr)
        return 2
    mesh = (dm.make_mesh() if device == torch.device("cuda")
            else dm.make_mesh(devices=[device]))

    from ..utils import expand_inputs
    paths: List[str] = expand_inputs(args.inputs)
    if not paths:
        print("no inputs", file=sys.stderr)
        return 1

    loaded = [yuv.load_input(p) for p in paths]
    fmt = loaded[0][1]
    if any(f is not fmt for _, f in loaded):
        print("all inputs must share one picture format", file=sys.stderr)
        return 1
    tmin = min(fr["y"].shape[0] for fr, _ in loaded)
    batch = {
        k: np.stack([fr[k][:tmin] for fr, _ in loaded])
        for k in ("y", "cb", "cr")
    }

    cfg = enc.EncoderConfig(
        fmt=fmt, search=max(args.search, 0), intra_only=args.search <= 0,
        # production batch encode never fetches recon planes; not emitting
        # them saves (T,H,W)x3 device memory per stream
        emit_recon=False,
        rate=RateConfig(bit_rate=args.rate, frame_rate=args.frame_rate,
                        fixed_quant=args.quant))
    n = len(paths)
    t0 = time.time()
    streams = encode_resilient(
        cfg, batch, mesh, retries=args.retries, chunk=args.chunk,
        log=lambda s: print(f"batch_encode: {s}", file=sys.stderr))
    dt = time.time() - t0
    os.makedirs(args.outdir, exist_ok=True)
    failed = []
    total_bits = 0
    for path, res in zip(paths, streams):
        if res is None:
            failed.append(path)
            continue
        data, nbits = res
        total_bits += nbits
        out = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(path))[0] + ".p64")
        with open(out, "wb") as f:
            f.write(data)
        if args.verbose:
            print(f"{out}: {nbits} bits")
    mbs = n * tmin * fmt.num_mbs
    print(f"{n} streams x {tmin} frames ({fmt.name}), {total_bits} total "
          f"bits, device time {dt:.2f}s ({mbs / dt:.0f} MB/s)")
    if failed:
        print(f"{len(failed)} stream(s) FAILED after retries: "
              + " ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
