#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`p64tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card, nvcc
and PyTorch built for CUDA; it needs no JAX and imports nothing of the JAX
package's device code.  Phases, one line each, any failure ends the run
with a non-zero exit and no result line:

  1. device   -- nvidia-smi name and power limit, torch's device name
  2. build    -- nvcc-builds the SAD-search kernel from p64tpu_torch/csrc
  3. parity   -- CIF, search 15, 4 streams, three kinds of content: the
                 kernel's SAD map equals the plain torch map and an int64
                 numpy oracle; its fused (mv, best_sad, sad0) equals the
                 plain full search
  4. pins     -- the six fixed-quantizer pinned streams, encoded on the
                 card, match their sha256 in tests/pinned_goldens.json
  5. headline -- the benchmark content (128 CIF streams x 32 frames, q=10,
                 search 15) encoded on the card; the device bit total equals
                 the serializer's count and the JAX package's figure, and
                 the kernel was launched on every frame
  6. timing   -- at the headline shape, the SAD kernel's (mv, best_sad,
                 sad0) equals the plain torch map + argmin; then both are
                 timed

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: total bits of the headline encode (128 CIF streams x 32 frames, q=10,
#: search 15, benchmark content), from the JAX package's encoder
HEADLINE_BITS = 29_547_313
HEADLINE_STREAMS, HEADLINE_FRAMES, HEADLINE_QUANT = 128, 32, 10
PARITY_STREAMS = 4
SEARCH = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bench_content(fmt, streams: int, frames_t: int):
    """The encode benchmark's deterministic content (bench.py `measure`)."""
    import numpy as np
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
            ys[s, t] = np.clip(b + rng.integers(0, 5, (h, w)), 0, 255)
    return dict(y=ys, cb=(ys[:, :, ::2, ::2] // 2 + 64).astype(np.uint8),
                cr=(255 - ys[:, :, 1::2, ::2] // 2).astype(np.uint8))


def sad_oracle(cur, ref, search: int):
    """int64 numpy SAD map (S, (2s+1)^2, nMB), invalid offsets 1<<30."""
    import numpy as np
    s, h, w = cur.shape
    r, c = h // 16, w // 16
    cur = cur.astype(np.int64)
    pad = np.pad(ref.astype(np.int64), ((0, 0), (search, search),
                                        (search, search)))
    side = 2 * search + 1
    out = np.empty((s, side * side, r * c), np.int64)
    y0 = (np.arange(r * c) // c) * 16
    x0 = (np.arange(r * c) % c) * 16
    for i, (dy, dx) in enumerate((dy, dx) for dy in range(-search, search + 1)
                                 for dx in range(-search, search + 1)):
        win = pad[:, search + dy:search + dy + h, search + dx:search + dx + w]
        box = np.abs(cur - win).reshape(s, r, 16, c, 16).sum(axis=(2, 4))
        valid = ((y0 + dy >= 0) & (y0 + dy + 16 <= h) & (x0 + dx >= 0)
                 & (x0 + dx + 16 <= w))
        out[:, i] = np.where(valid, box.reshape(s, -1), 1 << 30)
    return out


def parity_planes(kind: str, streams: int, h: int, w: int):
    import numpy as np
    rng = np.random.default_rng({"random": 1, "periodic": 2, "near": 3}[kind])
    if kind == "random":
        return (rng.integers(0, 256, (streams, h, w)).astype(np.uint8),
                rng.integers(0, 256, (streams, h, w)).astype(np.uint8))
    if kind == "periodic":
        # every 8-pel shift is an exact SAD tie (golden_content "periodic")
        yy, xx = np.mgrid[0:h, 0:w]
        per = ((xx % 8 < 4) ^ (yy % 8 < 4)).astype(np.uint8) * 180 + 40
        cur = np.stack([np.roll(per, i + 1, axis=1) for i in range(streams)])
        ref = np.stack([np.roll(per, i, axis=0) for i in range(streams)])
        return cur.astype(np.uint8), ref.astype(np.uint8)
    base = rng.integers(0, 256, (streams, h, w))
    base[:, 64:192, 96:256] = 77                 # flat patch: many ties
    ref = np.clip(base + rng.integers(-2, 3, base.shape), 0, 255)
    return base.astype(np.uint8), ref.astype(np.uint8)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_fused(kernel, plain, what: str) -> int:
    """Hold the kernel's (mv, best_sad, sad0) to the plain full search's;
    returns the largest absolute difference (0, or it raises)."""
    for name, a, b in zip(("mv", "best_sad", "sad0"), kernel, plain):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"fused {name}: {a.dtype}{tuple(a.shape)} "
                                 f"!= plain {b.dtype}{tuple(b.shape)}")
        err = int((a.long() - b.long()).abs().max())
        if err:
            raise AssertionError(f"fused {name} differs from the plain full "
                                 f"search on {what} content: max |err| {err}")
    return 0


def check_pins(dev) -> None:
    """Encode the fixed-quantizer pinned configurations on `dev` and hold
    them to their sha256."""
    from p64tpu_torch.tools import pinned

    want = pinned.pinned_hashes()
    for name, data in pinned.pinned_streams(dev):
        digest = hashlib.sha256(data).hexdigest()
        if digest != want[name]:
            raise AssertionError(f"pin {name}: sha256 {digest} != pinned "
                                 f"{want[name]}")
        log(f"[pins] {name}: {len(data)} bytes, sha256 matches")


def headline(dev, dev_frames, card: str) -> int:
    """Encode the benchmark content on `dev` through the port's main path,
    check it, print the device wall time; returns the SAD kernel launches
    counted during the encode."""
    import torch

    from p64tpu.spec.constants import CIF
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.entropy.encode import serialize_sequence
    from p64tpu_torch.kernels import me_cuda

    n_streams, n_frames = dev_frames["y"].shape[:2]
    cfg = enc.EncoderConfig(fmt=CIF, search=SEARCH,
                            rate=RateConfig(fixed_quant=HEADLINE_QUANT))
    # warm-up on two frames (allocator, library handles), not counted
    enc.encode_sequence(cfg, {k: v[:, :2] for k, v in dev_frames.items()},
                        device=dev)
    torch.cuda.synchronize()

    me_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    _, outputs = enc.encode_sequence(cfg, dev_frames, device=dev)
    device_bits = int(outputs["total_bits"].sum())       # synchronizes
    t_dev = time.perf_counter() - t0
    launches = me_cuda.LAUNCHES

    t0 = time.perf_counter()
    streams = enc.outputs_to_symbols(cfg, outputs)
    ser_bits = sum(serialize_sequence(CIF, syms)[1] for syms in streams)
    t_ser = time.perf_counter() - t0
    want = (n_streams, n_frames, CIF.num_mbs, 6, 64)
    if tuple(outputs["levels8"].shape) != want:
        raise AssertionError(f"levels8 shape {tuple(outputs['levels8'].shape)}"
                             f" != {want}")
    sse = outputs["sse_y"].double()
    if not bool(torch.isfinite(sse).all()):
        raise AssertionError("non-finite sse_y")
    psnr = float((10 * torch.log10(255.0 ** 2 * CIF.width * CIF.height
                                   / sse.clamp(min=1))).mean())
    if device_bits != ser_bits:
        raise AssertionError(f"device bit total {device_bits} != serializer "
                             f"{ser_bits}")
    if device_bits != HEADLINE_BITS:
        raise AssertionError(f"headline bit total {device_bits} != "
                             f"{HEADLINE_BITS} from the JAX package")
    n_mb = n_streams * n_frames * CIF.num_mbs
    log(f"[headline] {n_streams}x{n_frames} CIF q={HEADLINE_QUANT} "
        f"s={SEARCH}: device encode {t_dev * 1e3:.1f} ms wall = "
        f"{n_mb / t_dev:.0f} MB/s on {card}; total bits {device_bits} == "
        f"serializer == JAX figure; mean Y PSNR "
        f"{psnr:.2f} dB; host serialize {t_ser:.1f} s; sad_search launches "
        f"{launches}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this "
              "smoke run needs a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "p64tpu_torch")):
        print(f"chip_smoke: no p64tpu_torch package next to {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    import numpy as np

    from p64tpu.spec.constants import CIF
    from p64tpu_torch.kernels import _build, me, me_cuda

    dev = torch.device("cuda", 0)

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {card} | torch: {kind} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load("sad_search")
    log(f"[build] sad_search.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. SAD parity at CIF
    max_err = 0
    for kind_name in ("random", "periodic", "near"):
        cur_np, ref_np = parity_planes(kind_name, PARITY_STREAMS, CIF.height,
                                       CIF.width)
        cur = torch.as_tensor(cur_np, device=dev)
        ref = torch.as_tensor(ref_np, device=dev)
        mv_k, best_k, sad0_k, map_k = me_cuda.sad_search_cuda(
            cur, ref, SEARCH, with_map=True)
        torch.cuda.synchronize()
        map_p = me.sad_map(cur, ref, SEARCH)
        torch.cuda.synchronize()
        mv_p, best_p, sad0_p = me.search_from_map(map_p, SEARCH)
        torch.cuda.synchronize()
        oracle = sad_oracle(cur_np, ref_np, SEARCH)
        got = map_k.cpu().numpy().astype(np.int64)
        err = max(int(np.abs(got - map_p.cpu().numpy()).max()),
                  int(np.abs(got - oracle).max()))
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"SAD map mismatch on {kind_name} content: "
                                 f"max |err| {err}")
        max_err = max(max_err, check_fused((mv_k, best_k, sad0_k),
                                           (mv_p, best_p, sad0_p), kind_name))
        n_ties = int((map_p == best_p[:, None, :]).sum(dim=1).gt(1).sum())
        log(f"[parity] {kind_name}: {PARITY_STREAMS}x{tuple(cur.shape[1:])} "
            f"s={SEARCH}: map == plain == int64 oracle, fused mv/best/sad0 "
            f"== plain full search ({n_ties} MBs with tied minima)")

    # 4. pins
    check_pins(dev)

    # 5. headline shape
    frames = bench_content(CIF, HEADLINE_STREAMS, HEADLINE_FRAMES)
    dev_frames = {k: torch.as_tensor(v, device=dev) for k, v in frames.items()}
    launches = headline(dev, dev_frames, card)
    if launches < HEADLINE_FRAMES:
        raise AssertionError(f"SAD kernel launched {launches} times in the "
                             f"headline encode, expected >= "
                             f"{HEADLINE_FRAMES}")

    # 6. kernel against plain at the headline shape (frame 1 against
    # frame 0): equal outputs, then time
    cur = dev_frames["y"][:, 1].contiguous()
    ref = dev_frames["y"][:, 0].contiguous()
    fused_k = me_cuda.sad_search_cuda(cur, ref, SEARCH)
    torch.cuda.synchronize()
    fused_p = me.search_from_map(me.sad_map(cur, ref, SEARCH), SEARCH)
    torch.cuda.synchronize()
    max_err = max(max_err, check_fused(fused_k, fused_p, "headline"))
    log(f"[timing] sad_search {HEADLINE_STREAMS}x CIF s={SEARCH}: fused "
        f"mv/best/sad0 == plain full search")
    kernel_ms, plain_ms = [], []
    for _ in range(2):
        kernel_ms.append(cuda_ms(
            lambda: me_cuda.sad_search_cuda(cur, ref, SEARCH), 20))
        plain_ms.append(cuda_ms(
            lambda: me.search_from_map(me.sad_map(cur, ref, SEARCH), SEARCH),
            3))
    log(f"[timing] sad_search {HEADLINE_STREAMS}x CIF s={SEARCH}: kernel "
        f"{min(kernel_ms):.3f} ms, plain torch map+argmin "
        f"{min(plain_ms):.3f} ms per call on {card}")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "sad_search", "route": "cuda",
        "source": "p64tpu_torch/csrc/sad_search.cu",
        "replaces": "p64tpu/kernels/me_pallas.py:128",
        "launches": launches, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms)}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
