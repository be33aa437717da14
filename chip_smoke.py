#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`p64tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card, nvcc
and PyTorch built for CUDA; it needs no JAX and imports nothing of the JAX
package's device code.  Phases, one line each, any failure ends the run
with a non-zero exit and no result line:

  1. device   -- nvidia-smi name and power limit, torch's device name
  2. build    -- nvcc-builds the kernel library, all five kernels, from
                 p64tpu_torch/csrc/sad_search.cu, and, at the same time,
                 g++-builds the bit-I/O engine from p64tpu/native/bitio.cpp
  3. parity   -- CIF, search 15, 4 streams, three kinds of content: the
                 SAD-search kernel's map equals the plain torch map and an
                 int64 numpy oracle; its fused (mv, best_sad, sad0) equals
                 the plain full search
  4. pins     -- all thirteen pinned streams (fixed quantizer, rate
                 control, MQUANT), encoded on the card, match their sha256
                 in tests/pinned_goldens.json
  5. gate     -- the hardware parity gate (p64tpu_torch.tools.parity) in
                 this process: every SAD formulation and kernel against an
                 int64 oracle, the DCT, and the gate's encodes byte-identical
                 on the card and the CPU; it must print PARITY PASS, and
                 each of the four SAD-map kernels must have been launched
  6. headline -- the benchmark content (128 CIF streams x 32 frames, q=10,
                 search 15) encoded on the card and serialized by the native
                 engine, one thread per stream; the device bit total equals
                 the serializer's count and the JAX package's figure, the
                 first streams' bytes equal the Python serializer's, and
                 the SAD-search kernel was launched on every frame
  7. timing   -- at the headline shape, the SAD kernel's (mv, best_sad,
                 sad0) equals the plain torch map + argmin; then both are
                 timed
  8. maps     -- at the headline shape, each SAD-map kernel's map equals
                 its plain version's; then each is timed beside its plain
                 version and beside the SAD-search kernel's map mode
  9. decode   -- the 128 headline streams parsed (native engine, one thread
                 per stream) and decoded on the card in one batch; every
                 plane equals the encoder's reconstruction; parse ms,
                 reconstruct ms and decode MB/s
 10. mix      -- the JAX decode benchmark's mixed content (16 CIF streams x
                 32 frames: fixed q, stuffing-heavy and MQUANT rate control)
                 encoded on the card, decoded on the card, held to the
                 encoder's reconstruction, timed as phase 9
 11. pinsdec  -- the thirteen pinned streams decode identically on the card
                 and on the CPU

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
#: the JAX decode benchmark's shape (bench.py measure_decode)
MIX_STREAMS, MIX_FRAMES = 16, 32
#: Python serializer's bytes are checked against the native engine's on
#: this many headline streams
ORACLE_STREAMS = 4
#: the one kernel source, p64tpu_torch/csrc/<name>.cu
KERNEL_LIB = "sad_search"
#: SAD-map kernel -> line of the TPU kernel body it replaces in
#: p64tpu/kernels/me_pallas.py
MAP_KERNELS = {"sad_map_f32": 49, "sad_map_rp": 239, "sad_map_i8": 331,
               "sad_map_swar": 413}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bench_content(fmt, streams: int, frames_t: int, noise: int = 5):
    """The JAX benchmark's deterministic content (bench.py `make_content`):
    `noise` sets the per-pixel texture amplitude, 5 for the encode
    headline, 40 for the decode mix's rate-controlled groups."""
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
            ys[s, t] = np.clip(b + rng.integers(0, noise, (h, w)), 0, 255)
    return dict(y=ys, cb=(ys[:, :, ::2, ::2] // 2 + 64).astype(np.uint8),
                cr=(255 - ys[:, :, 1::2, ::2] // 2).astype(np.uint8))


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


def check_pins(dev) -> dict:
    """Encode every pinned configuration on `dev` and hold it to its
    sha256; returns name -> stream bytes."""
    from p64tpu_torch.tools import pinned

    want = pinned.pinned_hashes()
    streams = {}
    for name, data in pinned.pinned_streams(dev):
        digest = hashlib.sha256(data).hexdigest()
        if digest != want[name]:
            raise AssertionError(f"pin {name}: sha256 {digest} != pinned "
                                 f"{want[name]}")
        log(f"[pins] {name}: {len(data)} bytes, sha256 matches")
        streams[name] = data
    return streams


def build_all() -> None:
    """Build the kernel library (nvcc) and the bit-I/O engine (g++) at the
    same time, one compiler process each."""
    from concurrent.futures import ThreadPoolExecutor

    from p64tpu_torch.kernels import _build
    from p64tpu_torch.native import load

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        kernels = pool.submit(timed, lambda: _build.load(KERNEL_LIB))
        native = pool.submit(timed, load)
        log(f"[build] {KERNEL_LIB}.cu built and loaded in "
            f"{kernels.result():.2f} s; bit-I/O engine (bitio.cpp) in "
            f"{native.result():.2f} s")


def gate() -> dict:
    """Run the hardware parity gate in this process; returns the launches
    of each SAD-map kernel counted during it."""
    from p64tpu_torch.kernels import me_variants_cuda
    from p64tpu_torch.tools import parity

    for name in me_variants_cuda.LAUNCHES:
        me_variants_cuda.LAUNCHES[name] = 0
    rc = parity.main([])
    launches = dict(me_variants_cuda.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"parity gate failed (exit {rc})")
    missing = [n for n in MAP_KERNELS if launches.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"the parity gate launched no {missing}")
    log(f"[gate] PARITY PASS; SAD-map kernel launches {launches}")
    return launches


def map_kernels(cur, ref, card: str) -> dict:
    """Each SAD-map kernel against its plain version on (S, H, W) planes:
    equal maps, then both timed with CUDA events beside the SAD-search
    kernel's map mode.  Returns name -> {max_abs_err, ms, plain_ms}."""
    import torch

    from p64tpu_torch.kernels import me_cuda, me_variants

    out = {}
    for name in MAP_KERNELS:
        kernel, plain = me_variants.VARIANTS[name]
        got = kernel(cur, ref, SEARCH)
        torch.cuda.synchronize()
        want = plain(cur, ref, SEARCH)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} != "
                                 f"plain {want.dtype}{tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"the headline shape: max |err| {err}")
        del got, want
        out[name] = {"max_abs_err": err}
    k2_map, rounds = [], 2
    for name in MAP_KERNELS:
        kernel, plain = me_variants.VARIANTS[name]
        k_ms, p_ms = [], []
        for _ in range(rounds):
            k_ms.append(cuda_ms(lambda: kernel(cur, ref, SEARCH), 20))
            p_ms.append(cuda_ms(lambda: plain(cur, ref, SEARCH), 2))
            k2_map.append(cuda_ms(lambda: me_cuda.sad_search_cuda(
                cur, ref, SEARCH, with_map=True), 20))
        out[name].update(ms=min(k_ms), plain_ms=min(p_ms))
        log(f"[maps] {name} {tuple(cur.shape)} s={SEARCH}: map == plain; "
            f"kernel {min(k_ms):.3f} ms, plain {min(p_ms):.3f} ms per call "
            f"on {card}")
    log(f"[maps] sad_search map mode (A/B reference): {min(k2_map):.3f} ms "
        f"per call on {card}")
    return out


def headline(dev, dev_frames, card: str):
    """Encode the benchmark content on `dev` through the port's main path
    and serialize it, check both, print the device wall time and the
    serialize time; returns (SAD kernel launches counted during the
    encode, the encoder outputs, the stream bytes)."""
    import torch

    from p64tpu.spec.constants import CIF
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.entropy.encode import serialize_sequence_py
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
    serialized = enc.serialize_streams(cfg, outputs)
    t_ser = time.perf_counter() - t0
    ser_bits = sum(nbits for _, nbits in serialized)
    datas = [b for b, _ in serialized]
    t0 = time.perf_counter()
    head = enc.outputs_to_symbols(
        cfg, {k: v[:ORACLE_STREAMS] for k, v in outputs.items()})
    for si, syms in enumerate(head):
        if serialize_sequence_py(CIF, syms)[0] != datas[si]:
            raise AssertionError(f"stream {si}: native serializer bytes != "
                                 "Python serializer bytes")
    t_py = time.perf_counter() - t0
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
        f"{psnr:.2f} dB; sad_search launches {launches}")
    log(f"[headline] native serialize of {n_streams} streams, one thread "
        f"each: {t_ser:.3f} s; first {ORACLE_STREAMS} streams' bytes == "
        f"Python serializer's ({t_py:.3f} s for those {ORACLE_STREAMS})")
    return launches, outputs, datas


def decode_mix(dev, streams: int, frames_t: int):
    """Encode the JAX decode benchmark's mixed content (bench.py
    `_make_decode_content`) with the port on `dev`, search 15: half the
    streams at a fixed quantizer, one in 16 at 4 Mbit/s (mostly MBA
    stuffing fill), the rest at 2 Mbit/s with mid-GOB MQUANT segments;
    texture noise 5 for the first group, 40 for the others.  Every frame
    must be coded, and the mix must hold stuffing and MQUANT MBs.
    Returns (stream bytes, recon planes (y, cb, cr) as (S, T, ...)
    tensors on dev, stuffing codes, MQUANT MBs)."""
    import numpy as np
    import torch

    from p64tpu.spec.constants import CIF
    from p64tpu.spec.luts import MTYPE_MQUANT
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc

    datas, recons, n_stuff, n_mq = [], [], 0, 0
    mq_types = torch.as_tensor(np.flatnonzero(MTYPE_MQUANT), device=dev)
    n_a = streams // 2
    n_b = max(1, streams // 16)
    groups = ((n_a, dict(fixed_quant=HEADLINE_QUANT), 5),
              (n_b, dict(bit_rate=4_000_000, frame_rate=30), 40),
              (streams - n_a - n_b,
               dict(bit_rate=2_000_000, frame_rate=30, mquant_segments=3,
                    initial_quant=12), 40))
    for n, rate, noise in groups:
        cfg = enc.EncoderConfig(fmt=CIF, search=SEARCH,
                                rate=RateConfig(**rate))
        data, outputs, _ = enc.encode_to_bytes(
            cfg, bench_content(CIF, n, frames_t, noise), device=dev)
        if not bool(outputs["frame_coded"].all()):
            raise AssertionError(f"decode mix group {rate} skipped frames")
        n_stuff += int(outputs["n_stuff"].sum())
        n_mq += int(torch.isin(outputs["mtype"], mq_types).sum())
        datas.extend(data)
        recons.append([outputs[k] for k in ("recon_y", "recon_cb",
                                            "recon_cr")])
    if n_stuff == 0 or n_mq == 0:
        raise AssertionError(f"decode mix holds {n_stuff} stuffing codes and "
                             f"{n_mq} MQUANT MBs; both must be present")
    return (datas, tuple(torch.cat(p) for p in zip(*recons)), n_stuff,
            n_mq)


def decode_check(what: str, datas, recon, dev, card: str) -> dict:
    """Parse `datas` (native engine, one thread per stream) and decode
    them on `dev` in one batch; every plane must equal `recon` ((y, cb,
    cr) (S, T, ...) tensors).  Prints and returns the parse, decode and
    reconstruct times and the end-to-end MB/s."""
    import numpy as np
    import torch

    from p64tpu_torch.core import decoder
    from p64tpu_torch.native import load
    from p64tpu_torch.utils import fan_map

    load()
    t0 = time.perf_counter()
    parsed = fan_map(decoder.parse_to_tensors, datas)
    t_parse = time.perf_counter() - t0
    fmt = parsed[0][0]
    seqs = [seq for _, _, seq in parsed]
    t0 = time.perf_counter()
    planes = decoder.decode_seq_batch(fmt, seqs, device=dev)
    t_dec = time.perf_counter() - t0
    for i, p in enumerate(planes):
        for name, got, want in zip(("y", "cb", "cr"), p, recon):
            if not np.array_equal(got, want[i].cpu().numpy()):
                raise AssertionError(f"[{what}] stream {i}: decoded {name} "
                                     "!= encoder reconstruction")
    # the decode's parts: host stack + one copy to the card, then the
    # frame loop on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = decoder.stack_seqs(fmt, seqs, dev)
    torch.cuda.synchronize()
    t_stack = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_planes = decoder.reconstruct_seq(fmt, batch)
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(dev_planes, recon)):
        raise AssertionError(f"[{what}] reconstruct_seq planes != encoder "
                             "reconstruction")
    s, t = recon[0].shape[:2]
    n_mb = s * t * fmt.num_mbs
    rate = n_mb / (t_parse + t_dec)
    log(f"[{what}] {s}x{t} {fmt.name}: decoded planes == encoder recon; "
        f"parse {t_parse * 1e3:.1f} ms ({sum(map(len, datas))} bytes), "
        f"decode_seq_batch {t_dec * 1e3:.1f} ms (stack + copy to card "
        f"{t_stack * 1e3:.1f} ms, reconstruct {t_rec * 1e3:.1f} ms), "
        f"parse + decode {rate:.0f} MB/s on {card}")
    return dict(parse_ms=t_parse * 1e3, decode_ms=t_dec * 1e3,
                reconstruct_ms=t_rec * 1e3, mb_per_s=rate)


def pins_decoded(pins: dict, dev) -> None:
    """Each pinned stream decodes to the same planes on `dev` and on the
    CPU through the port."""
    import numpy as np

    from p64tpu_torch.core.decoder import decode_stream

    for name, data in pins.items():
        on_card = decode_stream(data, device=dev)
        on_cpu = decode_stream(data, device="cpu")
        for got, want in zip(on_card[:3], on_cpu[:3]):
            if not np.array_equal(got, want):
                raise AssertionError(f"pin {name}: card decode != CPU decode")
        log(f"[pinsdec] {name}: {on_card[0].shape[0]} frames, card decode "
            "== CPU decode")


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
    from p64tpu_torch.kernels import me, me_cuda
    from p64tpu_torch.tools.parity import sad_oracle

    dev = torch.device("cuda", 0)

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {card} | torch: {kind} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    build_all()

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
    pins = check_pins(dev)

    # 5. the parity gate, with its kernels' launches counted
    map_launches = gate()

    # 6. headline shape
    frames = bench_content(CIF, HEADLINE_STREAMS, HEADLINE_FRAMES)
    dev_frames = {k: torch.as_tensor(v, device=dev) for k, v in frames.items()}
    launches, outputs, datas = headline(dev, dev_frames, card)
    if launches < HEADLINE_FRAMES:
        raise AssertionError(f"SAD kernel launched {launches} times in the "
                             f"headline encode, expected >= "
                             f"{HEADLINE_FRAMES}")

    # 7. kernel against plain at the headline shape (frame 1 against
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

    # 8. the SAD-map kernels at the headline shape
    maps = map_kernels(cur, ref, card)

    # 9. decode the headline streams on the card
    decode_check("decode", datas, tuple(outputs[k] for k in (
        "recon_y", "recon_cb", "recon_cr")), dev, card)

    # 10. the decode benchmark's mix, encoded and decoded on the card
    mix, mix_recon, n_stuff, n_mq = decode_mix(dev, MIX_STREAMS, MIX_FRAMES)
    log(f"[mix] {len(mix)} CIF streams x {MIX_FRAMES} frames encoded: "
        f"{n_stuff} stuffing codes, {n_mq} MQUANT MBs")
    decode_check("mix", mix, mix_recon, dev, card)

    # 11. the pins decoded on the card and on the CPU
    pins_decoded(pins, dev)

    log(card)
    kernels = [{
        "name": "sad_search", "route": "cuda",
        "source": f"p64tpu_torch/csrc/{KERNEL_LIB}.cu",
        "replaces": "p64tpu/kernels/me_pallas.py:128",
        "launches": launches, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms)}]
    for name, replaces in MAP_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"p64tpu_torch/csrc/{KERNEL_LIB}.cu",
            "replaces": f"p64tpu/kernels/me_pallas.py:{replaces}",
            "launches": map_launches[name], **maps[name]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
