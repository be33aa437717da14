#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`p64tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card, nvcc
and PyTorch built for CUDA; it needs no JAX and imports nothing of JAX or
of the JAX package (`p64tpu`).  Phases, one line each, any failure ends the
run with a non-zero exit and no result line:

  1. device   -- nvidia-smi name and power limit, torch's device name
  2. build    -- nvcc-builds the kernel library, all five kernels, from
                 p64tpu_torch/csrc/sad_search.cu, and, at the same time,
                 g++-builds the bit-I/O engine from
                 p64tpu_torch/csrc/bitio.cpp; prints each kernel's ptxas
                 registers, shared memory and spills, and from its SASS
                 (cuobjdump -sass) the count of VABSDIFF4, IDP.4A, S8 IMMA,
                 FADD, 16x2 min/max, LDS and STG instructions; fails if the
                 SWAR kernel holds byte SIMD, the f32 kernel an integer
                 SAD instruction, or the int8 kernel no signed int8 pool
                 (IDP.4A or IMMA on S8) or an accumulating VABSDIFF4
  3. parity   -- CIF, search 15, 4 streams, three kinds of content: the
                 SAD-search kernel's map equals the plain torch map and an
                 int64 numpy oracle; its fused (mv, best_sad, sad0) equals
                 the plain full search
  4. pins     -- all thirteen pinned streams (fixed quantizer, rate
                 control, MQUANT), encoded on the card through
                 tools.pinned.current_hashes, match their sha256 and length
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
                 timed, beside the kernel's bound and its share of it
  8. maps     -- at the headline shape, each SAD-map kernel's map equals
                 its plain version's; then each is timed beside its plain
                 version, its bound and the SAD-search kernel's map mode
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
 12. batch    -- the headline frames through the resilient batch encoder
                 (tools.batch_encode.encode_resilient) on the card, in
                 pipelined 32-stream chunks: every stream's bytes equal
                 phase 6's, also when chunk 2's first dispatch fails; the
                 SAD-search kernel is launched on every frame of every
                 chunk; chunk=0 and chunk=32 timed on the wall clock in
                 turns; then the batch_encode CLI on a few .y4m files
                 equals encode_to_bytes
 13. checkpoint -- the headline's first 16 frames encoded and checkpointed
                 (io.checkpoint), loaded onto the card, the last 16 encoded
                 from it: every output equals phase 6's frames 16-31 and
                 the halves' bits sum to phase 6's
 14. multihost -- two processes over torch.distributed (gloo), both on
                 this card, each encoding 64 of the 128 headline streams
                 (distrib.multihost): both see the all-reduced bit total,
                 the all-gathered lengths and their bytes equal phase 6's;
                 then one NCCL process (world size 1) on a small batch
 15. profile  -- tools.profile on the card with a trace: exit 0, a Chrome
                 trace and the table of operators by self CUDA time
 16. resync   -- damaged copies of the thirteen pinned streams (the
                 reference fuzzer's four corruption modes, seeded) decoded
                 with resync: decode_stream on the card and on the CPU, and
                 parse_to_tensors + decode_seq on the card, give the same
                 refusal or equal planes

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --multihost-worker '{"backend": ...}'

runs one worker of phase 14; the phase starts them itself.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
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
#: damaged copies of each pinned stream in the resync phase, and their seed
RESYNC_PER_PIN, RESYNC_SEED = 8, 16
#: SAD-map kernel -> line of the TPU kernel body it replaces in
#: p64tpu/kernels/me_pallas.py
MAP_KERNELS = {"sad_map_f32": 49, "sad_map_rp": 239, "sad_map_i8": 331,
               "sad_map_swar": 413}
#: streams per pipelined chunk of the batch phase, and how many of the
#: headline streams go through the batch_encode CLI
BATCH_CHUNK, CLI_STREAMS = 32, 3
#: processes of the gloo run, and the NCCL run's batch (streams, frames)
GLOO_WORLD, NCCL_BATCH = 2, (8, 4)
#: seconds a phase-14 worker may take before every worker is killed
WORKER_TIMEOUT = 300
#: the profile phase's batch (streams, frames)
PROFILE_BATCH = (8, 4)
#: the bound's rates: integer lanes per SM, each taking one VABSDIFF4 (4
#: byte abs-diffs, accumulated) per clock (NVIDIA Hopper architecture
#: whitepaper: 64 INT32 lanes per SM), and device memory bytes per second
#: (H100 SXM data sheet)
INT_LANES_PER_SM, ABSDIFFS_PER_LANE = 64, 4
MEMORY_BYTES_PER_S = 3.35e12
#: ptxas's and cuobjdump's mangled kernel names -> the kernels' names
PTXAS_KERNELS = (("sad_search_kernelILb0", "sad_search"),
                 ("sad_search_kernelILb1", "sad_search map mode"),
                 ("sad_map_f32_kernel", "sad_map_f32"),
                 ("sad_map_rp_kernel", "sad_map_rp"),
                 ("sad_map_i8_kernel", "sad_map_i8"),
                 ("sad_map_swar_kernel", "sad_map_swar"))
#: SASS opcode classes counted per kernel in phase 2 (name -> test on the
#: opcode with its modifiers)
SASS_CLASSES = {
    "VABSDIFF4": lambda op: op.startswith("VABSDIFF4"),
    "VABSDIFF4.ACC": lambda op: op.startswith("VABSDIFF4") and ".ACC" in op,
    "IDP4A": lambda op: op.startswith("IDP.4A"),
    "IDP4A.S8": lambda op: op.startswith("IDP.4A") and ".S8" in op,
    "IMMA.S8": lambda op: op.startswith("IMMA") and ".S8" in op,
    "FADD": lambda op: op.split(".")[0] == "FADD",
    "MNMX16x2": lambda op: "MNMX" in op and "16x2" in op,
    "LDS": lambda op: op.split(".")[0] == "LDS",
    "STG": lambda op: op.split(".")[0] == "STG",
}
#: SASS classes a kernel's formulation forbids: K5 is SWAR without byte
#: SIMD, K1 float abs-diff without an integer SAD instruction, K4 pools
#: apart from its abs-diffs (no VABSDIFF4 that accumulates)
SASS_FORBIDDEN = {"sad_map_swar": ("VABSDIFF4", "IDP4A"),
                  "sad_map_f32": ("VABSDIFF4", "IDP4A"),
                  "sad_map_i8": ("VABSDIFF4.ACC",)}
#: SASS classes of which a kernel's formulation needs at least one: K4's
#: signed int8 pool, on the tensor cores or by dot product
SASS_REQUIRED = {"sad_map_i8": ("IMMA.S8", "IDP4A.S8")}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def sad_bound(cur, search: int, out_bytes: int, clock_hz: float) -> dict:
    """The least time the card could take for the SAD work on (S, H, W)
    planes: the abs-diffs of every (offset, MB) pair whose window lies
    inside the picture, 4 per VABSDIFF4 on every integer lane of every SM
    at the highest clock, against the bytes of both planes read once and
    `out_bytes` written once.  Returns bound_ms, bound_by and the counts."""
    import numpy as np
    import torch

    s, h, w = cur.shape
    d = np.arange(-search, search + 1)
    # per MB row (column): the dy (dx) whose window stays inside
    rows = [int(((y0 + d >= 0) & (y0 + d + 16 <= h)).sum())
            for y0 in range(0, h, 16)]
    cols = [int(((x0 + d >= 0) & (x0 + d + 16 <= w)).sum())
            for x0 in range(0, w, 16)]
    absdiffs = s * sum(rows) * sum(cols) * 256
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_ms = absdiffs / (ABSDIFFS_PER_LANE * INT_LANES_PER_SM * sms
                         * clock_hz) * 1e3
    nbytes = 2 * s * h * w + out_bytes
    bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                absdiffs=absdiffs, bytes=nbytes, ops_ms=ops_ms,
                bytes_ms=bytes_ms)


def ptxas_summary(lines) -> dict:
    """Kernel name -> {registers, spill_bytes, smem_bytes} from the ptxas
    lines of the kernel library's build."""
    import re

    out, name = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((n for key, n in PTXAS_KERNELS if key in m.group(1)),
                        m.group(1))
            out[name] = dict(registers=None, spill_bytes=0, smem_bytes=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def sass_opcodes(library: str) -> dict:
    """Kernel name -> list of SASS opcodes (with modifiers) of each kernel
    in `library`, from `cuobjdump -sass` beside nvcc; raises if the tool
    is missing or fails."""
    import re

    from p64tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        raise AssertionError(f"no cuobjdump at {tool}: phase 2 reads the "
                             "kernels' SASS with it")
    r = subprocess.run([tool, "-sass", library], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"cuobjdump -sass {library} exit "
                             f"{r.returncode}: {r.stderr[-2000:]}")
    out, name = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((n for key, n in PTXAS_KERNELS if key in m.group(1)),
                        m.group(1))
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name is not None:
            out[name].append(m.group(2))
    return out


def sass_summary() -> dict:
    """Print, per kernel of the library, its SASS instruction count and the
    count of each SASS_CLASSES class; fail if a kernel holds a class its
    formulation forbids or none of those it needs.  Returns kernel name ->
    counts."""
    from p64tpu_torch.kernels import _build

    ops = sass_opcodes(os.path.join(_build.BUILD_DIR, KERNEL_LIB + ".so"))
    counts = {}
    for _, name in PTXAS_KERNELS:
        if name not in ops:
            raise AssertionError(f"no SASS for {name} in {KERNEL_LIB}.so")
        c = {k: sum(map(test, ops[name])) for k, test in SASS_CLASSES.items()}
        c["instructions"] = len(ops[name])
        counts[name] = c
        log(f"[build] sass {name}: " + ", ".join(f"{k} {v}"
                                                 for k, v in c.items()))
    for name, forbidden in SASS_FORBIDDEN.items():
        found = {k: counts[name][k] for k in forbidden if counts[name][k]}
        if found:
            raise AssertionError(f"{name}'s SASS holds {found}, which its "
                                 "formulation forbids")
    for name, needed in SASS_REQUIRED.items():
        if not any(counts[name][k] for k in needed):
            raise AssertionError(f"{name}'s SASS holds none of {needed}, "
                                 "which its formulation needs")
    return counts


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
    """Encode every pinned configuration on `dev` through
    tools.pinned.current_hashes and hold it to the pin file's sha256 and
    length; returns name -> stream bytes."""
    from p64tpu_torch.tools import pinned

    with open(pinned.PIN_FILE) as f:
        want = json.load(f)
    streams = {}
    for name, pin in pinned.current_hashes(dev, streams).items():
        if pin != want.get(name):
            raise AssertionError(f"pin {name}: {pin} != pinned "
                                 f"{want.get(name)}")
        log(f"[pins] {name}: {pin['bytes']} bytes, sha256 matches")
    return streams


def build_all() -> dict:
    """Build the kernel library (nvcc) and the bit-I/O engine (g++) at the
    same time, one compiler process each; print and return each kernel's
    ptxas figures."""
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
    figures = ptxas_summary(_build.ptxas_report(KERNEL_LIB))
    for name, f in figures.items():
        log(f"[build] ptxas {name}: {f['registers']} registers, "
            f"{f['smem_bytes']} bytes static shared memory, "
            f"{f['spill_bytes']} bytes spilled")
    missing = [n for _, n in PTXAS_KERNELS if n not in figures]
    if missing:
        raise AssertionError(f"no ptxas figures for {missing}")
    sass = sass_summary()
    for name in figures:
        figures[name]["sass"] = sass.get(name)
    return figures


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


def map_kernels(cur, ref, card: str, clock_hz: float) -> dict:
    """Each SAD-map kernel against its plain version on (S, H, W) planes:
    equal maps, then both timed with CUDA events beside the SAD-search
    kernel's map mode and the map's bound.  Returns name -> {max_abs_err,
    ms, plain_ms, bound_ms, bound_by}."""
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
    s, h, w = cur.shape
    n_map = s * (2 * SEARCH + 1) ** 2 * (h // 16) * (w // 16)
    bound = sad_bound(cur, SEARCH, 4 * n_map, clock_hz)
    k2_map, rounds = [], 2
    for name in MAP_KERNELS:
        kernel, plain = me_variants.VARIANTS[name]
        k_ms, p_ms = [], []
        for _ in range(rounds):
            k_ms.append(cuda_ms(lambda: kernel(cur, ref, SEARCH), 20))
            p_ms.append(cuda_ms(lambda: plain(cur, ref, SEARCH), 2))
            k2_map.append(cuda_ms(lambda: me_cuda.sad_search_cuda(
                cur, ref, SEARCH, with_map=True), 20))
        out[name].update(ms=min(k_ms), plain_ms=min(p_ms),
                         bound_ms=bound["bound_ms"],
                         bound_by=bound["bound_by"])
        log(f"[maps] {name} {tuple(cur.shape)} s={SEARCH}: map == plain; "
            f"kernel {min(k_ms):.3f} ms, plain {min(p_ms):.3f} ms per call, "
            f"bound {bound['bound_ms']:.3f} ms by {bound['bound_by']} "
            f"({bound['bound_ms'] / min(k_ms):.1%} of it) on {card}")
    log(f"[maps] sad_search map mode (A/B reference): {min(k2_map):.3f} ms "
        f"per call, {bound['bound_ms'] / min(k2_map):.1%} of the bound, on "
        f"{card}")
    log(f"[maps] bound: {bound['absdiffs']} abs-diffs of in-picture "
        f"offsets at {INT_LANES_PER_SM * ABSDIFFS_PER_LANE} per SM per "
        f"clock and {clock_hz / 1e6:.0f} MHz = {bound['ops_ms']:.4f} ms; "
        f"{bound['bytes']} bytes at {MEMORY_BYTES_PER_S / 1e12} TB/s = "
        f"{bound['bytes_ms']:.4f} ms")
    return out


def headline(dev, dev_frames, card: str):
    """Encode the benchmark content on `dev` through the port's main path
    and serialize it, check both, print the device wall time and the
    serialize time; returns (SAD kernel launches counted during the
    encode, the encoder outputs, the stream bytes)."""
    import torch

    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.entropy.encode import serialize_sequence_py
    from p64tpu_torch.kernels import me_cuda
    from p64tpu_torch.spec.constants import CIF

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

    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.spec.constants import CIF
    from p64tpu_torch.spec.luts import MTYPE_MQUANT

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


def damaged_streams(streams: dict, per_stream: int, seed: int):
    """`per_stream` damaged copies of each of `streams` (name -> bytes), by
    the reference fuzzer's four corruption modes (tools/fuzz_differential.py)
    drawn from one seeded generator: 0 flips 1-6 bits, 1 truncates and
    flips a bit, 2 splices another stream's tail after a prefix, 3
    overwrites a span of up to 63 random bytes.  Yields (name, mode,
    bytes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = [streams[k] for k in sorted(streams)]
    for name in sorted(streams):
        for _ in range(per_stream):
            d = bytearray(streams[name])
            mode = int(rng.integers(4))
            if mode == 0:
                for _ in range(1 + int(rng.integers(6))):
                    p = int(rng.integers(len(d)))
                    d[p] ^= 1 << int(rng.integers(8))
            elif mode == 1:
                d = d[:int(rng.integers(1, len(d)))]
                if len(d) > 2:
                    p = int(rng.integers(len(d)))
                    d[p] ^= 1 << int(rng.integers(8))
            elif mode == 2:
                other = pool[int(rng.integers(len(pool)))]
                d = (d[:int(rng.integers(len(d)))]
                     + other[int(rng.integers(len(other))):])
            else:
                p = int(rng.integers(len(d)))
                n = int(rng.integers(1, 64))
                d[p:p + n] = bytes(rng.integers(0, 256, min(n, len(d) - p),
                                                dtype=np.uint8))
            yield name, mode, bytes(d)


def _planes_or_refusal(fn):
    """fn()'s (y, cb, cr) as numpy arrays, or the ValueError the stream
    drew (StreamError is one); any other error, a CUDA fault among them,
    propagates."""
    import numpy as np

    try:
        return tuple(np.asarray(p) for p in fn()[:3])
    except ValueError as e:
        return e


def resync_phase(streams: dict, dev, per_stream: int, seed: int) -> dict:
    """Phase 16: damaged copies of `streams` decoded with resync through
    decode_stream on `dev` and on the CPU, and through parse_to_tensors +
    decode_seq on `dev`.  All three must refuse (a ValueError) or give
    equal planes; a divergence raises with its first diverging plane and
    index.  Returns the counts of decoded and refused streams."""
    import numpy as np

    from p64tpu_torch.core import decoder

    def on_tensors(d):
        fmt, _, seq = decoder.parse_to_tensors(d, resync=True)
        return decoder.decode_seq(fmt, seq, device=dev)

    counts = {"decoded": 0, "refused": 0}
    for name, mode, d in damaged_streams(streams, per_stream, seed):
        got = {
            "decode_stream card": _planes_or_refusal(
                lambda: decoder.decode_stream(d, resync=True, device=dev)),
            "decode_stream cpu": _planes_or_refusal(
                lambda: decoder.decode_stream(d, resync=True, device="cpu")),
            "parse_to_tensors + decode_seq card": _planes_or_refusal(
                lambda: on_tensors(d)),
        }
        (ref_name, ref), *rest = got.items()
        what = f"{name}, mode {mode}, {len(d)} bytes"
        for path, planes in rest:
            if isinstance(ref, ValueError) or isinstance(planes, ValueError):
                if not (isinstance(ref, ValueError)
                        and isinstance(planes, ValueError)):
                    raise AssertionError(f"resync {what}: {ref_name} gave "
                                         f"{ref!r:.200}, {path} {planes!r:.200}")
                continue
            for plane, a, b in zip(("y", "cb", "cr"), ref, planes):
                if a.shape != b.shape:
                    raise AssertionError(f"resync {what}: {plane} shape "
                                         f"{a.shape} ({ref_name}) != "
                                         f"{b.shape} ({path})")
                bad = np.argwhere(a != b)
                if bad.size:
                    at = tuple(int(i) for i in bad[0])
                    raise AssertionError(
                        f"resync {what}: {plane} first differs at {at}: "
                        f"{ref_name} {a[at]}, {path} {b[at]}")
        counts["refused" if isinstance(ref, ValueError) else "decoded"] += 1
    return counts


def headline_cfg(emit_recon: bool = True):
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.spec.constants import CIF

    return enc.EncoderConfig(fmt=CIF, search=SEARCH, emit_recon=emit_recon,
                             rate=RateConfig(fixed_quant=HEADLINE_QUANT))


def batch_phase(dev, frames, datas, card: str) -> int:
    """Phase 12: the headline through encode_resilient on `dev`, chunked
    and one-shot, with and without an injected fault; then the CLI.
    Returns the SAD-search launches of the first chunked run."""
    import torch

    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.distrib import mesh as dm
    from p64tpu_torch.io import yuv
    from p64tpu_torch.kernels import me_cuda
    from p64tpu_torch.tools import batch_encode

    cfg = headline_cfg(emit_recon=False)
    mesh = dm.make_mesh(devices=[dev])
    dispatch, collect = batch_encode._dispatch_shard, batch_encode._collect
    split = {}

    def timed_dispatch(*a):
        t0 = time.perf_counter()
        try:
            return dispatch(*a)
        finally:
            split["dispatch"] += time.perf_counter() - t0

    def timed_collect(cfg_, pending):
        t0 = time.perf_counter()
        for _, event in pending:
            event.synchronize()
        t1 = time.perf_counter()
        try:
            return collect(cfg_, pending)
        finally:
            split["wait"] += t1 - t0
            split["serialize"] += time.perf_counter() - t1

    def run(chunk: int, fail_hook=None) -> float:
        split.update(dispatch=0.0, wait=0.0, serialize=0.0)
        batch_encode._dispatch_shard = timed_dispatch
        batch_encode._collect = timed_collect
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            got = batch_encode.encode_resilient(
                cfg, frames, mesh, chunk=chunk, fail_hook=fail_hook,
                log=lambda m: log(f"[batch] {m}"))
        finally:
            batch_encode._dispatch_shard = dispatch
            batch_encode._collect = collect
        wall = time.perf_counter() - t0
        lost = [i for i, g in enumerate(got) if g is None]
        if lost:
            raise AssertionError(f"batch chunk={chunk}: streams {lost} "
                                 "failed")
        if [b for b, _ in got] != datas:
            bad = [i for i, (g, d) in enumerate(zip(got, datas)) if g[0] != d]
            raise AssertionError(f"batch chunk={chunk}: bytes of streams "
                                 f"{bad[:8]} differ from phase 6's")
        bits = sum(n for _, n in got)
        if bits != HEADLINE_BITS:
            raise AssertionError(f"batch chunk={chunk}: {bits} bits != "
                                 f"{HEADLINE_BITS}")
        log(f"[batch] chunk={chunk}{' with a fault' if fail_hook else ''}: "
            f"{len(got)} streams == phase 6 bytes, {bits} bits; wall "
            f"{wall:.3f} s (dispatch {split['dispatch']:.3f} s, event wait "
            f"{split['wait']:.3f} s, serialize {split['serialize']:.3f} s) "
            f"on {card}")
        return wall

    n_streams, n_frames = frames["y"].shape[:2]
    me_cuda.LAUNCHES = 0
    chunked = [run(BATCH_CHUNK)]
    launches = me_cuda.LAUNCHES
    want = -(-n_streams // BATCH_CHUNK) * n_frames
    if launches < want:
        raise AssertionError(f"batch: SAD kernel launched {launches} times, "
                             f"expected >= {want}")
    attempts = []

    def fail_chunk2(s, e, att):
        attempts.append((s, e, att))
        if s == 2 * BATCH_CHUNK and att == 0:
            raise RuntimeError("injected fault on chunk 2's first dispatch")

    run(BATCH_CHUNK, fail_chunk2)
    if (2 * BATCH_CHUNK, 3 * BATCH_CHUNK, 1) not in attempts:
        raise AssertionError(f"batch: chunk 2 was not retried: {attempts}")
    one_shot = [run(0), run(0)]
    chunked.append(run(BATCH_CHUNK))
    log(f"[batch] chunk=0 {min(one_shot):.3f}/{max(one_shot):.3f} s, "
        f"chunk={BATCH_CHUNK} {min(chunked):.3f}/{max(chunked):.3f} s "
        f"(best/worst of 2, in turns) on {card}; sad_search launches "
        f"{launches}")

    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(CLI_STREAMS):
            paths.append(os.path.join(tmp, f"s{i}.y4m"))
            yuv.write_y4m(paths[-1], {k: v[i] for k, v in frames.items()},
                          (30, 1))
        outdir = os.path.join(tmp, "out")
        r = subprocess.run(
            [sys.executable, "-m", "p64tpu_torch.tools.batch_encode", "-o",
             outdir, "-q", str(HEADLINE_QUANT), "-i", str(SEARCH),
             "--chunk", "2", "--device", "cuda", *paths], cwd=HERE,
            capture_output=True, text=True, timeout=WORKER_TIMEOUT)
        if r.returncode != 0:
            raise AssertionError(f"batch_encode CLI exit {r.returncode}:\n"
                                 f"{r.stdout}{r.stderr}")
        want_bytes = enc.encode_to_bytes(
            cfg, {k: v[:CLI_STREAMS] for k, v in frames.items()},
            device=dev)[0]
        for i, data in enumerate(want_bytes):
            with open(os.path.join(outdir, f"s{i}.p64"), "rb") as f:
                if f.read() != data:
                    raise AssertionError(f"batch_encode CLI: s{i}.p64 != "
                                         "encode_to_bytes")
    log(f"[batch] CLI on {CLI_STREAMS} .y4m files: .p64 == encode_to_bytes; "
        f"{r.stdout.strip()}")
    return launches


def checkpoint_phase(dev, dev_frames, outputs, card: str) -> int:
    """Phase 13: encode the first half of the headline, checkpoint it,
    load it onto `dev` and encode the second half from it; returns the
    SAD-search launches of the resumed half."""
    import torch

    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.io import checkpoint
    from p64tpu_torch.kernels import me_cuda

    cfg = headline_cfg()
    half = dev_frames["y"].shape[1] // 2
    st1, out1 = enc.encode_sequence(
        cfg, {k: v[:, :half] for k, v in dev_frames.items()}, device=dev)
    first = enc.serialize_streams(cfg, out1)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        checkpoint.save(ck, st1, streams=[b for b, _ in first],
                        meta={"frames_done": half})
        t_save = time.perf_counter() - t0
        size = os.path.getsize(ck + ".npz")
        t0 = time.perf_counter()
        state, streams, meta = checkpoint.load(ck, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    if streams != [b for b, _ in first] or meta != {"frames_done": half}:
        raise AssertionError("checkpoint: loaded bytes or meta differ")
    for k, v in st1.items():
        if state[k].device != v.device or not torch.equal(state[k], v):
            raise AssertionError(f"checkpoint: loaded state {k} differs")
    me_cuda.LAUNCHES = 0
    _, out2 = enc.encode_sequence(
        cfg, {k: v[:, half:] for k, v in dev_frames.items()}, state,
        device=dev)
    torch.cuda.synchronize()
    launches = me_cuda.LAUNCHES
    if launches < dev_frames["y"].shape[1] - half:
        raise AssertionError(f"checkpoint: {launches} SAD kernel launches")
    for k, v in outputs.items():
        if not torch.equal(out2[k], v[:, half:]):
            raise AssertionError(f"checkpoint: resumed {k} != phase 6's "
                                 f"frames {half}+")
    per_stream = out1["total_bits"].sum(dim=1) + out2["total_bits"].sum(dim=1)
    if not torch.equal(per_stream, outputs["total_bits"].sum(dim=1)) \
            or int(per_stream.sum()) != HEADLINE_BITS:
        raise AssertionError("checkpoint: the halves' bits do not sum to "
                             "phase 6's")
    log(f"[checkpoint] frames 0-{half - 1} encoded, saved ({size} bytes, "
        f"{t_save:.3f} s), loaded onto the card ({t_load:.3f} s), frames "
        f"{half}-{dev_frames['y'].shape[1] - 1} resumed: every output == "
        f"phase 6's, bits sum to {HEADLINE_BITS} on {card}")
    return launches


def multihost_worker(spec: dict) -> int:
    """One process of phase 14: encode this rank's share of the streams
    through distrib.multihost and print one JSON line of what it saw."""
    import torch
    import torch.distributed as dist

    from p64tpu_torch.distrib import mesh as dm
    from p64tpu_torch.distrib import multihost
    from p64tpu_torch.kernels import me_cuda
    from p64tpu_torch.spec.constants import CIF

    if not torch.cuda.is_available():
        print("multihost worker: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    rank, world = spec["rank"], spec["world"]
    address = f"127.0.0.1:{spec['port']}"
    if world > 1:
        multihost.initialize(address, world, rank, backend=spec["backend"])
    else:
        # initialize() is a no-op for one process; a world of one still
        # runs every collective through the backend
        dist.init_process_group(spec["backend"],
                                init_method=f"tcp://{address}",
                                world_size=1, rank=0)
    try:
        frames = bench_content(CIF, spec["streams"], spec["frames"])
        n = spec["streams"] // world
        local = {k: v[rank * n:(rank + 1) * n] for k, v in frames.items()}
        cfg = headline_cfg(emit_recon=False)
        mesh = multihost.global_mesh()
        me_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        _, outputs, agg = multihost.encode_global(cfg, mesh, local)
        total = dm.agg_total_bits(agg)
        t_enc = time.perf_counter() - t0
        streams = multihost.finalize_local(cfg, outputs)
        lengths = multihost.gather_stream_lengths([b for _, b in streams])
        t_all = time.perf_counter() - t0
        print(json.dumps(dict(
            rank=rank, backend=dist.get_backend(), total_bits=total,
            frames_coded=int(agg["frames_coded"]),
            agg_device=str(agg["total_bits"].device),
            lengths=lengths.tolist(),
            sha256=[hashlib.sha256(b).hexdigest() for b, _ in streams],
            launches=me_cuda.LAUNCHES, encode_s=t_enc, total_s=t_all)),
            flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(specs) -> list:
    """Start one chip_smoke.py worker per spec, all at once; each must exit
    0 within WORKER_TIMEOUT, or every worker is killed and this raises.
    Returns each worker's JSON line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         json.dumps(spec)], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for spec in specs]
    deadline = time.monotonic() + WORKER_TIMEOUT
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for spec, p, (out, err) in zip(specs, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"multihost worker {spec} exit "
                                 f"{p.returncode}:\n{out}{err[-4000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def multihost_phase(dev, datas, lengths, card: str) -> dict:
    """Phase 14: two gloo ranks on this card over the headline, then one
    NCCL rank on a small batch; returns each rank's SAD launches."""
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.spec.constants import CIF

    t0 = time.perf_counter()
    port = _free_port()
    got = run_workers([dict(backend="gloo", rank=r, world=GLOO_WORLD,
                            port=port, streams=HEADLINE_STREAMS,
                            frames=HEADLINE_FRAMES)
                       for r in range(GLOO_WORLD)])
    wall = time.perf_counter() - t0
    shas = [hashlib.sha256(d).hexdigest() for d in datas]
    n = HEADLINE_STREAMS // GLOO_WORLD
    for r, g in enumerate(got):
        if g["backend"] != "gloo" or g["total_bits"] != HEADLINE_BITS:
            raise AssertionError(f"gloo rank {r}: {g['backend']} agg total "
                                 f"{g['total_bits']} != {HEADLINE_BITS}")
        if g["lengths"] != lengths:
            raise AssertionError(f"gloo rank {r}: gathered lengths != "
                                 "phase 6's")
        if g["sha256"] != shas[r * n:(r + 1) * n]:
            raise AssertionError(f"gloo rank {r}: stream bytes != phase 6's")
        if g["launches"] < HEADLINE_FRAMES:
            raise AssertionError(f"gloo rank {r}: {g['launches']} SAD "
                                 "kernel launches")
    log(f"[multihost] gloo, {GLOO_WORLD} ranks on one card, "
        f"{n} streams each: agg {HEADLINE_BITS} bits on both, gathered "
        f"lengths and sha256s == phase 6's; encode + agg "
        + ", ".join(f"{g['encode_s']:.3f}" for g in got)
        + " s, with serialize + gather "
        + ", ".join(f"{g['total_s']:.3f}" for g in got)
        + f" s; {wall:.1f} s wall for the phase (process start included) "
        f"on {card}")

    s, t = NCCL_BATCH
    want, out, _ = enc.encode_to_bytes(
        headline_cfg(emit_recon=False), bench_content(CIF, s, t), device=dev)
    want_len = out["total_bits"].sum(dim=1).tolist()
    (g,) = run_workers([dict(backend="nccl", rank=0, world=1,
                             port=_free_port(), streams=s, frames=t)])
    if (g["backend"] != "nccl" or not g["agg_device"].startswith("cuda")
            or g["total_bits"] != sum(want_len)
            or g["lengths"] != want_len
            or g["sha256"] != [hashlib.sha256(d).hexdigest() for d in want]):
        raise AssertionError(f"nccl rank: {g} != encode_to_bytes")
    log(f"[multihost] nccl, world size 1, {s}x{t} CIF: agg on "
        f"{g['agg_device']} {g['total_bits']} bits, gathered lengths and "
        f"sha256s == encode_to_bytes on {card}")
    return {"gloo": [g_["launches"] for g_ in got], "nccl": g["launches"]}


def profile_phase(card: str) -> int:
    """Phase 15: tools.profile on the card with a trace; returns the
    SAD-search launches it made."""
    from p64tpu_torch.kernels import me_cuda
    from p64tpu_torch.tools import profile

    s, t = PROFILE_BATCH
    buf = io.StringIO()
    me_cuda.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(buf):
            rc = profile.main(["--streams", str(s), "--frames", str(t),
                               "--format", "CIF", "--device", "cuda",
                               "--trace-dir", tmp])
        trace = os.path.join(tmp, "trace.json")
        if rc != 0 or not os.path.exists(trace):
            raise AssertionError(f"profile exit {rc}; trace written: "
                                 f"{os.path.exists(trace)}")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[profile] {line}")
    if "steady state" not in text or "Self CUDA" not in text:
        raise AssertionError("profile: no steady-state line or no operator "
                             "table by self CUDA time")
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[profile] {s}x{t} CIF on {card}: trace of {len(events)} events, "
        f"{kernels} of them CUDA kernels; sad_search launches "
        f"{me_cuda.LAUNCHES}")
    return me_cuda.LAUNCHES


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "--multihost-worker":
        if not os.path.isdir(os.path.join(HERE, "p64tpu_torch")):
            return 1
        sys.path.insert(0, HERE)
        return multihost_worker(json.loads(sys.argv[2]))
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

    from p64tpu_torch.kernels import me, me_cuda, me_variants_cuda
    from p64tpu_torch.spec.constants import CIF
    from p64tpu_torch.tools.parity import sad_oracle

    dev = torch.device("cuda", 0)

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {card} | torch: {kind} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    ptxas = build_all()
    clock_hz = max_sm_clock_hz()

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
    for name in me_variants_cuda.LAUNCHES:
        me_variants_cuda.LAUNCHES[name] = 0
    launches, outputs, datas = headline(dev, dev_frames, card)
    main_path = {"sad_search": launches, **me_variants_cuda.LAUNCHES}
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
    n_mb = cur.shape[0] * (cur.shape[1] // 16) * (cur.shape[2] // 16)
    bound = sad_bound(cur, SEARCH, 16 * n_mb, clock_hz)  # mv, best, sad0
    log(f"[timing] sad_search {HEADLINE_STREAMS}x CIF s={SEARCH}: kernel "
        f"{min(kernel_ms):.3f} ms, plain torch map+argmin "
        f"{min(plain_ms):.3f} ms per call; bound {bound['bound_ms']:.3f} ms "
        f"by {bound['bound_by']} ({bound['absdiffs']} abs-diffs at "
        f"{clock_hz / 1e6:.0f} MHz), {bound['bound_ms'] / min(kernel_ms):.1%}"
        f" of it, on {card}")

    # 8. the SAD-map kernels at the headline shape
    maps = map_kernels(cur, ref, card, clock_hz)

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

    # 12. the resilient, pipelined batch encoder over the headline
    by_path = {"headline": launches}
    by_path["batch"] = batch_phase(dev, frames, datas, card)

    # 13. checkpoint at frame 16, resume on the card
    by_path["checkpoint"] = checkpoint_phase(dev, dev_frames, outputs, card)
    lengths = outputs["total_bits"].sum(dim=1).tolist()
    del outputs

    # 14. two gloo processes over the headline, one NCCL process
    by_path["multihost"] = multihost_phase(dev, datas, lengths, card)

    # 15. the profiler
    by_path["profile"] = profile_phase(card)

    # 16. damaged pins decoded with resync on the card and on the CPU
    counts = resync_phase(pins, dev, RESYNC_PER_PIN, RESYNC_SEED)
    log(f"[resync] {RESYNC_PER_PIN} damaged copies of each of {len(pins)} "
        f"pins (seed {RESYNC_SEED}): {counts['decoded']} decoded, "
        f"{counts['refused']} refused, the same on the card, the CPU and "
        "parse_to_tensors + decode_seq")

    log(card)
    kernels = [{
        "name": "sad_search", "route": "cuda",
        "source": f"p64tpu_torch/csrc/{KERNEL_LIB}.cu",
        "replaces": "p64tpu/kernels/me_pallas.py:128",
        "launches": launches, "main_path_launches": main_path["sad_search"],
        "launches_by_path": by_path, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None, "ptxas": ptxas["sad_search"]}]
    for name, replaces in MAP_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"p64tpu_torch/csrc/{KERNEL_LIB}.cu",
            "replaces": f"p64tpu/kernels/me_pallas.py:{replaces}",
            "launches": map_launches[name],
            "main_path_launches": main_path[name], **maps[name],
            "library_ms": None, "ptxas": ptxas[name]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
