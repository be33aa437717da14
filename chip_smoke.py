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
                 differential fuzz's four corruption modes, seeded) decoded
                 with resync through decode_stream and parse_to_tensors +
                 decode_seq, on the card and on the CPU: the same refusal or
                 equal planes
 17. retired  -- the port's first benchmark tool; phases 6, 10, 12, 19
                 and 20 hold what it checked
 18. stages   -- tools.stage_bench's nine stages at 16 and 128 streams:
                 the captured loop's replay span (its checksum equal to the
                 eager loop's), eager kernel busy time and eager host wall
                 per iteration; at 1 stream their checksums on the card
                 equal the CPU's
 19. fuzz     -- tools.fuzz_encoder over 40 sampled configurations (seed
                 77: QCIF/CIF, 1-5 frames, search 0-15, fixed q or rate
                 control with MQUANT segments, six content families), each
                 encoded on the card and on the CPU: equal bytes, bits,
                 coded flags and reconstruction, the contract held, and the
                 SAD-search kernel launched on every frame of every inter
                 sample and never for an intra-only one; then
                 tools.fuzz_differential over 400 corrupted streams (seed
                 999): both parsers, both decode paths, the card and the CPU
                 agree on fields, strict outcome and planes or refusal
 20. graphs   -- the captured programs (core.graphs) against the eager
                 loops: cif, cif_rc, cif_intra and qcif at 16 and 128
                 streams x 32 frames of the benchmark content,
                 encode_sequence (replayed) equal to encode_sequence_eager
                 in every output and the final state (cif at 128 totals
                 the headline's bits), each replay launching the SAD
                 search but cif_intra's, at 128 streams stream 0's first
                 frames' bits equal to the CPU's, each with its capture
                 seconds, pool MB and per-frame wall, graph against eager;
                 phase 10's mix through reconstruct_seq equal to
                 reconstruct_seq_eager;
                 in a worker process, torch.profiler counts one
                 sad_search_kernel execution in each replay of a replayed
                 cif encode (equal to the launch count) and none for
                 cif_intra, on a trace that holds every replay's kernels
                 (one that lost records is logged and taken again on a
                 rebuilt program, at most PROFILE_ATTEMPTS in all); one
                 eager frame step of each
                 configuration and one reconstruct step under
                 torch.cuda.set_sync_debug_mode("error"); then
                 tools.capture_probe on base16 and s1
 21. dryrun   -- tools.dryrun: the compile check (entry(): one QCIF frame
                 step at search 15 under rate control, built as one
                 captured program in a cache of its own and replayed once)
                 equal to the step on the CPU, with one SAD-search launch;
                 then the production-shape dry run over 8 logical shards of
                 the card, twice, and over 8 CPU shards: equal per-stream
                 bytes and bit counts, the JAX package's 798,196 bits and
                 8 frames coded, the SAD-search kernel launched on every
                 frame of every shard, and one program built for the 8
                 equal shard keys, kept for the second call
 22. serialize -- the headline content encoded on the card at q=10 and
                 at 1,024 kbit/s rate control (p = 16), and textured
                 content (noise 64) at 1,920 kbit/s (p = 30) with three
                 MQUANT segments a GOB, which has to write MQUANT MBs; 128
                 CIF streams x 32 frames each, its symbol outputs copied to
                 pinned host memory (core.encoder.outputs_to_host); the
                 batch serializer (core.encoder.serialize_streams) over
                 them equals the per-stream native serialize_sequence over
                 outputs_to_symbols, stream for stream, and the device bit
                 model; finalize ms (pinned copies, wait, serialize) and the
                 per-stream path's ms
 23. ratechain -- the rate-control chain's kernels (csrc/rate_chain.cu,
                 kernels.rate_chain_cuda): ptxas figures; on seeded random
                 chain inputs (1, 2, 3, 4, 33 and 40 MQUANT segments,
                 buffers at QUANT 1 and 31) equal to the plain chain
                 (core.encoder._gob_chain) on the card; then for the p = 16
                 and the p = 30 three-segment configurations (their
                 benchmark content) at 32 and 128 CIF streams x 8 frames
                 from frame 0, the eager encode through the kernels equal
                 to the eager encode through the plain chain, and the
                 captured program's equal to both, in every output and the
                 final state, with three chain launches a replay; the
                 chain of frame 1 timed by CUDA events, each kernel and the
                 whole, beside its bytes bound and the plain chain; the
                 chain's launches by path, the main path's (the captured
                 p = 30 program at 32 streams) on their own, and the
                 largest difference from the plain chain
 24. levels   -- the decode's levels expanded on the card
                 (csrc/levels_expand.cu, kernels.levels_cuda): ptxas
                 figures; for the decode cell's shape (128 CIF streams x 32
                 frames of the benchmark content at p = 16, encoded on the
                 card, parsed on threads) and for 128 CIF streams x 4 frames
                 whose every level is nonzero, or zero: the kernel's levels8
                 equal to the plain version's and to the dense np.stack of
                 the parsed levels8; the kernel timed by CUDA events (calls
                 captured in a graph) beside its bytes bound and the plain
                 version; at the cell's shape the host stack (stack_seqs,
                 packed) beside the dense np.stack and pageable copy it
                 replaced; one launch for a decode_seq_batch, and the
                 launches by path

From phase 4 on, every encode_sequence and reconstruct_seq on the card
replays a captured program (core.graphs): the pins, the headline, the
batch encoder, the checkpoint resume, the worker processes, the profiler
and the fuzz campaigns.

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --multihost-worker '{"backend": ...}'
    python3 chip_smoke.py --profile-worker '{"configs": ["cif", ...]}'

run one worker of phase 14 and phase 20's profiler count; the phases
start them themselves.
"""

from __future__ import annotations

import collections
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
#: the graph phase's encode configurations (see encode_cfg), and stream
#: 0's frames whose bits it holds to the CPU's in each
ENCODE_CONFIGS, CPU_FRAMES = ("cif", "cif_rc", "cif_intra", "qcif"), 3
#: stream counts and iterations of the stage bench (phase 18)
STAGE_STREAMS, STAGE_ITERS = (16, 128), 30
#: Python serializer's bytes are checked against the native engine's on
#: this many headline streams
ORACLE_STREAMS = 4
#: the one kernel source, p64tpu_torch/csrc/<name>.cu
KERNEL_LIB = "sad_search"
#: damaged copies of each pinned stream in the resync phase, and their seed
RESYNC_PER_PIN, RESYNC_SEED = 8, 16
#: stream counts of the graph phase's encodes (graph against eager), and
#: the capture probe's variants it runs
GRAPH_STREAMS, PROBE_VARIANTS = (16, 128), ("base16", "s1")
#: configurations whose replayed encode the graph phase profiles -> the
#: SAD-search kernels each replay runs
PROFILED = {"cif": 1, "cif_intra": 0}
#: profiled replayed encodes a configuration may take to get one trace that
#: holds every kernel of every replay: the profiler can lose kernel records
#: (about 15,000 of them in a cif encode), on a loaded host and late in a
#: process that has profiled before
PROFILE_ATTEMPTS = 5
#: the fuzz phase: encoder samples and their seed, corrupted streams and
#: their seed (the reference tools' default seeds)
FUZZ_SAMPLES, FUZZ_ENCODER_SEED = 40, 77
FUZZ_STREAMS, FUZZ_DECODE_SEED = 400, 999
#: the dry run's shards, and the JAX package's bit total and coded frames
#: for them (its dry run over 8 devices)
DRYRUN_SHARDS, DRYRUN_BITS, DRYRUN_CODED = 8, 798_196, 8
#: the serialize phase's rate-controlled configuration (port_bench's
#: cif_rc_p16: p = 16, CIF at 30 Hz)
SERIALIZE_RC_BITS, SERIALIZE_RC_FPS = 1_024_000, 30
#: its MQUANT configuration (port_bench's cif_rc_p30_mq3: p = 30, three
#: MQUANT segments a GOB) and the texture of its content
SERIALIZE_MQ_BITS, SERIALIZE_MQ_SEGMENTS, SERIALIZE_MQ_NOISE = \
    1_920_000, 3, 64
#: the rate-chain phase's streams and frames, and the MQUANT segment counts
#: of its random inputs
CHAIN_STREAMS, CHAIN_FRAMES = (32, 128), 8
CHAIN_SEGMENTS = (1, 2, 3, 4, 33, 40)
#: the levels phase's inputs (levels_seqs), and the frames of its
#: synthetic batches
LEVELS_KINDS = ("cell", "all_nonzero", "all_zero")
LEVELS_SYNTH_FRAMES = 4
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


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds of one fn() call: `reps` calls captured in one
    CUDA graph, the graph replayed (cuda_ms), over reps.  Unlike cuda_ms
    of fn itself, no host launch cost between the calls is counted."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, 5) / reps
    del graph
    return ms


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
    the differential fuzz's four corruption modes
    (tools.fuzz_differential.corrupt) drawn from one seeded generator, the
    other streams the splice pool.  Yields (name, mode, bytes)."""
    import numpy as np

    from p64tpu_torch.tools.fuzz_differential import corrupt

    rng = np.random.default_rng(seed)
    pool = [streams[k] for k in sorted(streams)]
    for name in sorted(streams):
        for _ in range(per_stream):
            yield (name, *corrupt(rng, streams[name], pool))


def resync_phase(streams: dict, dev, per_stream: int, seed: int) -> dict:
    """Phase 16: damaged copies of `streams` decoded with resync through
    decode_stream and through parse_to_tensors + decode_seq, on `dev` and,
    when that is the card, on the CPU (tools.fuzz_differential
    .decode_difference).  All must refuse (a ValueError) or give equal
    planes; a divergence raises with its first diverging path, plane and
    index.  Returns the counts of decoded and refused streams."""
    from p64tpu_torch.tools.fuzz_differential import decode_difference

    counts = {"decoded": 0, "refused": 0}
    for name, mode, d in damaged_streams(streams, per_stream, seed):
        refused, diff = decode_difference(d, dev)
        if diff is not None:
            raise AssertionError(f"resync {name}, mode {mode}, {len(d)} "
                                 f"bytes: {diff}")
        counts["refused" if refused else "decoded"] += 1
    return counts


def headline_cfg(emit_recon: bool = True):
    return encode_cfg("cif", emit_recon)


def encode_cfg(config: str, emit_recon: bool = True):
    """The EncoderConfig of an encode configuration, all at search 15:
      cif       -- CIF, fixed quantizer (the headline's)
      cif_rc    -- CIF, per-GOB rate control at 1,024,000 bit/s (p = 16)
      cif_intra -- CIF, all intra (no motion search)
      qcif      -- QCIF, fixed quantizer"""
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.spec.constants import CIF, QCIF

    rate = (RateConfig(bit_rate=1024000) if config == "cif_rc"
            else RateConfig(fixed_quant=HEADLINE_QUANT))
    return enc.EncoderConfig(fmt=QCIF if config == "qcif" else CIF,
                             search=SEARCH, rate=rate,
                             intra_only=config == "cif_intra",
                             emit_recon=emit_recon)


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


def serialize_phase(dev, frames, card: str) -> dict:
    """Phase 22: for the headline configuration and the p = 16 rate
    configuration, encode `frames` (numpy, S x T CIF) on `dev`, and for
    the p = 30 MQUANT configuration the same shape of textured content;
    copy the symbol outputs to pinned host memory, and hold the batch
    serializer over them to the per-stream engine over outputs_to_symbols.
    The MQUANT configuration has to write MQUANT MBs.  Returns per
    configuration the finalize and per-stream ms and the bit total."""
    import dataclasses

    import torch

    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.entropy.encode import serialize_sequence
    from p64tpu_torch.spec.constants import CIF
    from p64tpu_torch.spec.luts import MTYPE_MQUANT
    from p64tpu_torch.tools.content import make_content

    base = headline_cfg(emit_recon=False)
    n_streams, n_frames = frames["y"].shape[:2]
    configs = {
        "cif_q10": (base, frames),
        "cif_rc_p16": (dataclasses.replace(base, rate=RateConfig(
            bit_rate=SERIALIZE_RC_BITS, frame_rate=SERIALIZE_RC_FPS)),
            frames),
        "cif_rc_p30_mq3": (dataclasses.replace(base, rate=RateConfig(
            bit_rate=SERIALIZE_MQ_BITS, frame_rate=SERIALIZE_RC_FPS,
            mquant_segments=SERIALIZE_MQ_SEGMENTS)),
            make_content(CIF, n_streams, n_frames, SERIALIZE_MQ_NOISE))}
    got = {}
    for name, (cfg, content) in configs.items():
        dev_frames = {k: torch.as_tensor(v, device=dev)
                      for k, v in content.items()}
        _, outputs = enc.encode_sequence(cfg, dev_frames, device=dev)
        del dev_frames
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        host, event = enc.outputs_to_host(outputs)
        event.synchronize()
        t1 = time.perf_counter()
        batch = enc.serialize_streams(cfg, host)
        t2 = time.perf_counter()
        per_stream = [serialize_sequence(cfg.fmt, syms)
                      for syms in enc.outputs_to_symbols(cfg, host)]
        t3 = time.perf_counter()
        if not all(host[k].is_pinned() for k in enc.SYMBOL_KEYS):
            raise AssertionError(f"serialize {name}: host outputs not pinned")
        bad = [i for i, (a, b) in enumerate(zip(batch, per_stream)) if a != b]
        if bad or len(batch) != n_streams:
            raise AssertionError(f"serialize {name}: batch serializer != "
                                 f"per-stream engine on streams {bad[:8]}")
        bits = sum(n for _, n in batch)
        if bits != int(outputs["total_bits"].sum()):
            raise AssertionError(f"serialize {name}: {bits} bits != device "
                                 "model")
        if name == "cif_q10" and bits != HEADLINE_BITS:
            raise AssertionError(f"serialize {name}: {bits} bits != "
                                 f"{HEADLINE_BITS}")
        coded = host["frame_coded"].numpy()
        mquant = int((MTYPE_MQUANT[host["mtype"].numpy()]
                      & host["coded"].numpy().astype(bool)).sum())
        if cfg.rate.mquant_segments > 1 and not mquant:
            raise AssertionError(f"serialize {name}: no MQUANT MB written")
        got[name] = dict(finalize_ms=(t2 - t0) * 1e3,
                         copy_ms=(t1 - t0) * 1e3,
                         serialize_ms=(t2 - t1) * 1e3,
                         per_stream_ms=(t3 - t2) * 1e3, bits=bits,
                         mquant_mbs=mquant)
        log(f"[serialize] {name} {n_streams}x{n_frames} CIF: batch "
            f"serializer == per-stream engine on every stream, {bits} bits "
            f"== device model ({int(coded.sum())} coded frames, "
            f"{int(host['n_stuff'].numpy().sum())} stuffing codes, "
            f"{mquant} MQUANT MBs); "
            f"finalize {got[name]['finalize_ms']:.1f} ms (pinned copies and "
            f"wait {got[name]['copy_ms']:.1f}, serialize "
            f"{got[name]['serialize_ms']:.1f}), per-stream path "
            f"{got[name]['per_stream_ms']:.1f} ms, on {card}")
        del outputs, host
    return got


def chain_inputs(seed: int, streams: int, gobs: int):
    """Seeded random inputs of the rate-control chain as numpy arrays
    (buffer, coefs, intra, mc, fil, mv, in `core.encoder._gob_chain`'s
    dtypes): Laplacian coefficients that shrink along the zigzag, intra, MC
    and filter decisions (filter only with MC), MVs on MC MBs; the last two
    streams' buffers give QUANT 1 and 31."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mbs = (streams, gobs, 33)
    decay = np.exp(-np.arange(64) / 12.0)
    coefs = np.round(rng.laplace(0, 12.0, mbs + (6, 64)) * decay * 4)
    intra = rng.random(mbs) < 0.1
    mc = ~intra & (rng.random(mbs) < 0.5)
    fil = mc & (rng.random(mbs) < 0.5)
    mv = np.where(mc[..., None], rng.integers(-15, 16, mbs + (2,)), 0)
    coefs[..., 0] = np.where(intra[..., None],
                             rng.integers(0, 2040, mbs + (6,)), coefs[..., 0])
    buffer = rng.integers(0, 40_000, (streams,))
    buffer[-2:] = 0, 2_000_000
    return (buffer.astype(np.int32), coefs.astype(np.int32), intra, mc, fil,
            mv.astype(np.int32))


#: the outputs of the rate-control chain, in order
CHAIN_OUTPUTS = ("levels", "cbp", "coded", "mtype", "gquant", "quant",
                 "bits")


def _max_abs_diff(got: dict, want: dict) -> int:
    """The largest |got - want| over the keys of `want` (shapes equal)."""
    import torch

    return max(int((got[k].to(torch.float64) - w.to(torch.float64)).abs()
                   .max()) if w.numel() else 0 for k, w in want.items())


def rate_chain_phase(dev, card: str) -> dict:
    """Phase 23 (see the module docstring).  Returns "figures": per
    configuration and stream count the kernels' and the plain chain's ms
    and the bound; "launches_by_path": chain launches per path, earlier
    phases included; "main_path_launches": the launches of the captured
    program's 8 replays at the p = 30 configuration and 32 streams;
    "max_abs_err": the largest difference of the kernels' outputs from the
    plain chain's and the captured program's."""
    import dataclasses

    import torch

    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.core import graphs
    from p64tpu_torch.kernels import _build
    from p64tpu_torch.kernels import rate_chain_cuda as rc
    from p64tpu_torch.spec.constants import CIF
    from p64tpu_torch.spec.luts import MTYPE_MQUANT
    from p64tpu_torch.tools.content import make_content

    t_phase = time.perf_counter()
    by_path = {"earlier_phases": rc.LAUNCHES}
    max_err = 0
    rc.LAUNCHES = 0
    _build.load("rate_chain")
    ptxas = ptxas_summary(_build.ptxas_report("rate_chain"))
    for name, f in ptxas.items():
        log(f"[ratechain] ptxas {name}: {f['registers']} registers, "
            f"{f['smem_bytes']} bytes static shared memory, "
            f"{f['spill_bytes']} bytes spilled")

    base = headline_cfg(emit_recon=False)
    for nseg in CHAIN_SEGMENTS:
        cfg = dataclasses.replace(base, rate=RateConfig(
            bit_rate=SERIALIZE_MQ_BITS, frame_rate=SERIALIZE_RC_FPS,
            mquant_segments=nseg))
        args = [torch.as_tensor(x, device=dev)
                for x in chain_inputs(nseg, 16, CIF.num_gobs)]
        got = dict(zip(CHAIN_OUTPUTS, rc.rate_chain_cuda(cfg.rate, *args)))
        want = dict(zip(CHAIN_OUTPUTS, enc._gob_chain(cfg, *args)))
        max_err = max(max_err, _max_abs_diff(got, want))
        _equal_or_raise(f"rate chain, random, {nseg} segments", got, want)
    by_path["random"] = rc.LAUNCHES
    log(f"[ratechain] random inputs (16 CIF streams, segments "
        f"{list(CHAIN_SEGMENTS)}, buffers at QUANT 1 and 31): kernels == "
        "plain chain")

    configs = {
        "cif_rc_p16": (RateConfig(bit_rate=SERIALIZE_RC_BITS,
                                  frame_rate=SERIALIZE_RC_FPS), 5),
        "cif_rc_p30_mq3": (RateConfig(
            bit_rate=SERIALIZE_MQ_BITS, frame_rate=SERIALIZE_RC_FPS,
            mquant_segments=SERIALIZE_MQ_SEGMENTS), SERIALIZE_MQ_NOISE)}
    figures = {}
    by_path.update(eager=0, graph=0, timing=0)
    main_path = None
    for name, (rate, noise) in configs.items():
        cfg = dataclasses.replace(base, rate=rate)
        for n_streams in CHAIN_STREAMS:
            frames = {k: torch.as_tensor(v, device=dev) for k, v in
                      make_content(CIF, n_streams, CHAIN_FRAMES,
                                   noise).items()}
            recorded = []

            def record(*a):
                recorded.append(a[1:])
                return enc.rate_chain_cuda(a[0].rate, *a[1:])

            rc.LAUNCHES = 0
            orig = enc.gob_chain
            try:
                enc.gob_chain = record
                state_k, out_k = enc.encode_sequence_eager(cfg, frames,
                                                           device=dev)
                enc.gob_chain = enc._gob_chain
                state_p, out_p = enc.encode_sequence_eager(cfg, frames,
                                                           device=dev)
            finally:
                enc.gob_chain = orig
            by_path["eager"] += rc.LAUNCHES
            rc.LAUNCHES = 0
            state_g, out_g = enc.encode_sequence_graphed(
                cfg, frames, device=dev, cache=graphs.ProgramCache(1))
            torch.cuda.synchronize(dev)
            replayed = rc.LAUNCHES
            by_path["graph"] += replayed
            if (name, n_streams) == ("cif_rc_p30_mq3", CHAIN_STREAMS[0]):
                main_path = replayed
            if replayed != len(rc.KERNELS) * CHAIN_FRAMES:
                raise AssertionError(
                    f"rate chain {name} x{n_streams}: {replayed} chain "
                    f"launches over {CHAIN_FRAMES} replays")
            for what, (st, out) in (("plain", (state_p, out_p)),
                                    ("graph", (state_g, out_g))):
                max_err = max(max_err, _max_abs_diff(
                    {**state_k, **out_k}, {**st, **out}))
                _equal_or_raise(f"rate chain {name} x{n_streams} kernels vs "
                                f"{what}", {**state_k, **out_k},
                                {**st, **out})
            coded = int(out_k["frame_coded"].sum())
            mquant = int((torch.as_tensor(MTYPE_MQUANT, device=dev)[
                out_k["mtype"].long()] & out_k["coded"]).sum())
            args = recorded[1]
            chain = lambda: rc.rate_chain_cuda(cfg.rate, *args)  # noqa: E731
            buffer, coefs, intra, mc, fil, mv = args
            rc.LAUNCHES = 0
            table = rc.price(coefs, intra)
            walked = rc.walk(cfg.rate, buffer, table, intra, mc, fil, mv)
            ms = {
                "chain": min(graph_ms(chain, 20) for _ in range(2)),
                "price": min(graph_ms(lambda: rc.price(coefs, intra), 20)
                             for _ in range(2)),
                "walk": min(graph_ms(lambda: rc.walk(
                    cfg.rate, buffer, table, intra, mc, fil, mv), 20)
                    for _ in range(2)),
                "emit": min(graph_ms(lambda: rc.emit(
                    coefs, intra, walked[1], walked[6]), 20)
                    for _ in range(2)),
                "plain": min(graph_ms(lambda: enc._gob_chain(cfg, *args), 1)
                             for _ in range(2)),
                "plain_eager": cuda_ms(lambda: enc._gob_chain(cfg, *args),
                                       3)}
            by_path["timing"] += rc.LAUNCHES
            n_mb = coefs.numel() // (6 * 64)
            # coefficients read and levels written once, the decisions and
            # MVs read, the per-MB and per-GOB outputs written
            nbytes = (2 * coefs.nbytes + n_mb * (3 + 8) + n_mb * 13
                      + buffer.numel() * (4 + 8 * CIF.num_gobs))
            bound_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
            figures[(name, n_streams)] = dict(ms, bound_ms=bound_ms)
            log(f"[ratechain] {name} {n_streams}x{CHAIN_FRAMES} CIF: eager "
                f"kernels == eager plain chain == captured program in every "
                f"output and the state ({coded} coded frames, {mquant} "
                f"MQUANT MBs), {replayed} chain launches over "
                f"{CHAIN_FRAMES} replays; frame 1's chain: kernels "
                f"{ms['chain']:.4f} ms (price {ms['price']:.4f}, walk "
                f"{ms['walk']:.4f}, emit {ms['emit']:.4f}), plain chain "
                f"{ms['plain']:.3f} ms (eager, launched from the host: "
                f"{ms['plain_eager']:.3f} ms), device time of calls "
                f"captured in a graph; bound {bound_ms:.4f} ms ({nbytes} "
                f"bytes), {bound_ms / ms['chain']:.1%} of it, on {card}")
            del frames, out_k, out_p, out_g, recorded, args, table, walked
    log(f"[ratechain] chain launches by path {by_path}, main path (the "
        f"captured p = 30 program, {CHAIN_STREAMS[0]} streams) {main_path} "
        f"over {CHAIN_FRAMES} replays, max abs err {max_err}")
    log(f"[ratechain] phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"figures": figures, "launches_by_path": by_path,
            "main_path_launches": main_path, "max_abs_err": max_err,
            "ptxas": ptxas}


def levels_seqs(kind: str, dev):
    """(fmt, parsed seq dicts) of the levels phase.  "cell": the decode
    cell's shape, 128 CIF streams x 32 frames of the benchmark content at
    p = 16, encoded on `dev` and parsed on threads (the streams of its
    largest group of equal frame count); "all_nonzero" and "all_zero": 128
    CIF streams x LEVELS_SYNTH_FRAMES frames whose every level is nonzero
    (seeded, in -128..127) or zero, packed by the native packer, with the
    other keys at neutral values."""
    import dataclasses

    import numpy as np

    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import decoder
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.native import load
    from p64tpu_torch.spec.constants import CIF
    from p64tpu_torch.tools.content import make_content
    from p64tpu_torch.utils import fan_map

    if kind == "cell":
        cfg = dataclasses.replace(headline_cfg(emit_recon=False),
                                  rate=RateConfig(
                                      bit_rate=SERIALIZE_RC_BITS,
                                      frame_rate=SERIALIZE_RC_FPS))
        datas, _, _ = enc.encode_to_bytes(
            cfg, make_content(CIF, HEADLINE_STREAMS, HEADLINE_FRAMES),
            device=dev)
        load()
        parsed = fan_map(decoder.parse_to_tensors, datas)
        groups = collections.Counter(seq["levels8"].shape[0]
                                     for _, _, seq in parsed)
        t = groups.most_common(1)[0][0]
        return CIF, [seq for _, _, seq in parsed
                     if seq["levels8"].shape[0] == t]
    rng = np.random.default_rng(24)
    m, t = CIF.num_mbs, LEVELS_SYNTH_FRAMES
    seqs = []
    for _ in range(HEADLINE_STREAMS):
        if kind == "all_zero":
            levels8 = np.zeros((t, m, 6, 64), np.int8)
        else:
            levels8 = rng.integers(1, 256, (t, m, 6, 64)).astype(
                np.uint8).view(np.int8)
        seqs.append(dict(
            levels8=levels8, dc=np.zeros((t, m, 6), np.uint8),
            quant=np.ones((t, m), np.int32),
            intra=np.zeros((t, m), bool), mv=np.zeros((t, m, 2), np.int32),
            fil=np.zeros((t, m), bool), **load().pack_levels(levels8)))
    return CIF, seqs


def levels_phase(dev, card: str) -> dict:
    """Phase 24 (see the module docstring).  Returns "figures": per input
    kind the kernel's and the plain version's ms, the bound and its bytes;
    "stack": at the cell's shape the host ms of stack_seqs and of the dense
    stack and copy it replaced; "launches_by_path"; "main_path_launches":
    the launches of one decode_seq_batch of the cell's streams;
    "max_abs_err"; "ptxas"."""
    import numpy as np
    import torch

    from p64tpu_torch.core import decoder
    from p64tpu_torch.kernels import _build
    from p64tpu_torch.kernels import levels_cuda as lc

    t_phase = time.perf_counter()
    by_path = {"earlier_phases": lc.LAUNCHES}
    lc.LAUNCHES = 0
    _build.load("levels_expand")
    ptxas = ptxas_summary(_build.ptxas_report("levels_expand"))
    for name, f in ptxas.items():
        log(f"[levels] ptxas {name}: {f['registers']} registers, "
            f"{f['smem_bytes']} bytes static shared memory, "
            f"{f['spill_bytes']} bytes spilled")
    figures, stack, max_err, main_path = {}, {}, 0, None
    by_path.update(checks=0, timing=0, stack=0, decode=0)
    for kind in LEVELS_KINDS:
        fmt, seqs = levels_seqs(kind, dev)
        parts = decoder.ship_packed(fmt, seqs, dev)
        args = [parts[k] for k in ("nz_mbs", "nz_blocks", "nz_levels",
                                   "nz_bases")]
        lc.LAUNCHES = 0
        got = lc.expand_levels(*args)
        plain = lc.expand_levels_plain(*args)
        dense = torch.from_numpy(np.stack([s["levels8"] for s in seqs],
                                          axis=1)).to(dev)
        for what, want in (("plain version", plain), ("dense stack", dense)):
            err = int((got.to(torch.int16) - want.to(torch.int16)).abs()
                      .max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"levels {kind}: kernel != {what}, max "
                                     f"|err| {err}")
        del plain, dense
        by_path["checks"] += lc.LAUNCHES
        lc.LAUNCHES = 0
        ms = min(graph_ms(lambda: lc.expand_levels(*args), 20)
                 for _ in range(2))
        plain_ms = min(cuda_ms(lambda: lc.expand_levels_plain(*args), 3)
                       for _ in range(2))
        by_path["timing"] += lc.LAUNCHES
        packed = sum(a.nbytes for a in args)
        nbytes = got.nbytes + packed
        bound_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
        figures[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bytes=nbytes, packed_bytes=packed,
                             values=int(args[2].numel()))
        s, t = len(seqs), seqs[0]["levels8"].shape[0]
        log(f"[levels] {kind} {s}x{t} {fmt.name}: kernel == plain version "
            f"== dense stack; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; "
            f"bound {bound_ms:.4f} ms ({got.nbytes} bytes written, {packed} "
            f"packed bytes read: {args[2].numel()} levels, "
            f"{args[1].numel()} block masks), {bound_ms / ms:.1%} of it, on "
            f"{card}")
        del got, parts, args
        if kind == "cell":
            lc.LAUNCHES = 0
            walls = {"packed": [], "dense": []}
            for _ in range(3):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                batch = decoder.stack_seqs(fmt, seqs, dev)
                torch.cuda.synchronize(dev)
                walls["packed"].append(time.perf_counter() - t0)
                del batch
                t0 = time.perf_counter()
                host = {k: np.stack([x[k] for x in seqs], axis=1)
                        for k in decoder.SEQ_KEYS}
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in host.items()}
                torch.cuda.synchronize(dev)
                walls["dense"].append(time.perf_counter() - t0)
                del batch, host
            by_path["stack"] += lc.LAUNCHES
            stack = {k: min(v) * 1e3 for k, v in walls.items()}
            lc.LAUNCHES = 0
            decoder.decode_seq_batch(fmt, seqs, device=dev)
            main_path = lc.LAUNCHES
            by_path["decode"] += main_path
            if main_path != 1:
                raise AssertionError(f"levels: {main_path} kernel launches "
                                     "for one decode_seq_batch")
            log(f"[levels] {kind}: host stack and copy to the card, best of "
                f"3: stack_seqs (packed) {stack['packed']:.1f} ms, the dense "
                f"np.stack and pageable copy {stack['dense']:.1f} ms; one "
                f"launch for a decode_seq_batch, on {card}")
        del seqs
    log(f"[levels] launches by path {by_path}, main path {main_path}, max "
        f"abs err {max_err}")
    log(f"[levels] phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"figures": figures, "stack": stack, "launches_by_path": by_path,
            "main_path_launches": main_path, "max_abs_err": max_err,
            "ptxas": ptxas}


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
    from p64tpu_torch.tools.content import make_content

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
        frames = make_content(CIF, spec["streams"], spec["frames"])
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


def run_workers(specs, kind: str = "multihost") -> list:
    """Start one chip_smoke.py worker of `kind` (a key of WORKERS) per
    spec, all at once; each must exit 0 within WORKER_TIMEOUT, or every
    worker is killed and this raises.  Returns each worker's JSON line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{kind}-worker",
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
            raise AssertionError(f"{kind} worker {spec} exit "
                                 f"{p.returncode}:\n{out}{err[-4000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def multihost_phase(dev, datas, lengths, card: str) -> dict:
    """Phase 14: two gloo ranks on this card over the headline, then one
    NCCL rank on a small batch; returns each rank's SAD launches."""
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.spec.constants import CIF
    from p64tpu_torch.tools.content import make_content

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
        headline_cfg(emit_recon=False), make_content(CIF, s, t), device=dev)
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


def stage_phase(dev, card: str) -> int:
    """Phase 18: tools.stage_bench's stages at STAGE_STREAMS streams on the
    card, then their checksums at 1 stream on the card and the CPU.
    Returns the SAD-search launches of the timed runs."""
    from p64tpu_torch.kernels import me_cuda
    from p64tpu_torch.tools import stage_bench

    def ms(v):
        return "not measured" if v is None else f"{v:.3f}"

    me_cuda.LAUNCHES = 0
    for streams in STAGE_STREAMS:
        res = stage_bench.run_stages(stage_bench.STAGES, streams, STAGE_ITERS,
                                     device=dev)
        for name, r in res.items():
            log(f"[stages] {streams} streams {name}: graph replay "
                f"{ms(r.device_ms)}, eager busy {ms(r.busy_ms)}, eager wall "
                f"{ms(r.wall_ms)} ms/iter on {card}")
    launches = me_cuda.LAUNCHES
    if launches < 2 * STAGE_ITERS:
        raise AssertionError(f"stage bench: {launches} SAD-search launches")
    on_card = stage_bench.run_stages(stage_bench.STAGES, 1, 2, device=dev)
    on_cpu = stage_bench.run_stages(stage_bench.STAGES, 1, 2, device="cpu")
    bad = [n for n in stage_bench.STAGES
           if on_card[n].checksum != on_cpu[n].checksum]
    if bad:
        raise AssertionError(f"stage bench checksums differ on the card and "
                             f"the CPU: {bad}")
    log(f"[stages] 1 stream x 2 iterations: all {len(on_cpu)} checksums "
        f"on the card == CPU; sad_search launches {launches}")
    return launches


def fuzz_phase(dev, card: str) -> dict:
    """Phase 19: the encoder config fuzz, card against CPU, then the decode
    differential fuzz on the card and the CPU; a failing sample or a
    disagreeing stream raises.  Returns each kernel's launches during the
    encoder fuzz."""
    from p64tpu_torch.kernels import me_cuda, me_variants_cuda
    from p64tpu_torch.tools import fuzz_differential, fuzz_encoder

    me_cuda.LAUNCHES = 0
    for name in me_variants_cuda.LAUNCHES:
        me_variants_cuda.LAUNCHES[name] = 0
    enc = fuzz_encoder.run(dev, FUZZ_ENCODER_SEED, count=FUZZ_SAMPLES)
    launches = {"sad_search": me_cuda.LAUNCHES, **me_variants_cuda.LAUNCHES}
    inter = enc["configs"] - enc["intra_only"]
    if launches["sad_search"] != enc["sad_launches"] or inter < 1:
        raise AssertionError(f"fuzz: {launches['sad_search']} SAD-search "
                             f"launches, the samples counted "
                             f"{enc['sad_launches']}, {inter} inter samples")
    missing = set(fuzz_encoder.SEARCHES) - set(enc["searches"])
    if missing:
        raise AssertionError(f"fuzz: no sample searched {sorted(missing)}")
    log(f"[fuzz] encoder config fuzz, seed {FUZZ_ENCODER_SEED}: "
        f"{enc['configs']} samples, card == CPU in bytes, bits, coded flags "
        f"and reconstruction, every contract held; {enc['cif']} CIF, "
        f"{enc['rate_controlled']} rate-controlled, {enc['skipped']} with a "
        f"skipped frame, {enc['intra_only']} intra only; samples per search "
        f"{enc['searches']}; sad_search launches {launches['sad_search']} "
        f"(once per frame of the {inter} inter samples), map kernels "
        f"{sum(launches.values()) - launches['sad_search']}; "
        f"{enc['seconds']:.1f} s on {card}")
    dec = fuzz_differential.run(dev, FUZZ_DECODE_SEED, count=FUZZ_STREAMS)
    log(f"[fuzz] decode differential fuzz, seed {FUZZ_DECODE_SEED}: "
        f"{dec['streams']} corrupted streams (modes {dec['modes']}): "
        f"{dec['decoded']} decoded, {dec['refused']} refused, "
        f"{dec['strict_accepted']} accepted in strict mode; both parsers, "
        f"both decode paths and card == CPU agree on every one; "
        f"{dec['seconds']:.1f} s on {card}")
    return launches


def _equal_or_raise(what: str, got: dict, want: dict) -> None:
    """Every key of `want` equal in `got`, bit for bit; raises naming the
    first diverging key and its first diverging index."""
    import torch

    if got.keys() != want.keys():
        raise AssertionError(f"{what}: keys {sorted(got)} != {sorted(want)}")
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} {k}: {g.dtype}{tuple(g.shape)} != "
                                 f"{w.dtype}{tuple(w.shape)}")
        if not torch.equal(g, w):
            idx = tuple(int(i) for i in (g != w).nonzero()[0])
            raise AssertionError(f"{what} {k}: first difference at {idx}: "
                                 f"{g[idx].item()} != {w[idx].item()}")


def _encode_wall(fn, frames_t: int):
    """fn() -> (state, outputs); returns (seconds per frame up to the read
    of the bit total, state, outputs)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out = fn()
    int(out["total_bits"].sum())                      # waits for the device
    return (time.perf_counter() - t0) / frames_t, state, out


def _replays_traced(prof, name: str) -> list:
    """Per cudaGraphLaunch of a torch.profiler run, in launch order: (CUDA
    kernels traced, kernels traced whose name holds `name`).  Each kernel a
    replay runs carries its launch's correlation id."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launches = sorted(e.correlation_id() for e in events
                      if "cudaGraphLaunch" in e.name())
    kernels, named = collections.Counter(), collections.Counter()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            kernels[e.correlation_id()] += 1
            named[e.correlation_id()] += name in e.name()
    return [(kernels[c], named[c]) for c in launches]


def profile_worker(spec: dict) -> int:
    """The profiler count of phase 20, in a process of its own: for each
    configuration of spec, build the program of the headline content, then
    encode it again under torch.profiler.  A trace is whole when it holds
    every replay's launch and the same number of kernels in each (the
    replays run one graph); a trace that is not is kept as lossy, and the
    program is rebuilt and profiled again, at most PROFILE_ATTEMPTS times.
    Prints one JSON line: per configuration, the whole trace's (kernels,
    SAD-search kernels) per replay or null, LAUNCHES over it, the lossy
    traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.core import graphs
    from p64tpu_torch.kernels import me_cuda
    from p64tpu_torch.tools.content import make_content

    if not torch.cuda.is_available():
        print("profile worker: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    out = {}
    for config in spec["configs"]:
        cfg = encode_cfg(config)
        frames = {k: torch.as_tensor(v, device=dev) for k, v in
                  make_content(cfg.fmt, HEADLINE_STREAMS,
                               HEADLINE_FRAMES).items()}
        got = out[config] = {"replays": None, "launches": None, "lossy": []}
        for _ in range(PROFILE_ATTEMPTS):
            graphs.PROGRAMS.clear()
            enc.encode_sequence(cfg, frames, device=dev)        # built
            torch.cuda.synchronize()
            me_cuda.LAUNCHES = 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                enc.encode_sequence(cfg, frames, device=dev)
                torch.cuda.synchronize()
            replays = _replays_traced(prof, "sad_search_kernel")
            kernels = collections.Counter(k for k, _ in replays)
            if len(replays) == HEADLINE_FRAMES and len(kernels) == 1:
                got.update(replays=replays, launches=me_cuda.LAUNCHES)
                break
            most = max(kernels, default=0)
            got["lossy"].append({
                "launches": len(replays), "kernels": dict(kernels),
                "short": [(i, k) for i, (k, _) in enumerate(replays)
                          if k != most][:8]})
        del frames
    print(json.dumps(out), flush=True)
    return 0


#: a worker mode of this script -> its function
WORKERS = {"--multihost-worker": multihost_worker,
           "--profile-worker": profile_worker}


def graphs_phase(dev, mix, card: str) -> int:
    """Phase 20: the captured programs (core.graphs) against the eager
    loops on the card.  Returns the SAD-search launches of the profiled
    replayed cif encode."""
    import torch

    from p64tpu_torch.core import decoder
    from p64tpu_torch.core import encoder as enc
    from p64tpu_torch.core import graphs
    from p64tpu_torch.tools import capture_probe
    from p64tpu_torch.tools.content import make_content
    from p64tpu_torch.utils import fan_map

    cfgs = {}
    for config in ENCODE_CONFIGS:
        cfg = cfgs[config] = encode_cfg(config)
        for streams in GRAPH_STREAMS:
            frames = {k: torch.as_tensor(v, device=dev) for k, v in
                      make_content(cfg.fmt, streams,
                                   HEADLINE_FRAMES).items()}
            graphs.PROGRAMS.clear()
            torch.cuda.empty_cache()
            walls = {"eager": [], "graph": []}
            for way in ("eager", "graph", "graph", "eager"):
                fn = (enc.encode_sequence if way == "graph"
                      else enc.encode_sequence_eager)
                wall, state, out = _encode_wall(
                    lambda: fn(cfg, frames, device=dev), HEADLINE_FRAMES)
                walls[way].append(wall)
                if way == "graph":
                    g_state, g_out = state, out
                else:
                    e_state, e_out = state, out
            _equal_or_raise(f"graph vs eager {config} {streams} streams, "
                            "output", g_out, e_out)
            _equal_or_raise(f"graph vs eager {config} {streams} streams, "
                            "final state", g_state, e_state)
            bits = int(g_out["total_bits"].sum())
            if (config == "cif" and streams == HEADLINE_STREAMS
                    and bits != HEADLINE_BITS):
                raise AssertionError(f"graph cif: {bits} bits != "
                                     f"{HEADLINE_BITS}")
            ((_, prog),) = graphs.PROGRAMS.items()
            cap = prog.captured
            if (cap.launches == 0) != (config == "cif_intra"):
                raise AssertionError(f"graph {config}: {cap.launches} "
                                     "SAD-search launches per replay")
            head = ""
            if streams == HEADLINE_STREAMS:
                _, cpu = enc.encode_sequence(
                    cfg, make_content(cfg.fmt, 1, CPU_FRAMES), device="cpu")
                want = cpu["total_bits"][0].tolist()
                got = g_out["total_bits"][0, :CPU_FRAMES].tolist()
                if got != want:
                    raise AssertionError(
                        f"graph {config}: stream 0's first {CPU_FRAMES} "
                        f"frames {got} bits on the card, {want} on the CPU")
                head = (f" stream 0's first {CPU_FRAMES} frames' bits == "
                        "the CPU's;")
            log(f"[graphs] {config} {streams}x{HEADLINE_FRAMES}: graph == "
                f"eager in every output and the final state, {bits} bits;"
                f"{head} "
                f"warm-up {cap.warmup_s:.3f} s, capture {cap.capture_s:.3f} "
                f"s, pool {cap.pool_bytes / 2 ** 20:.1f} MB, "
                f"{cap.launches} SAD-search launches per replay; wall per "
                f"frame graph {min(walls['graph']) * 1e3:.3f} ms (of "
                + ", ".join(f"{w * 1e3:.3f}" for w in walls["graph"])
                + f"), eager {min(walls['eager']) * 1e3:.3f} ms (of "
                + ", ".join(f"{w * 1e3:.3f}" for w in walls["eager"])
                + f") on {card}")
            del frames, g_state, g_out, e_state, e_out

    # decode: phase 10's mix, graph against eager
    parsed = fan_map(decoder.parse_to_tensors, mix)
    fmt = parsed[0][0]
    batch = decoder.stack_seqs(fmt, [seq for _, _, seq in parsed], dev)
    got = decoder.reconstruct_seq(fmt, batch)
    want = decoder.reconstruct_seq_eager(fmt, batch)
    keys = ("y", "cb", "cr")
    _equal_or_raise("decode graph vs eager", dict(zip(keys, got)),
                    dict(zip(keys, want)))
    log(f"[graphs] decode {len(mix)}x{batch['levels8'].shape[0]} of phase "
        f"10's mix: reconstruct_seq (replayed) == reconstruct_seq_eager")
    del batch, got, want

    # the SAD-search kernel really runs under replay: counted in a process
    # of its own, whose profiler no earlier phase has used
    graphs.PROGRAMS.clear()
    torch.cuda.empty_cache()
    (traces,) = run_workers([{"configs": list(PROFILED)}], "profile")
    counted = {}
    for config, per_replay in PROFILED.items():
        got = traces[config]
        for i, lost in enumerate(got["lossy"], 1):
            log(f"[graphs] profiled replayed {config}, trace {i}: lost "
                f"records ({lost['launches']} graph launches of "
                f"{HEADLINE_FRAMES}, kernels per launch {lost['kernels']}, "
                f"short launches (index, kernels) {lost['short']}); "
                "rebuilt and profiled again")
        replays = got["replays"]
        if replays is None:
            raise AssertionError(f"replayed {config}: none of "
                                 f"{PROFILE_ATTEMPTS} traces held every "
                                 "kernel of every replay")
        n = sum(k for _, k in replays)
        if ({k for _, k in replays} != {per_replay}
                or got["launches"] != n):
            raise AssertionError(
                f"replayed {config}: the profiler counted sad_search_kernel "
                f"executions per replay {[k for _, k in replays]}, LAUNCHES "
                f"{got['launches']}, expected {per_replay} per replay")
        counted[config] = n
        log(f"[graphs] replayed {config} {HEADLINE_STREAMS}x"
            f"{HEADLINE_FRAMES}: torch.profiler counts {n} sad_search_kernel "
            f"executions, {per_replay} in each of the {len(replays)} "
            f"replays of {replays[0][0]} kernels, == LAUNCHES "
            f"{got['launches']} (trace {len(got['lossy']) + 1} of at most "
            f"{PROFILE_ATTEMPTS})")

    # no host sync in one eager frame step of each configuration, or in
    # one reconstruct step
    for config, cfg in cfgs.items():
        s = HEADLINE_STREAMS
        fr = {k: torch.as_tensor(v[:, 0], device=dev).contiguous()
              for k, v in make_content(cfg.fmt, s, 1).items()}
        state = enc.init_state(cfg, s, dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            enc.encode_frame_step(cfg, state, fr["y"], fr["cb"], fr["cr"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    batch = decoder.stack_seqs(fmt, [seq for _, _, seq in parsed], dev)
    planes = dict(zip(("y", "cb", "cr"),
                      decoder._init_planes(fmt, batch, None)))
    frame = {k: batch[k][0] for k in decoder.SEQ_KEYS}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decoder._reconstruct_step(fmt, planes, frame)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[graphs] torch.cuda.set_sync_debug_mode('error') held around one "
        f"eager frame step of {', '.join(cfgs)} and one reconstruct step: "
        "no host sync")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = capture_probe.main(list(PROBE_VARIANTS))
    if rc != 0:
        raise AssertionError(f"capture_probe exit {rc}")
    for line in buf.getvalue().splitlines():
        log(f"[graphs] capture_probe: {line}")
    return counted["cif"]


def _dryrun_logged(devices=None) -> tuple:
    """tools.dryrun.dryrun_multichip over DRYRUN_SHARDS shards of `devices`
    (default the card's logical shards), its line logged; returns (result,
    wall seconds)."""
    from p64tpu_torch.tools import dryrun

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = dryrun.dryrun_multichip(DRYRUN_SHARDS, devices)
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"[dryrun] {line}")
    return result, wall


def dryrun_phase(dev, card: str) -> int:
    """Phase 21: tools.dryrun's compile check and dry run on the card
    against the CPU.  Returns the SAD-search launches of the first dry run
    on the card."""
    import torch

    from p64tpu_torch.core import graphs
    from p64tpu_torch.kernels import me_cuda
    from p64tpu_torch.tools import dryrun

    t_phase = time.perf_counter()
    fn, args = dryrun.entry(dev)
    n_programs = len(graphs.PROGRAMS)
    me_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    got = dryrun.compile_check(fn, args)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    launches = me_cuda.LAUNCHES
    if launches != 1:
        raise AssertionError(f"compile check: {launches} SAD-search "
                             "launches, expected 1 (one replay)")
    if len(graphs.PROGRAMS) != n_programs:
        raise AssertionError("compile check: the entry points' program "
                             "cache changed")
    cfn, cargs = dryrun.entry("cpu")
    want = cfn(*cargs)
    for what, g, w in zip(("new state", "outputs"), got, want):
        _equal_or_raise(f"compile check {what}, card vs CPU",
                        {k: v.cpu() for k, v in g.items()}, w)
    log(f"[dryrun] compile check: entry() built as one captured program "
        f"and replayed once in {check_s:.3f} s (build included), 1 "
        "SAD-search launch; new state and outputs == the step on the CPU")

    graphs.PROGRAMS.clear()
    builds = graphs.PROGRAMS.builds
    me_cuda.LAUNCHES = 0
    on_card, card_s = _dryrun_logged()
    by_path = me_cuda.LAUNCHES
    built = graphs.PROGRAMS.builds - builds
    again, again_s = _dryrun_logged()
    rebuilt = graphs.PROGRAMS.builds - builds - built
    cpu, cpu_s = _dryrun_logged(["cpu"] * DRYRUN_SHARDS)
    if on_card["devices"] != (dev,) * DRYRUN_SHARDS:
        raise AssertionError(f"dry run shards {on_card['devices']}, "
                             f"expected {DRYRUN_SHARDS} x {dev}")
    for what, run in (("card", on_card), ("card, second call", again)):
        for key in ("streams", "total_bits", "frames_coded"):
            if run[key] != cpu[key]:
                raise AssertionError(f"dry run {what}: {key} differs from "
                                     "the CPU's")
    if (cpu["total_bits"], cpu["frames_coded"]) != (DRYRUN_BITS,
                                                    DRYRUN_CODED):
        raise AssertionError(f"dry run: {cpu['total_bits']} bits, "
                             f"{cpu['frames_coded']} frames coded, expected "
                             f"{DRYRUN_BITS}, {DRYRUN_CODED}")
    frames = DRYRUN_SHARDS * dryrun.T
    if by_path < frames:
        raise AssertionError(f"dry run: {by_path} SAD-search launches, "
                             f"expected one per frame of every shard, "
                             f">= {frames}")
    if (built, rebuilt) != (1, 0):
        raise AssertionError(f"dry run: {built} programs built for "
                             f"{DRYRUN_SHARDS} equal shard keys, "
                             f"{rebuilt} more in the second call; expected "
                             "1 and 0")
    log(f"[dryrun] {DRYRUN_SHARDS} logical shards of {dev}: per-stream "
        f"bytes and bit counts == {DRYRUN_SHARDS} CPU shards, "
        f"{on_card['total_bits']} bits, {on_card['frames_coded']} frames "
        f"coded; "
        f"{by_path} SAD-search launches for {frames} shard-frames; 1 program "
        f"built, none in the second call; wall {card_s:.3f} s (capture "
        f"included), {again_s:.3f} s (replays only), CPU {cpu_s:.3f} s; "
        f"phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return by_path


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] in WORKERS:
        if not os.path.isdir(os.path.join(HERE, "p64tpu_torch")):
            return 1
        sys.path.insert(0, HERE)
        return WORKERS[sys.argv[1]](json.loads(sys.argv[2]))
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

    from p64tpu_torch.core import graphs
    from p64tpu_torch.kernels import me, me_cuda, me_variants_cuda
    from p64tpu_torch.spec.constants import CIF
    from p64tpu_torch.tools.content import make_content, make_decode_content
    from p64tpu_torch.tools.parity import sad_oracle
    from p64tpu_torch.utils import card_line

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

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

    # 4. pins, through the captured frame steps
    builds = graphs.PROGRAMS.builds
    pins = check_pins(dev)
    pin_builds = graphs.PROGRAMS.builds - builds
    if pin_builds < 1:
        raise AssertionError("the pins' encodes captured no program")
    log(f"[pins] the {len(pins)} pins (3 MQUANT segments, skipped frames "
        f"among them) went through {pin_builds} captured programs")

    # 5. the parity gate, with its kernels' launches counted
    map_launches = gate()

    # 6. headline shape
    frames = make_content(CIF, HEADLINE_STREAMS, HEADLINE_FRAMES)
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
    mix, n_stuff, n_mq, mix_recon = make_decode_content(
        MIX_STREAMS, MIX_FRAMES, HEADLINE_QUANT, device=dev)
    log(f"[mix] {len(mix)} CIF streams x {MIX_FRAMES} frames encoded: "
        f"{n_stuff} stuffing codes, {n_mq} MQUANT MBs")
    decode_check("mix", mix, mix_recon, dev, card)
    del mix_recon

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

    # 17. retired

    # 18. the stage bench at 16 and 128 streams
    by_path["stage_bench"] = stage_phase(dev, card)

    # 19. the encoder config fuzz and the decode differential fuzz
    fuzz = fuzz_phase(dev, card)
    by_path["fuzz"] = fuzz["sad_search"]

    # 20. the captured programs against the eager loops
    by_path["graphs"] = graphs_phase(dev, mix, card)

    # 21. the compile check and the multi-device dry run
    by_path["dryrun"] = dryrun_phase(dev, card)

    # 22. the batch serializer on the card's pinned outputs
    serialize_phase(dev, frames, card)

    # 23. the rate-control chain's kernels against the plain chain
    chain = rate_chain_phase(dev, card)

    # 24. the decode's levels expanded on the card
    levels = levels_phase(dev, card)
    log(f"[done] phases 1-16 and 18-24 passed in "
        f"{time.perf_counter() - t_start:.1f} s")

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
            "main_path_launches": main_path[name],
            "launches_by_path": {"gate": map_launches[name],
                                 "fuzz": fuzz[name]}, **maps[name],
            "library_ms": None, "ptxas": ptxas[name]})
    at32 = chain["figures"][("cif_rc_p30_mq3", CHAIN_STREAMS[0])]
    kernels.append({
        "name": "rate_chain", "route": "cuda",
        "source": "p64tpu_torch/csrc/rate_chain.cu", "replaces": None,
        "launches": sum(chain["launches_by_path"].values()),
        "main_path_launches": chain["main_path_launches"],
        "launches_by_path": chain["launches_by_path"],
        "max_abs_err": chain["max_abs_err"],
        "ms": at32["chain"], "plain_ms": at32["plain"],
        "bound_ms": at32["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ptxas": chain["ptxas"], "by_config": {
            f"{n} x{s}": v for (n, s), v in chain["figures"].items()}})
    cell = levels["figures"]["cell"]
    kernels.append({
        "name": "levels_expand", "route": "cuda",
        "source": "p64tpu_torch/csrc/levels_expand.cu", "replaces": None,
        "launches": sum(levels["launches_by_path"].values()),
        "main_path_launches": levels["main_path_launches"],
        "launches_by_path": levels["launches_by_path"],
        "max_abs_err": levels["max_abs_err"],
        "ms": cell["ms"], "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ptxas": levels["ptxas"],
        "by_input": levels["figures"], "stack_ms": levels["stack"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
