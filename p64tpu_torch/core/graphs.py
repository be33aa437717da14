"""Captured CUDA graphs: the port's counterpart of the JAX package's compiled
programs.

The JAX package runs a whole sequence as one compiled device program:
`encode_sequence_jit` (`p64tpu/core/encoder.py`), `_decode_scan` and
`_decode_scan_batch` (`p64tpu/core/decoder.py`) jit a `lax.scan` over the
frames, so the host does no work per frame.  Eager torch launches every
operation of every frame from Python.  On a CUDA device this module
captures one step -- the encoder's frame step, the decoder's reconstruct
step -- as a CUDA graph once and replays it once per frame:

  * a `Program` owns static buffers: one frame of the step's inputs, its
    carried state and its outputs.  The captured region runs the step on
    them and ends by copying the new state into the static state, so one
    replay carries the state with no host work;
  * per frame, `Program.run` copies frame i into the static inputs,
    replays, and copies the static outputs into (S, T, ...) results
    allocated outside the graph's pool.  The final state it returns is a
    copy of the static state: nothing a call returns aliases a static
    buffer, a later call cannot overwrite it, and a state the caller passed
    in is only read.  Every copy and replay is queued on the device's
    current stream, so two calls in flight on one program (the batch
    encoder's pipelined chunks) run one after the other on the device;
  * before the capture one eager step runs on the capture's side stream:
    it loads the kernel library, uploads `utils.device_const`'s tables and
    sets up cuBLAS, whose first use would copy from the host inside the
    capture, which is an error;
  * programs are cached by key -- (config, streams, device) for the
    encoder in PROGRAMS, at most MAX_PROGRAMS on each device; (format,
    streams, device) for the decoder in a cache of its own
    (`core.decoder.PROGRAMS`), room for each batch size it pads to in both
    formats -- the least recently used on a device released first: each
    holds its graph's private memory pool, one step's intermediates, on
    its own device, so a program never evicts one on another device (a
    mesh of many cards keeps one program per card).

A failed warm-up, capture or replay raises and leaves nothing in the
cache; nothing retries eagerly or moves to the CPU.

On the CPU there is no graph to capture.  A Program there runs the same
bookkeeping with capture off: each replay runs the recorded region eagerly
on the static buffers and copies its outputs into static output buffers.
The CPU tests hold that bookkeeping to the eager loops and to the JAX
package; the entry points (`core.encoder.encode_sequence`,
`core.decoder.reconstruct_seq`) come here only on a CUDA device.

Launch accounting: `kernels.me_cuda.LAUNCHES` counts the SAD-search
kernel's host launches, `kernels.rate_chain_cuda.LAUNCHES` the rate-control
chain's and its `GOBS` the (stream, GOB) pairs the chain's walk carried; a
replay makes no host launch.  `capture` records how much each count grew
over the captured region, and every replay adds that much.  The counts of
the warm-up and of the capture call itself are the program's build, as
`jax.jit`'s trace and compile are, and are taken back out: the SAD count
stays one per frame encoded.  While tracing is on, a replay of a step whose
chain is the kernels also adds its (stream, GOB) pairs to the counter
`p64.rate.chain_kernel_gobs`: no span goes inside the captured step, so the
host counts what the replay ran.

Spans (`trace`, on the host): `p64.graphs.build` around a build on a
cache miss, `p64.graphs.replays` around `Program.run`'s queued replays and
output copies.  Nothing is traced inside the captured region.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Dict, Hashable, List, Mapping, Optional, Tuple

import torch

from .. import trace
from ..kernels import me_cuda, rate_chain_cuda

Tensors = Dict[str, torch.Tensor]
#: a step: (state, frame) -> (new state, outputs), each a dict of tensors
#: with a leading stream axis
Step = Callable[[Tensors, Tensors], Tuple[Tensors, Tensors]]

#: encoder programs kept at once on each device (each holds a private pool
#: there; at 128 CIF streams one encoder step's intermediates take some GB)
MAX_PROGRAMS = 4


@dataclasses.dataclass
class Captured:
    """A captured CUDA graph, what its captured region returned, and what
    the build cost."""
    graph: torch.cuda.CUDAGraph
    result: object
    #: SAD-search kernel launches one replay executes
    launches: int
    warmup_s: float
    capture_s: float
    #: growth of the device memory the caching allocator reserved over the
    #: capture: the graph's private pool
    pool_bytes: int
    #: rate-control chain kernel launches one replay executes, and the
    #: (stream, GOB) pairs its walk carries
    chain_launches: int = 0
    chain_gobs: int = 0

    def replay(self) -> None:
        self.graph.replay()
        me_cuda.LAUNCHES += self.launches
        rate_chain_cuda.LAUNCHES += self.chain_launches
        rate_chain_cuda.GOBS += self.chain_gobs
        if self.chain_gobs:
            trace.count("p64.rate.chain_kernel_gobs", self.chain_gobs)


def capture(fn: Callable[[], object], warmup: Callable[[], object],
            device: torch.device) -> Captured:
    """Run `warmup()` once eagerly on a side stream of `device`, then
    capture one call of `fn()` on that stream into a CUDA graph with its
    own memory pool.  Raises on any failure; nothing is kept then."""
    with torch.cuda.device(device):
        stream = torch.cuda.Stream()
        before = _counts()
        try:
            t0 = time.perf_counter()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                warmup()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            # torch.cuda.graph empties the cache too; emptying it first
            # lets the reserved memory measure the pool
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            at_capture = _counts()
            with torch.cuda.graph(graph, stream=stream):
                result = fn()
            grew = [b - a for a, b in zip(at_capture, _counts())]
            t2 = time.perf_counter()
        finally:
            _set_counts(before)
        pool = torch.cuda.memory_reserved() - reserved
    return Captured(graph, result, grew[0], t1 - t0, t2 - t1, pool,
                    chain_launches=grew[1], chain_gobs=grew[2])


def _counts() -> Tuple[int, int, int]:
    """The launch counts a capture records (Captured's fields)."""
    return (me_cuda.LAUNCHES, rate_chain_cuda.LAUNCHES,
            rate_chain_cuda.GOBS)


def _set_counts(counts: Tuple[int, int, int]) -> None:
    (me_cuda.LAUNCHES, rate_chain_cuda.LAUNCHES,
     rate_chain_cuda.GOBS) = counts


def _guard(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _copy_into(dst: Tensors, src: Mapping[str, torch.Tensor],
               what: str) -> None:
    if dst.keys() != src.keys():
        raise ValueError(f"{what} keys {sorted(src)} != the program's "
                         f"{sorted(dst)}")
    for k, d in dst.items():
        s = src[k]
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"{what} {k!r} is {s.dtype}{tuple(s.shape)}, "
                             f"the program's {d.dtype}{tuple(d.shape)}")
        d.copy_(s)


class Program:
    """One step over static buffers (see the module docstring): captured as
    a CUDA graph on a CUDA device, run with capture off on the CPU.

    state: a state the step takes; frame: one frame of its inputs.  Their
    shapes and dtypes are the program's; the build copies both into the
    static buffers first, so the warm-up runs on real data."""

    def __init__(self, step: Step, state: Mapping[str, torch.Tensor],
                 frame: Mapping[str, torch.Tensor]):
        self.step = step
        self.state = {k: torch.empty_like(v, memory_format=torch
                                          .contiguous_format)
                      for k, v in state.items()}
        self.inputs = {k: torch.empty_like(v, memory_format=torch
                                           .contiguous_format)
                       for k, v in frame.items()}
        _copy_into(self.state, state, "state")
        _copy_into(self.inputs, frame, "frame")
        self.device = next(iter(self.inputs.values())).device
        self.captured: Optional[Captured] = None
        if self.device.type == "cuda":
            self.captured = capture(
                self._record, lambda: self.step(self.state, self.inputs),
                self.device)
            self.outputs: Tensors = self.captured.result
        else:
            _, out = self.step(self.state, self.inputs)
            self.outputs = {k: torch.empty_like(v) for k, v in out.items()}

    def _record(self) -> Tensors:
        """The region one replay runs: the step on the static buffers, then
        its new state copied into the static state.  A new state the step
        passed through unchanged copies onto itself, which `copy_` skips.
        A returned tensor that shares memory with another static buffer is
        cloned first, so that the state copy cannot overwrite it."""
        new_state, out = self.step(self.state, self.inputs)
        if new_state.keys() != self.state.keys():
            raise ValueError(f"the step returned state keys "
                             f"{sorted(new_state)}, expected "
                             f"{sorted(self.state)}")
        static = {t.untyped_storage().data_ptr()
                  for t in (*self.state.values(), *self.inputs.values())}

        def fresh(t: torch.Tensor, own: Optional[torch.Tensor] = None):
            if t is own or t.untyped_storage().data_ptr() not in static:
                return t
            return t.clone()

        new_state = {k: fresh(v, self.state[k]) for k, v in new_state.items()}
        out = {k: fresh(v) for k, v in out.items()}
        for k, v in new_state.items():
            self.state[k].copy_(v)
        return out

    def replay(self) -> None:
        """Run the step once on the static buffers: a graph replay on a
        CUDA device, the recorded region eagerly on the CPU."""
        if self.captured is not None:
            self.captured.replay()
            return
        for k, v in self._record().items():
            self.outputs[k].copy_(v)

    def run(self, state: Mapping[str, torch.Tensor],
            inputs: Mapping[str, torch.Tensor],
            axis: int) -> Tuple[Tensors, Tensors]:
        """Every frame of `inputs` (frame i is `v.select(axis, i)`) from
        `state`; returns (final state, outputs stacked as (S, T, ...)),
        all fresh tensors."""
        t = next(iter(inputs.values())).shape[axis]
        with _guard(self.device), trace.span("p64.graphs.replays"):
            _copy_into(self.state, state, "state")
            results = {k: torch.empty((v.shape[0], t, *v.shape[1:]),
                                      dtype=v.dtype, device=v.device)
                       for k, v in self.outputs.items()}
            for i in range(t):
                _copy_into(self.inputs,
                           {k: v.select(axis, i) for k, v in inputs.items()},
                           "frame")
                self.replay()
                for k, v in self.outputs.items():
                    results[k][:, i].copy_(v)
            return {k: v.clone() for k, v in self.state.items()}, results


class ProgramCache:
    """Programs by key, at most `size` of them on each device, the least
    recently used on that device released first (with its graph and pool).
    A program on one device never evicts a program on another."""

    def __init__(self, size: int = MAX_PROGRAMS):
        self.size = size
        #: programs built (captured) so far
        self.builds = 0
        #: key -> (device, program), least recently used first
        self._programs: collections.OrderedDict[
            Hashable, Tuple[torch.device, Program]] = (
                collections.OrderedDict())

    def __len__(self) -> int:
        return len(self._programs)

    def items(self) -> List[Tuple[Hashable, Program]]:
        """(key, program) pairs, least recently used first."""
        return [(k, p) for k, (_, p) in self._programs.items()]

    def get(self, key: Hashable, build: Callable[[], Program],
            device: torch.device | str) -> Program:
        """The program of `key` on `device`, built on a miss; a build that
        raises leaves the cache without it."""
        entry = self._programs.pop(key, None)
        if entry is None:
            device = torch.device(device)
            held = [k for k, (d, _) in self._programs.items() if d == device]
            for k in held[:max(0, len(held) - self.size + 1)]:
                del self._programs[k]
            with trace.span("p64.graphs.build"):
                entry = (device, build())
            self.builds += 1
        self._programs[key] = entry
        return entry[1]

    def clear(self) -> None:
        self._programs.clear()


#: the programs of the encoder's entry points
PROGRAMS = ProgramCache()


def run(key: Hashable, step: Step, state: Mapping[str, torch.Tensor],
        inputs: Mapping[str, torch.Tensor], *, axis: int,
        cache: ProgramCache = PROGRAMS) -> Tuple[Tensors, Tensors]:
    """Run `step` over every frame of `inputs` through the program of
    `key` (built from `state` and frame 0 on a miss, and cached under the
    device of `inputs`): the counterpart of a jitted `lax.scan`.  `key`
    must name everything the step and the buffers' shapes depend on.
    Returns (final state, outputs (S, T, ...)).
    """
    if next(iter(inputs.values())).shape[axis] == 0:
        raise ValueError("no frames")
    frame0 = {k: v.select(axis, 0) for k, v in inputs.items()}
    prog = cache.get(key, lambda: Program(step, state, frame0),
                     next(iter(frame0.values())).device)
    return prog.run(state, inputs, axis)
