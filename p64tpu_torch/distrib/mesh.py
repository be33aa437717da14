"""Data-parallel scale-out: independent streams sharded over devices.

Port of `p64tpu/distrib/mesh.py`.  The only parallel axis with an analogue
in this workload is data parallelism over independent streams (the
frame-recursive reconstruction forbids splitting one stream's time axis
across devices, and there are no weights to shard); within a stream, the
encoder batches every MB of a frame through the kernels.

The port keeps the reference's contract, not its machinery:

  * a mesh is an ordered tuple of torch devices on one `streams` axis
    (`make_mesh`); the same device may appear more than once, as logical
    shards (four CPU shards give the same bytes as one);
  * `shard_batch` splits the stream axis into contiguous slices, one per
    mesh entry, each copied from host memory straight to its own device;
  * the sharded encoder runs `core.encoder.encode_sequence` on each
    shard's device and sums the aggregate statistics (the reference's
    `psum`) in int64 and float64 -- no 15-bit hi/lo split, which the
    reference needs only because JAX runs without x64;
  * serialization is host work per stream, in global stream order.

JAX caches compiled executables per (config, mesh) so that each chunk does
not re-trace.  The port's counterpart is `core.graphs`' program cache: on a
card every shard's `encode_sequence` replays one captured frame step per
(config, streams, device), built once under that device.  The cache is
bounded per device, so a mesh of any number of cards keeps every shard's
program across calls; logical shards of one card with equal stream counts
share one program.

The host queues each shard's frame loop in turn, a few launches per frame;
`distrib.multihost` runs one process per card.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .. import trace
from ..core import encoder as enc

#: a mesh: devices in stream order, one shard each
Mesh = Tuple[torch.device, ...]
#: a sharded tree: one dict of tensors per mesh entry, in stream order
Sharded = List[Dict[str, torch.Tensor]]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over `devices`, default every visible CUDA device (the first
    `n_devices` of them when given).  Raises if that leaves none."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise RuntimeError("make_mesh: no devices (no CUDA device is "
                           "visible; pass devices= for CPU shards)")
    return mesh


def init_states(cfg: enc.EncoderConfig, n_streams: int) -> enc.State:
    """Batched per-stream encoder state in host memory (leading axis =
    stream), ready for shard_batch."""
    return enc.init_state(cfg, n_streams, "cpu")


def shard_batch(mesh: Mesh, tree: Mapping[str, object]) -> Sharded:
    """Split each (S, ...) array or host tensor of `tree` into len(mesh)
    contiguous slices along the stream axis (sizes differ by at most one,
    larger first) and copy slice i to mesh[i].

    Each slice goes from host memory straight to its device: nothing is
    staged through one device first.  Copies that cross to a card are
    counted (trace.count_copy)."""
    n = next(iter(tree.values())).shape[0]
    if n < len(mesh):
        raise ValueError(f"shard_batch: {n} streams cannot fill "
                         f"{len(mesh)} shards")
    q, r = divmod(n, len(mesh))
    out, s = [], 0
    for i, dev in enumerate(mesh):
        e = s + q + (i < r)
        shard = {}
        for k, v in tree.items():
            host = torch.as_tensor(v[s:e])
            trace.count_copy(host, dev, host.nbytes)
            shard[k] = host.to(dev)
        out.append(shard)
        s = e
    return out


def make_sharded_encoder(cfg: enc.EncoderConfig, mesh: Mesh):
    """Multi-stream encoder over `mesh`.

    Returns fn(states, frames) -> (states', outputs, agg): states, frames,
    states' and outputs are sharded (shard_batch's layout); agg holds the
    aggregate statistics over all shards as 0-dim tensors on mesh[0]:
    total_bits (int64), total_sse_y (float64) and frames_coded (int64).
    Nothing here waits for a device: reading agg, or an output, does.
    """
    def run(states: Sharded, frames: Sharded):
        if len(states) != len(mesh) or len(frames) != len(mesh):
            raise ValueError(f"expected {len(mesh)} shards of states and "
                             f"frames, got {len(states)} and {len(frames)}")
        new_states, outputs = [], []
        agg = dict(total_bits=0, total_sse_y=0, frames_coded=0)
        for dev, st, fr in zip(mesh, states, frames):
            st2, out = enc.encode_sequence(cfg, fr, st, device=dev)
            new_states.append(st2)
            outputs.append(out)
            for k, v in (
                    ("total_bits", out["total_bits"].sum(dtype=torch.int64)),
                    ("total_sse_y", out["sse_y"].sum(dtype=torch.float64)),
                    ("frames_coded",
                     out["frame_coded"].sum(dtype=torch.int64))):
                agg[k] = agg[k] + v.to(mesh[0])
        return new_states, outputs, agg

    return run


def agg_total_bits(agg) -> int:
    """Exact aggregate bit count."""
    return int(agg["total_bits"])


def serialize_streams(cfg: enc.EncoderConfig,
                      outputs: Sequence[Mapping[str, object]]
                      ) -> List[Tuple[bytes, int]]:
    """Host finalize: per-stream (bytes, nbits) in global stream order.

    outputs: sharded encoder outputs, one dict per shard, of tensors on
    any device or of host arrays (core.encoder.outputs_to_symbols).  The
    native serializer is fanned across threads within each shard
    (core.encoder.serialize_streams)."""
    return [r for out in outputs for r in enc.serialize_streams(cfg, out)]
