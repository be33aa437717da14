"""Multi-process orchestration over `torch.distributed`.

Port of `p64tpu/distrib/multihost.py`.  Each process owns a local shard of
the streams and runs the same program as a single process
(`distrib.mesh`); per process:

  * feed the LOCAL streams to the local devices (`global_mesh`),
  * encode them (`encode_global`) and all-reduce the aggregate statistics
    across processes,
  * serialize the local streams on the local host (`finalize_local`),
  * exchange only per-stream bit lengths (`gather_stream_lengths`);
    bitstream BYTES stay with the process that made them (variable
    length; written per process and concatenated by job tooling).

The backend is the caller's choice, stated at `initialize`: "nccl" when
each process owns its own card (collectives on the card), "gloo" otherwise
(collectives on CPU tensors; two NCCL ranks cannot share one card).
Nothing switches backend on failure: a failed collective fails the run.

The reference's `_local_shard` assembles this host's slice of a global
JAX array from its addressable shards.  Torch has no global arrays: the
outputs of `encode_global` are already this process's shards, so the
port has no counterpart.

Worker processes must not be forked after CUDA is initialized: start them
with `subprocess` or the `spawn` start method.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import encoder as enc
from . import mesh as dm


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: str) -> None:
    """Join the process group at `coordinator` ("host:port") as rank
    `process_id` of `num_processes`, on `backend` ("nccl" or "gloo").  A
    no-op for a single process, as in the reference."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def global_mesh(devices: Optional[Sequence] = None) -> dm.Mesh:
    """This process's local devices on the streams axis (default: every
    CUDA device it can see)."""
    return dm.make_mesh(devices=devices)


def _collective_device() -> torch.device:
    """Where the process group's collectives take their tensors: the
    current card for NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def encode_global(cfg: enc.EncoderConfig, mesh: dm.Mesh,
                  local_frames: Mapping[str, object], states=None):
    """Encode this process's streams over its local mesh.

    local_frames: this process's streams, leading axis = local stream
    count (host arrays).  Returns (states', outputs, agg) as
    `mesh.make_sharded_encoder`'s fn does; when a process group is
    initialized, agg is all-reduced (summed) over every process."""
    if states is None:
        states = dm.init_states(cfg, local_frames["y"].shape[0])
    run = dm.make_sharded_encoder(cfg, mesh)
    new_states, outputs, agg = run(dm.shard_batch(mesh, states),
                                   dm.shard_batch(mesh, local_frames))
    if dist.is_initialized():
        dev = _collective_device()
        agg = {k: v.to(dev) for k, v in agg.items()}
        for v in agg.values():
            dist.all_reduce(v)
    return new_states, outputs, agg


def finalize_local(cfg: enc.EncoderConfig,
                   outputs) -> List[Tuple[bytes, int]]:
    """Serialize this process's streams: per-stream (bytes, nbits)."""
    return dm.serialize_streams(cfg, outputs)


def gather_stream_lengths(lengths: Sequence[int]) -> np.ndarray:
    """All-gather per-stream bit lengths across processes, in rank order
    (scalar metadata only; bytes never cross processes).  Every process
    must hold the same number of streams, as in the reference."""
    arr = np.asarray(lengths, np.int64)
    if not dist.is_initialized():
        return arr
    dev = _collective_device()
    world = dist.get_world_size()
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in range(world)]
    dist.all_gather(counts, torch.tensor([arr.size], device=dev))
    if len({int(c) for c in counts}) != 1:
        raise ValueError(f"gather_stream_lengths: processes hold unequal "
                         f"stream counts {[int(c) for c in counts]}")
    parts = [torch.empty(arr.size, dtype=torch.int64, device=dev)
             for _ in range(world)]
    dist.all_gather(parts, torch.as_tensor(arr, device=dev))
    return torch.cat(parts).cpu().numpy()
