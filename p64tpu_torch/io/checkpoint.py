"""Per-stream checkpoint / resume.

Port of `p64tpu/io/checkpoint.py`, on the same on-disk format key for key,
so each package reads the other's checkpoints.  Encoder state is small
(reconstructed reference planes, refresh counters, buffer, frame index),
so any frame boundary is a resume point: a checkpoint holds the state plus
the bytes of each stream emitted so far, and an encode resumed from it
continues exactly where the uninterrupted run would have been.  A state
the JAX package saved (no stream axis) resumes in the port through
`core.encoder.state_from_numpy`; one the port saved (leading stream axis,
the port's dtypes) can be passed to the encoder as it loads.

Crash safety: everything (state arrays, stream bytes, meta) lives in ONE
.npz published by a single fsync'd os.replace, so state and bytes are
paired atomically: a crash leaves either the old checkpoint or the whole
new one, never new stream bytes beside old state.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# state keys are stored under this prefix so they can never collide with
# the checkpoint's own bookkeeping entries below
_STATE = "state/"
_BITS = "__bits__"
_LENS = "__bits_lengths__"
_META = "__meta_json__"


def _to_numpy(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save(path: str, state: Mapping[str, object],
         streams: Optional[List[bytes]] = None,
         meta: Optional[Dict] = None) -> None:
    """Persist encoder state (tensors on any device, or arrays), the
    per-stream bytes so far and a JSON-able meta dict to `path + ".npz"`.

    Atomic and power-loss-safe: one temp file, fsync'd, then one
    os.replace, then the directory fsync'd -- either the old checkpoint
    or the complete new one exists, never a mix."""
    payload = {_STATE + k: _to_numpy(v) for k, v in state.items()}
    if streams is not None:
        payload[_LENS] = np.asarray([len(s) for s in streams], np.int64)
        payload[_BITS] = np.frombuffer(b"".join(streams), np.uint8)
    payload[_META] = np.frombuffer(
        json.dumps(meta or {}).encode(), np.uint8)

    tmp = path + ".npz.tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path + ".npz")
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                    os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    # drop companions of the old three-file layout (load() never reads
    # them, but a stale .bits invites confusion)
    for ext in (".bits", ".json"):
        if os.path.exists(path + ext):
            os.remove(path + ext)


def load(path: str, *, device: torch.device | str
         ) -> Tuple[Dict[str, torch.Tensor], List[bytes], Dict]:
    """Returns (state as tensors on `device` with the stored dtypes,
    per-stream bytes so far, meta)."""
    with np.load(path + ".npz") as z:
        state = {k[len(_STATE):]: torch.as_tensor(z[k], device=device)
                 for k in z.files if k.startswith(_STATE)}
        if not state:
            # a three-file checkpoint (bare state keys, companion
            # .bits/.json) would load as EMPTY state and a resume would
            # re-encode from frame 0 -- refuse it
            raise ValueError(
                f"{path}.npz is not a single-file p64tpu checkpoint "
                f"(no 'state/' keys -- pre-round-5 layout? re-save with "
                f"the current version)")
        meta = json.loads(z[_META].tobytes().decode()) if _META in z.files \
            else {}
        streams: List[bytes] = []
        if _LENS in z.files:
            blob = z[_BITS].tobytes()
            off = 0
            for n in z[_LENS]:
                streams.append(blob[off:off + int(n)])
                off += int(n)
    return state, streams, meta
