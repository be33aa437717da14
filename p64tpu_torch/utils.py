"""Small helpers shared by the port's modules."""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple, TypeVar

import numpy as np
import torch

_T = TypeVar("_T")
_R = TypeVar("_R")

_CONSTS: Dict[Tuple[int, str], Tuple[np.ndarray, torch.Tensor]] = {}


def device_const(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module-level numpy table as a tensor on `device`, copied once per
    device (so a frame loop makes no host-to-device copies for tables)."""
    key = (id(arr), str(torch.device(device)))
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not arr:
        hit = (arr, torch.as_tensor(arr, device=device))
        _CONSTS[key] = hit
    return hit[1]


def fan_map(fn: Callable[[_T], _R], items: Sequence[_T]) -> List[_R]:
    """Map fn over items across a thread pool, order preserved.

    For per-stream host work whose heavy lifting happens in the ctypes C++
    engine (GIL released for the duration of the call): encode serialize
    (core.encoder.serialize_streams) and decode parse (core.decoder
    .parse_many).  Tiny batches stay serial -- pool setup would dominate.
    """
    if len(items) <= 2:
        return [fn(x) for x in items]
    workers = min(len(items), (os.cpu_count() or 2))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def expand_inputs(patterns: Sequence[str]) -> List[str]:
    """Glob-expand CLI input patterns; non-matching patterns pass through
    as literal paths so downstream loaders report them."""
    paths = []
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else [pat])
    return paths
