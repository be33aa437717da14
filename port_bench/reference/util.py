"""Tables on the device, copied once per device."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_CONSTS: Dict[Tuple[int, str], Tuple[np.ndarray, torch.Tensor]] = {}


def device_const(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module-level numpy table as a tensor on `device`, copied once per
    device."""
    key = (id(arr), str(torch.device(device)))
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not arr:
        hit = (arr, torch.as_tensor(arr, device=device))
        _CONSTS[key] = hit
    return hit[1]
