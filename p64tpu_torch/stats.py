"""Statistics reporting: PSNR/MSE per component, bits per frame, rates.

The port's copy of `p64tpu.stats`.  PSNR and bit counts double as
correctness signals, so they are computed from exact integer SSE/bit
values.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    mse = float(((a - b) ** 2).mean())
    if mse == 0:
        return math.inf
    return 10.0 * math.log10(255.0 ** 2 / mse)


def frame_report(idx: int, coded: bool, bits: int,
                 rec: Dict[str, np.ndarray],
                 src: Dict[str, np.ndarray]) -> str:
    if not coded:
        return f"frame {idx:4d}: skipped (rate control)"
    py = psnr(rec["y"], src["y"])
    pcb = psnr(rec["cb"], src["cb"])
    pcr = psnr(rec["cr"], src["cr"])
    return (f"frame {idx:4d}: {bits:7d} bits  "
            f"Y {py:6.2f} dB  Cb {pcb:6.2f} dB  Cr {pcr:6.2f} dB")


def sequence_report(total_bits: int, n_coded: int, n_input: int,
                    frame_rate: int) -> str:
    kbps = total_bits * frame_rate / max(n_input, 1) / 1000.0
    return (f"{n_coded}/{n_input} frames coded, {total_bits} bits "
            f"(~{kbps:.1f} kbit/s at {frame_rate} fps input)")
