"""The pinned bitstreams, encoded through the port.

Mirrors `p64tpu/tools/pinned.py`: all thirteen pins, with the same frozen
content (`p64tpu_torch.tools.golden_content`) and settings, held to the same
sha256 in `tests/pinned_goldens.json`.  Six use a fixed quantizer, seven
rate control (two of those with mid-GOB MQUANT segments).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Tuple

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PIN_FILE = os.path.join(_REPO, "tests", "pinned_goldens.json")

_ADV = ("noise", "periodic", "scenecut", "smooth")

#: every pin, in the order of the reference's `pinned_streams`
ALL_PINS = ("config1_qcif_intra_q12", "config2_qcif_inter_q12_s15",
            "config3_cif_rc768k_t10",
            *(f"adv_{n}_{tag}" for n in _ADV for tag in ("q10", "rc192k")),
            "cif_rc1M_mquant3_t3", "mquant2pass_graded_qcif")


def pinned_case(name: str):
    """(EncoderConfig, frames with a leading stream axis of 1) of a pin,
    with the settings of the reference's `pinned_streams`."""
    from ..spec.constants import CIF, QCIF
    from ..tools import golden_content as gc

    from ..control.ratecontrol import RateConfig
    from ..core.encoder import EncoderConfig

    fmt = QCIF
    if name == "config1_qcif_intra_q12":
        frames = gc.config1_qcif_intra()
        kw = dict(rate=RateConfig(fixed_quant=12), intra_only=True)
    elif name == "config2_qcif_inter_q12_s15":
        frames = gc.config2_qcif_inter()
        kw = dict(search=15, rate=RateConfig(fixed_quant=12))
    elif name == "config3_cif_rc768k_t10":
        fmt, frames = CIF, gc.config3_cif_rc(10)
        kw = dict(search=15, rate=RateConfig(bit_rate=768000))
    elif name.startswith("adv_") and name.endswith(("_q10", "_rc192k")):
        seq, tag = name[len("adv_"):].rsplit("_", 1)
        frames = gc.luma_to_frames(gc.adversarial_sequences()[seq])
        kw = dict(rate=RateConfig(fixed_quant=10) if tag == "q10" else
                  RateConfig(bit_rate=192_000, frame_rate=30))
    elif name == "cif_rc1M_mquant3_t3":
        fmt = CIF
        frames = {k: v[:3] for k, v in gc.config3_cif_rc(3).items()}
        kw = dict(search=15, rate=RateConfig(bit_rate=1_024_000,
                                             frame_rate=30,
                                             mquant_segments=3))
    elif name == "mquant2pass_graded_qcif":
        frames = gc.graded_energy_qcif()
        kw = dict(rate=RateConfig(bit_rate=700_000, frame_rate=30,
                                  mquant_segments=3))
    else:
        raise KeyError(f"{name} is not a pin")
    return (EncoderConfig(fmt=fmt, **kw),
            {k: v[None] for k, v in frames.items()})


def pinned_streams(device: torch.device | str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, encoded bytes) of every pin."""
    from ..core.encoder import encode_to_bytes
    for name in ALL_PINS:
        cfg, frames = pinned_case(name)
        data, _, _ = encode_to_bytes(cfg, frames, device=device)
        yield name, data[0]


def pinned_hashes() -> Dict[str, str]:
    """name -> pinned sha256, for every pin."""
    with open(PIN_FILE) as f:
        pins = json.load(f)
    return {name: pins[name]["sha256"] for name in ALL_PINS}
