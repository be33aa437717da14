"""The fixed-quantizer pinned bitstreams, encoded through the port.

Mirrors `p64tpu/tools/pinned.py` for the six pins whose settings the port
supports (rate control off): the same frozen content
(`p64tpu.tools.golden_content`) and settings, held to the same sha256 in
`tests/pinned_goldens.json`.  The seven rate-controlled pins wait for the
rate-control port.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Tuple

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PIN_FILE = os.path.join(_REPO, "tests", "pinned_goldens.json")

#: names of the pins the port reproduces
FIXED_Q_PINS = ("config1_qcif_intra_q12", "config2_qcif_inter_q12_s15",
                "adv_noise_q10", "adv_periodic_q10", "adv_scenecut_q10",
                "adv_smooth_q10")


def pinned_case(name: str):
    """(EncoderConfig, frames with a leading stream axis of 1) of a pin."""
    from p64tpu.spec.constants import QCIF
    from p64tpu.tools import golden_content as gc

    from ..control.ratecontrol import RateConfig
    from ..core.encoder import EncoderConfig

    if name == "config1_qcif_intra_q12":
        frames = gc.config1_qcif_intra()
        kw = dict(rate=RateConfig(fixed_quant=12), intra_only=True)
    elif name == "config2_qcif_inter_q12_s15":
        frames = gc.config2_qcif_inter()
        kw = dict(search=15, rate=RateConfig(fixed_quant=12))
    elif name.startswith("adv_") and name.endswith("_q10"):
        y = gc.adversarial_sequences()[name[len("adv_"):-len("_q10")]]
        frames = gc.luma_to_frames(y)
        kw = dict(rate=RateConfig(fixed_quant=10))
    else:
        raise KeyError(f"{name} is not a fixed-quantizer pin")
    return (EncoderConfig(fmt=QCIF, **kw),
            {k: v[None] for k, v in frames.items()})


def pinned_streams(device: torch.device | str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, encoded bytes) of every fixed-quantizer pin."""
    from ..core.encoder import encode_to_bytes
    for name in FIXED_Q_PINS:
        cfg, frames = pinned_case(name)
        data, _, _ = encode_to_bytes(cfg, frames, device=device)
        yield name, data[0]


def pinned_hashes() -> Dict[str, str]:
    """name -> pinned sha256 for the fixed-quantizer pins."""
    with open(PIN_FILE) as f:
        pins = json.load(f)
    return {name: pins[name]["sha256"] for name in FIXED_Q_PINS}
