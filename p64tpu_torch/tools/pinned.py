"""The pinned bitstreams, encoded through the port.

Mirrors `p64tpu/tools/pinned.py`: all thirteen pins, with the same frozen
content (`p64tpu_torch.tools.golden_content`) and settings, held to the same
sha256 in `tests/pinned_goldens.json`.  Six use a fixed quantizer, seven
rate control (two of those with mid-GOB MQUANT segments).

    python -m p64tpu_torch.tools.pinned [--device cuda|cpu]

encodes every pin on the device (default cuda) and checks it against the
pin file: `DRIFT` for a pin whose stream changed, `UNPINNED` for one the
file lacks, then `PINS OK` (exit 0) or `PINS CHANGED` (exit 1).  The
reference's `--write` is not ported: the pin file belongs to the JAX
package, and the port only checks against it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Dict, Iterator, Optional, Tuple

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


def current_hashes(device: torch.device | str,
                   streams: Optional[Dict[str, bytes]] = None
                   ) -> Dict[str, Dict[str, object]]:
    """name -> {"sha256", "bytes"} of every pin encoded on `device`, in the
    pin file's form; `streams`, if given, also receives name -> bytes."""
    out = {}
    for name, data in pinned_streams(device):
        out[name] = dict(sha256=hashlib.sha256(data).hexdigest(),
                         bytes=len(data))
        if streams is not None:
            streams[name] = data
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="p64tpu_torch.tools.pinned",
                                 description="check the pinned streams")
    ap.add_argument("--device", default="cuda",
                    help="torch device to encode on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("pinned: no CUDA device is available; pass --device cpu to "
              "encode on the CPU", file=sys.stderr)
        return 2
    got = current_hashes(device)
    with open(PIN_FILE) as f:
        want = json.load(f)
    drift = [k for k in got if k in want and got[k] != want[k]]
    unpinned = [k for k in got if k not in want]
    for k in drift:
        print(f"DRIFT {k}: pinned {want[k]} != current {got[k]}")
    for k in unpinned:
        print(f"UNPINNED {k}: {got[k]}")
    ok = not (drift or unpinned)
    print("PINS OK" if ok else "PINS CHANGED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
