"""Encoder config-space fuzz of the port, the card held against the CPU.

Port of `tools/fuzz_encoder.py`: the same sampler (one seed draws the same
configurations and the same frames) and the same self-consistency contract
on every sample, encoded as one stream:

  * encode_to_bytes succeeds (its serializer == device-bit-model check runs
    on every encode);
  * core.decoder.decode_stream round-trips the stream: one parsed picture
    per coded frame and, with emit_recon, every decoded plane equal to the
    encoder's reconstruction;
  * a resync parse of the clean stream (entropy.parse.parse_stream with
    strict=False) flags no damage and gives the strict parse's levels and
    coded flags.

The sampler draws the format (QCIF, or CIF one time in five), 1-5 frames,
search in {0, 1, 2, 3, 7, 15} (0 is intra only), a fixed quantizer or rate
control at 32 kbit/s-4 Mbit/s with 1-5 MQUANT segments and minimum-rate fill
on or off, intra period 0-3, loop filter and emit_recon on or off, and the
content families noise, flat (every SAD offset ties), gradient, bright (the
decision variance at its int32 edge), dark and a moving box.

With --device cuda (the default) every sample is also encoded on the CPU:
the card's bytes, total_bits, frame_coded and reconstruction must equal the
CPU's, and the SAD-search kernel must launch once per frame of an inter
sample and never for an intra-only one.

    python -m p64tpu_torch.tools.fuzz_encoder [seconds] [--count N]
        [--device cuda|cpu]

runs for `seconds` (default 300), or exactly N samples; FUZZ_SEED (default
77) seeds the sampler.  Without a card, --device cuda exits 2.  The first
failure prints the sample and its first diverging field and index, writes
the sample's configuration, with the seed and index that regenerate its
frames, to fuzz_fail.json in the working directory, and exits 1.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

FAMILIES = ("noise", "flat", "gradient", "bright", "dark", "moving")
SEARCHES = (0, 1, 2, 3, 7, 15)
#: file the first failing sample is written to, in the working directory
FAIL_FILE = "fuzz_fail.json"


def family_content(rng: np.random.Generator, fmt, t: int, family: str):
    """(T, H, W) luma and (T, H/2, W/2) chroma uint8 frames of one content
    family, drawn from rng as the reference tool draws them."""
    h, w = fmt.height, fmt.width
    if family == "noise":
        y = rng.integers(0, 256, (t, h, w))
    elif family == "flat":
        y = np.full((t, h, w), int(rng.integers(0, 256)))
    elif family == "gradient":
        yy, xx = np.mgrid[0:h, 0:w]
        y = np.broadcast_to((xx + yy) % 256, (t, h, w)).copy()
    elif family == "bright":
        y = rng.integers(182, 256, (t, h, w))     # mean > 181
    elif family == "dark":
        y = rng.integers(0, 24, (t, h, w))
    else:  # moving box over texture
        base = rng.integers(0, 200, (h, w))
        y = np.stack([np.roll(base, 5 * k, axis=1) for k in range(t)])
        for k in range(t):
            y[k, 20:80, (10 + 11 * k) % (w - 64):][:, :64] = 255
    y = y.astype(np.uint8)
    c = rng.integers(0, 256, (t, h // 2, w // 2)).astype(np.uint8)
    return dict(y=y, cb=c, cr=(255 - c).astype(np.uint8))


def sample(rng: np.random.Generator) -> dict:
    """One sample as a dict of primitives (`fmt` is the format's name,
    `rate` the RateConfig fields) plus its `frames`, drawn in the reference
    tool's order."""
    from ..control.ratecontrol import RateConfig
    from ..spec.constants import CIF, QCIF

    fmt = CIF if rng.random() < 0.2 else QCIF
    t = int(rng.integers(1, 6))
    search = int(rng.choice(list(SEARCHES)))
    if rng.random() < 0.5:
        rate = RateConfig(
            bit_rate=int(rng.integers(32, 4000)) * 1000,
            frame_rate=int(rng.choice([10, 25, 30])),
            mquant_segments=int(rng.choice([1, 1, 2, 3, 5])),
            initial_quant=int(rng.integers(2, 26)),
            min_rate_fill=bool(rng.random() < 0.8))
        if rate.mquant_segments > 1 and rate.bit_rate <= 0:
            rate = RateConfig(fixed_quant=8)
    else:
        rate = RateConfig(fixed_quant=int(rng.integers(1, 32)))
    intra_period = int(rng.choice([0, 0, 1, 2, 3]))
    emit_recon = bool(rng.random() < 0.7)
    filter_with_mc = bool(rng.random() < 0.8)
    family = FAMILIES[int(rng.integers(len(FAMILIES)))]
    return dict(fmt=fmt.name, t=t, search=search,
                rate=dataclasses.asdict(rate), intra_only=search == 0,
                intra_period=intra_period, emit_recon=emit_recon,
                filter_with_mc=filter_with_mc, family=family,
                frames=family_content(rng, fmt, t, family))


def port_config(s: dict):
    """The port's EncoderConfig of a sample."""
    from ..control.decisions import DecisionConfig
    from ..control.ratecontrol import RateConfig
    from ..core.encoder import EncoderConfig
    from ..spec.constants import CIF, QCIF

    return EncoderConfig(
        fmt={"CIF": CIF, "QCIF": QCIF}[s["fmt"]], search=s["search"],
        rate=RateConfig(**s["rate"]), intra_only=s["intra_only"],
        intra_period=s["intra_period"], emit_recon=s["emit_recon"],
        decisions=DecisionConfig(filter_with_mc=s["filter_with_mc"]))


def first_difference(a, b) -> Optional[str]:
    """None when a equals b (arrays or bytes), else where they first
    differ."""
    if isinstance(a, bytes):
        a, b = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        if a.ndim == b.ndim == 1:
            n = min(a.size, b.size)
            bad = np.flatnonzero(a[:n] != b[:n])
            at = int(bad[0]) if bad.size else n
            return f"length {a.size} != {b.size}, first differs at {at}"
        return f"shape {a.shape} != {b.shape}"
    bad = np.argwhere(a != b)
    if not bad.size:
        return None
    at = tuple(int(i) for i in bad[0])
    return f"first differs at index {at}: {a[at]} != {b[at]}"


def _same(what: str, got, want) -> None:
    diff = first_difference(got, want)
    if diff is not None:
        raise AssertionError(f"{what}: {diff}")


def check(s: dict, device: torch.device | str) -> dict:
    """Encode the sample as one stream on `device` and assert the
    self-consistency contract.  Returns the stream's `data`, and host
    copies of its `total_bits` and `frame_coded` (T,) and, with emit_recon,
    its `recon` (y, cb, cr) (T, ...) planes (else None)."""
    from ..core import decoder
    from ..core.encoder import RECON_KEYS, encode_to_bytes
    from ..entropy import parse

    cfg = port_config(s)
    datas, outputs, _ = encode_to_bytes(
        cfg, {k: v[None] for k, v in s["frames"].items()}, device=device)
    data = datas[0]
    coded = outputs["frame_coded"][0].cpu().numpy()
    recon = (tuple(outputs[k][0].cpu().numpy() for k in RECON_KEYS)
             if cfg.emit_recon else None)
    y, cb, cr, parsed = decoder.decode_stream(data, device=device)
    if len(parsed) != int(coded.sum()):
        raise AssertionError(f"decode_stream parsed {len(parsed)} pictures "
                             f"of {int(coded.sum())} coded frames")
    if recon is not None:
        for name, got, want in zip(("y", "cb", "cr"), (y, cb, cr), recon):
            _same(f"decoded {name} against recon_{name}", got, want[coded])
    resync = parse.parse_stream(data, strict=False)
    if len(resync) != len(parsed):
        raise AssertionError(f"resync parse of the clean stream gave "
                             f"{len(resync)} pictures, strict {len(parsed)}")
    for i, (a, b) in enumerate(zip(parsed, resync)):
        if b.damaged:
            raise AssertionError(f"resync parse flags picture {i} of the "
                                 "clean stream damaged")
        _same(f"picture {i} levels, resync against strict", b.levels,
              a.levels)
        _same(f"picture {i} coded, resync against strict", b.coded, a.coded)
    return dict(data=data, total_bits=outputs["total_bits"][0].cpu().numpy(),
                frame_coded=coded, recon=recon)


def check_on(s: dict, device: torch.device | str) -> tuple:
    """check(s, device); on a CUDA device also check(s, "cpu"), hold the
    card's stream, bit counts, coded flags and reconstruction to the CPU's,
    and the SAD-search launches to one per frame of an inter sample and
    none for an intra-only one.  Returns (the device's check, launches)."""
    from ..kernels import me_cuda

    dev = torch.device(device)
    before = me_cuda.LAUNCHES
    got = check(s, dev)
    launches = me_cuda.LAUNCHES - before
    if dev.type == "cuda":
        want = check(s, "cpu")
        for key in ("data", "total_bits", "frame_coded"):
            _same(f"{key}, card against CPU", got[key], want[key])
        if s["emit_recon"]:
            for name, a, b in zip(("y", "cb", "cr"), got["recon"],
                                  want["recon"]):
                _same(f"recon_{name}, card against CPU", a, b)
        expected = 0 if s["intra_only"] else s["t"]
        if launches != expected:
            raise AssertionError(f"SAD-search kernel launched {launches} "
                                 f"times, expected {expected}")
    return got, launches


def describe(s: dict) -> dict:
    """A sample's primitives, without its frames."""
    return {k: v for k, v in s.items() if k != "frames"}


class FuzzFailure(Exception):
    """A sample broke the contract: its index (from 1), the sample and what
    diverged."""

    def __init__(self, index: int, sample_: dict, message: str) -> None:
        super().__init__(f"sample {index}: {message}")
        self.index, self.sample, self.message = index, sample_, message


def run(device: torch.device | str, seed: int = 77,
        count: Optional[int] = None, budget: float = 300.0,
        log: Optional[Callable[[str], None]] = None) -> Dict[str, object]:
    """Draw samples from `seed` and check each on `device` (check_on):
    exactly `count` of them, or as many as `budget` seconds allow.  Raises
    FuzzFailure on the first that fails.  Returns the tallies: configs,
    cif, rate_controlled, skipped (samples with an uncoded frame),
    intra_only, searches (search -> samples), sad_launches,
    seconds."""
    rng = np.random.default_rng(seed)
    tally = dict(configs=0, cif=0, rate_controlled=0, skipped=0,
                 intra_only=0, searches=collections.Counter(),
                 sad_launches=0)
    t0 = time.time()
    for index in itertools.count(1):
        if count is not None and index > count:
            break
        if count is None and time.time() - t0 >= budget:
            break
        s = sample(rng)
        try:
            got, launches = check_on(s, device)
        except (AssertionError, ValueError) as e:
            # a broken contract, or a clean stream refused; any other
            # error, a CUDA fault among them, propagates
            raise FuzzFailure(index, s, f"{type(e).__name__}: {e}") from e
        coded = got["frame_coded"]
        bits = int(got["total_bits"][coded].sum())
        rate = s["rate"]
        tally["configs"] += 1
        tally["cif"] += s["fmt"] == "CIF"
        tally["rate_controlled"] += rate["bit_rate"] > 0
        tally["skipped"] += not coded.all()
        tally["intra_only"] += s["intra_only"]
        tally["searches"][s["search"]] += 1
        tally["sad_launches"] += launches
        if log is not None:
            log(f"  ok {index}: {s['fmt']} t={s['t']} search={s['search']} "
                f"rc={rate['bit_rate']} seg={rate['mquant_segments']} "
                f"ip={s['intra_period']} fil={s['filter_with_mc']} "
                f"recon={s['emit_recon']} {s['family']} bits={bits} "
                f"coded={int(coded.sum())}/{s['t']} sad_launches={launches}")
    tally["searches"] = dict(sorted(tally["searches"].items()))
    tally["seconds"] = time.time() - t0
    return tally


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="p64tpu_torch.tools.fuzz_encoder",
        description="encoder config-space fuzz, the card held against the "
                    "CPU")
    ap.add_argument("seconds", nargs="?", type=float, default=300.0,
                    help="time budget when --count is not given "
                         "(default 300)")
    ap.add_argument("--count", type=int, default=None,
                    help="check exactly this many samples")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to encode on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("fuzz_encoder: no CUDA device is available; pass --device cpu "
              "to fuzz on the CPU", file=sys.stderr)
        return 2
    seed = int(os.environ.get("FUZZ_SEED", "77"))
    t0 = time.time()
    try:
        tally = run(device, seed, args.count, args.seconds,
                    log=lambda m: print(m, file=sys.stderr, flush=True))
    except FuzzFailure as f:
        record = dict(describe(f.sample), seed=seed, index=f.index,
                      device=args.device, failure=f.message)
        with open(FAIL_FILE, "w") as fh:
            json.dump(record, fh, indent=1)
        print(f"FAILURE at sample {f.index}: {f.message}")
        print(f"sample: {json.dumps(describe(f.sample))} (saved to "
              f"{FAIL_FILE} with seed {seed} and index {f.index})")
        return 1
    print(f"  {args.device}: {tally['cif']} CIF, {tally['rate_controlled']} "
          f"rate-controlled, {tally['skipped']} with a skipped frame, "
          f"searches {tally['searches']}, SAD-search launches "
          f"{tally['sad_launches']}", file=sys.stderr)
    print(f"encoder config fuzz: {tally['configs']} configs, all contracts "
          f"held, {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
