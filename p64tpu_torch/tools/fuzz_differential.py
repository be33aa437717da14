"""Decode differential fuzz of the port: every parse and decode path must
agree on arbitrary corrupted input, and the card must agree with the CPU.

Port of `tools/fuzz_differential.py`, with the same base streams and the
same seeded corruptions.  Per corrupted stream:

  (a) the Python parser (entropy.parse.parse_stream, strict=False) and the
      C++ engine (native parse, resync=True) give the same pictures:
      count, format, TR, damage flag and every symbol field;
  (b) both accept, or both reject, the stream in strict mode;
  (c) decode_stream(resync=True) and parse_to_tensors(resync=True) +
      decode_seq give the same planes on the device, or both refuse the
      stream with a ValueError (StreamError is one);
  (d) with a CUDA device, both paths also run on the CPU and the card's
      planes or refusal equal the CPU's.

Any other exception, a CUDA fault among them, propagates.

    python -m p64tpu_torch.tools.fuzz_differential [seconds] [--count N]
        [--device cuda|cpu]

runs for `seconds` (default 300), or exactly N streams; FUZZ_SEED (default
999) seeds the corruptions.  Without a card, --device cuda exits 2.  The
first disagreement writes the stream to fuzz_fail.bin in the working
directory and exits 1.

Corruption modes (`corrupt`): random bit flips, truncation + a flip, a
splice of two streams at byte offsets (duplicate-GN re-parses come from
here), and a random byte-run overwrite.  The base streams cover QCIF, CIF,
MQUANT and sparse CIF pictures (`base_streams`).
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

#: the symbol fields of a parsed picture the engines must agree on
FIELDS = ("gquant", "coded", "intra", "mc", "fil", "quant", "mv", "cbp",
          "levels", "gob_damaged")
#: file the first disagreeing stream is written to, in the working directory
FAIL_FILE = "fuzz_fail.bin"


def random_frame_symbols(fmt, rng: np.random.Generator, tr: int = 0,
                         p_coded: float = 0.85, p_intra: float = 0.3,
                         p_mquant: float = 0.0):
    """Random but valid FrameSymbols of one picture (the reference tests'
    generator, drawing the same values from rng): MVs kept inside the
    picture, intra DC levels 1..254, about half the inter blocks starting
    with +-1, and, with p_mquant, MQUANT MBs with their quantizer chain."""
    from ..core.blocks import transmission_order
    from ..entropy.encode import FrameSymbols
    from ..spec.tables import MTYPE_BY_NAME

    n = fmt.num_mbs
    coded = rng.random(n) < p_coded
    intra = rng.random(n) < p_intra
    mc = (~intra) & (rng.random(n) < 0.6)
    fil = mc & (rng.random(n) < 0.5)
    mv = np.where(mc[:, None], rng.integers(-15, 16, (n, 2)),
                  0).astype(np.int32)
    mb_cols = fmt.width // 16
    y0 = (np.arange(n) // mb_cols) * 16
    x0 = (np.arange(n) % mb_cols) * 16
    mv[:, 0] = np.clip(mv[:, 0], -x0, fmt.width - 16 - x0)
    mv[:, 1] = np.clip(mv[:, 1], -y0, fmt.height - 16 - y0)

    levels = np.zeros((n, 6, 64), np.int16)
    sparse = rng.random((n, 6, 64)) < 0.08
    vals = rng.integers(-127, 128, (n, 6, 64))
    vals[vals == 0] = 1
    levels[sparse] = vals[sparse]
    dc = rng.integers(1, 255, (n, 6))
    levels[intra, :, 0] = dc[intra]
    first1 = (~intra)[:, None] & (rng.random((n, 6)) < 0.5) & sparse[:, :, 0]
    levels[:, :, 0] = np.where(first1, rng.choice([-1, 1], (n, 6)),
                               levels[:, :, 0])

    cbp = np.zeros(n, np.int32)
    nzblk = (levels != 0).any(axis=-1)
    for b in range(6):
        cbp |= nzblk[:, b].astype(np.int32) << (5 - b)

    mtype = np.zeros(n, np.int32)
    has_coef = cbp > 0
    mtype[intra] = MTYPE_BY_NAME["intra"]
    mtype[~intra & ~mc & has_coef] = MTYPE_BY_NAME["inter"]
    mtype[~intra & mc & ~fil & has_coef] = MTYPE_BY_NAME["inter_mc_coef"]
    mtype[~intra & mc & fil & has_coef] = MTYPE_BY_NAME["inter_fil_coef"]
    mtype[~intra & mc & ~fil & ~has_coef] = MTYPE_BY_NAME["inter_mc"]
    mtype[~intra & mc & fil & ~has_coef] = MTYPE_BY_NAME["inter_fil"]
    # inter, no MC, no coefficients: not codeable
    coded &= ~(~intra & ~mc & ~has_coef)
    no_tc = ~coded | (~intra & ~has_coef)
    levels[no_tc] = 0
    cbp[~coded] = 0
    mv[~coded] = 0

    gquant = rng.integers(1, 32, fmt.num_gobs).astype(np.int32)

    quant_mb = None
    if p_mquant > 0:
        upgrade = {MTYPE_BY_NAME["intra"]: MTYPE_BY_NAME["intra_mquant"],
                   MTYPE_BY_NAME["inter"]: MTYPE_BY_NAME["inter_mquant"],
                   MTYPE_BY_NAME["inter_mc_coef"]:
                       MTYPE_BY_NAME["inter_mc_mquant"],
                   MTYPE_BY_NAME["inter_fil_coef"]:
                       MTYPE_BY_NAME["inter_fil_mquant"]}
        eligible = coded & np.isin(mtype, list(upgrade))
        pick = eligible & (rng.random(n) < p_mquant)
        newq = rng.integers(1, 32, n).astype(np.int32)
        for base, mq in upgrade.items():
            mtype[pick & (mtype == base)] = mq
        # the effective quantizer a decoder tracks: GQUANT, replaced at
        # each MQUANT MB in transmission order
        quant_mb = np.zeros(n, np.int32)
        perm = transmission_order(fmt)
        mbs_per_gob = perm.size // fmt.num_gobs
        for gi in range(fmt.num_gobs):
            eff = int(gquant[gi])
            for idx in range(mbs_per_gob):
                raster = int(perm[gi * mbs_per_gob + idx])
                if pick[raster]:
                    eff = int(newq[raster])
                quant_mb[raster] = eff

    return FrameSymbols(tr=tr, gquant=gquant, coded=coded, mtype=mtype,
                        mv=mv, cbp=cbp, levels=levels, quant_mb=quant_mb)


def base_streams() -> List[bytes]:
    """The three clean streams the corruptions start from, 3 pictures each,
    serialized by the native engine: QCIF (seed 1), QCIF with MQUANT MBs
    (seed 2) and sparse CIF (seed 3)."""
    from ..entropy.encode import serialize_sequence
    from ..spec.constants import CIF, QCIF

    streams = []
    for fmt, seed in ((QCIF, 1), (QCIF, 2), (CIF, 3)):
        rng = np.random.default_rng(seed)
        frames = [random_frame_symbols(
            fmt, rng, tr=t, p_mquant=0.25 if seed == 2 else 0.0,
            p_coded=0.25 if fmt is CIF else 0.7) for t in range(3)]
        streams.append(serialize_sequence(fmt, frames)[0])
    return streams


def corrupt(rng: np.random.Generator, base: bytes,
            streams: Sequence[bytes]) -> Tuple[int, bytes]:
    """One corrupted copy of `base`, drawn from rng: mode 0 flips 1-6 bits,
    1 truncates and flips a bit, 2 splices a tail of one of `streams` after
    a prefix, 3 overwrites a run of up to 63 random bytes.  Returns (mode,
    bytes)."""
    d = bytearray(base)
    mode = int(rng.integers(4))
    if mode == 0:
        for _ in range(1 + int(rng.integers(6))):
            p = int(rng.integers(len(d)))
            d[p] ^= 1 << int(rng.integers(8))
    elif mode == 1:
        d = bytearray(d[:int(rng.integers(1, len(d)))])
        if len(d) > 2:
            p = int(rng.integers(len(d)))
            d[p] ^= 1 << int(rng.integers(8))
    elif mode == 2:
        other = streams[int(rng.integers(len(streams)))]
        d = bytearray(bytes(d[:int(rng.integers(len(d)))])
                      + other[int(rng.integers(len(other))):])
    else:
        p = int(rng.integers(len(d)))
        ln = int(rng.integers(1, 64))
        d[p:p + ln] = bytes(rng.integers(0, 256, min(ln, len(d) - p),
                                         dtype=np.uint8))
    return mode, bytes(d)


def corruptions(seed: int) -> Iterator[Tuple[int, bytes]]:
    """Endless (mode, bytes) corrupted copies of the base streams: each
    draws its base stream, then corrupt() draws the rest, all from one
    generator seeded with `seed`, in the reference tool's order."""
    streams = base_streams()
    rng = np.random.default_rng(seed)
    while True:
        yield corrupt(rng, streams[int(rng.integers(len(streams)))], streams)


def field_difference(data: bytes) -> Optional[str]:
    """(a): None when the Python parser's and the engine's resync parses of
    `data` agree exactly, else the first difference."""
    from ..entropy import parse
    from ..native import load

    fp = parse.parse_stream(data, strict=False)
    fn = load().parse(data, resync=True)
    if len(fp) != len(fn):
        return f"frame count: Python {len(fp)}, engine {len(fn)}"
    for i, (a, b) in enumerate(zip(fp, fn)):
        if a.fmt is not b.fmt or a.tr != b.tr:
            return (f"picture {i} header: Python {a.fmt.name} TR {a.tr}, "
                    f"engine {b.fmt.name} TR {b.tr}")
        if bool(a.damaged) != bool(b.damaged):
            return (f"picture {i} damage flag: Python {a.damaged}, engine "
                    f"{b.damaged}")
        for f in FIELDS:
            bad = np.argwhere(np.asarray(getattr(a, f))
                              != np.asarray(getattr(b, f)))
            if bad.size:
                at = tuple(int(x) for x in bad[0])
                return (f"picture {i} {f} at {at}: Python "
                        f"{getattr(a, f)[at]}, engine {getattr(b, f)[at]}")
    return None


def strict_outcome(fn: Callable[[bytes], list], data: bytes) -> tuple:
    """("ok", pictures) when fn(data) parses, ("err",) on a StreamError."""
    from ..entropy.parse import StreamError

    try:
        return ("ok", len(fn(data)))
    except StreamError:
        return ("err",)


def strict_difference(data: bytes) -> Tuple[bool, Optional[str]]:
    """(b): whether the engine accepts `data` in strict mode, and None when
    the Python parser does the same, else what each did."""
    from ..entropy import parse
    from ..native import load

    a = strict_outcome(parse.parse_stream, data)
    b = strict_outcome(load().parse, data)
    return b[0] == "ok", (None if a == b else
                          f"strict accept/reject: Python {a}, engine {b}")


def planes_or_refusal(fn: Callable[[], tuple]):
    """fn()'s (y, cb, cr) as numpy arrays, or the ValueError the stream drew
    (StreamError is one); any other error, a CUDA fault among them,
    propagates."""
    try:
        return tuple(np.asarray(p) for p in fn()[:3])
    except ValueError as e:
        return e


def decode_paths(data: bytes, device: torch.device | str
                 ) -> Dict[str, object]:
    """Path name -> planes or refusal of `data` decoded with resync through
    decode_stream and through parse_to_tensors + decode_seq, on `device`
    and, when that is a CUDA device, on the CPU too."""
    from ..core import decoder

    def via_tensors(dev):
        fmt, _, seq = decoder.parse_to_tensors(data, resync=True)
        return decoder.decode_seq(fmt, seq, device=dev)

    dev = torch.device(device)
    devices = [dev] + ([torch.device("cpu")] if dev.type == "cuda" else [])
    out = {}
    for d in devices:
        out[f"decode_stream {d.type}"] = planes_or_refusal(
            lambda: decoder.decode_stream(data, resync=True, device=d))
        out[f"parse_to_tensors + decode_seq {d.type}"] = planes_or_refusal(
            lambda: via_tensors(d))
    return out


def decode_difference(data: bytes, device: torch.device | str
                      ) -> Tuple[bool, Optional[str]]:
    """(c) and (d): every decode_paths result must be a refusal, or all
    must be equal planes.  Returns (refused, None when they agree, else
    the first diverging path, plane and index)."""
    (ref_name, ref), *rest = decode_paths(data, device).items()
    refused = isinstance(ref, ValueError)
    for path, planes in rest:
        if refused or isinstance(planes, ValueError):
            if not (refused and isinstance(planes, ValueError)):
                return refused, (f"{ref_name} gave {ref!r:.200}, {path} "
                                 f"{planes!r:.200}")
            continue
        for plane, a, b in zip(("y", "cb", "cr"), ref, planes):
            if a.shape != b.shape:
                return refused, (f"{plane} shape {a.shape} ({ref_name}) != "
                                 f"{b.shape} ({path})")
            bad = np.argwhere(a != b)
            if bad.size:
                at = tuple(int(i) for i in bad[0])
                return refused, (f"{plane} first differs at {at}: "
                                 f"{ref_name} {a[at]}, {path} {b[at]}")
    return refused, None


class Disagreement(Exception):
    """A corrupted stream on which two paths disagree: its index (from 0),
    corruption mode, bytes and what differed."""

    def __init__(self, index: int, mode: int, data: bytes,
                 message: str) -> None:
        super().__init__(f"stream {index} (mode {mode}): {message}")
        self.index, self.mode, self.data, self.message = (index, mode, data,
                                                          message)


def run(device: torch.device | str, seed: int = 999,
        count: Optional[int] = None, budget: float = 300.0
        ) -> Dict[str, object]:
    """Corrupt the base streams from `seed` and hold every path to the
    others (a)-(d) on `device`: exactly `count` streams, or as many as
    `budget` seconds allow.  Raises Disagreement on the first that
    disagrees.  Returns the tallies: streams, decoded, refused,
    strict_accepted, modes (mode -> streams), seconds."""
    tally = dict(streams=0, decoded=0, refused=0, strict_accepted=0,
                 modes=collections.Counter())
    t0 = time.time()
    for index, (mode, d) in enumerate(corruptions(seed)):
        if count is not None and index >= count:
            break
        if count is None and time.time() - t0 >= budget:
            break
        accepted, diff = strict_difference(d)
        diff = field_difference(d) or diff
        refused = None
        if diff is None:
            refused, diff = decode_difference(d, device)
        if diff is not None:
            raise Disagreement(index, mode, d, diff)
        tally["streams"] += 1
        tally["refused" if refused else "decoded"] += 1
        tally["strict_accepted"] += accepted
        tally["modes"][mode] += 1
    tally["modes"] = dict(sorted(tally["modes"].items()))
    tally["seconds"] = time.time() - t0
    return tally


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="p64tpu_torch.tools.fuzz_differential",
        description="decode differential fuzz: parsers, decode paths and "
                    "the card against the CPU on corrupted streams")
    ap.add_argument("seconds", nargs="?", type=float, default=300.0,
                    help="time budget when --count is not given "
                         "(default 300)")
    ap.add_argument("--count", type=int, default=None,
                    help="check exactly this many corrupted streams")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to decode on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("fuzz_differential: no CUDA device is available; pass "
              "--device cpu to fuzz on the CPU", file=sys.stderr)
        return 2
    seed = int(os.environ.get("FUZZ_SEED", "999"))
    t0 = time.time()
    try:
        tally = run(device, seed, args.count, args.seconds)
    except Disagreement as e:
        with open(FAIL_FILE, "wb") as f:
            f.write(e.data)
        print(f"DISAGREEMENT after {e.index} streams: {e.message} (input "
              f"saved to {FAIL_FILE}, mode {e.mode})")
        return 1
    print(f"  {args.device}: {tally['decoded']} decoded, {tally['refused']} "
          f"refused, {tally['strict_accepted']} accepted in strict mode, "
          f"modes {tally['modes']}", file=sys.stderr)
    print(f"differential fuzz: {tally['streams']} corrupted streams, 0 "
          f"disagreements, {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
