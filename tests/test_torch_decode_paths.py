"""The port's two decode paths agree on damaged streams: decode_stream
(ParsedFrame -> frames_to_tensors -> split_levels) and parse_to_tensors
(the engine's int8 levels + uint8 DC sidecar) + decode_seq.

The JAX package's split_levels sends a NEGATIVE slot-0 level of an MB
whose intra flag is set into the uint8 DC sidecar, where it wraps (-64
becomes +192).  A resync re-parse makes such an MB: a duplicate GN re-parses
an intra MB as inter, writes an inter coefficient into slot 0 and is cut
before the MB completes, so its intra and coded flags stay.  The port keeps
the engine path's level; it is held to JAX parse_to_tensors + decode_seq,
not to JAX decode_stream, on such input."""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import random_frame_symbols
from p64tpu.core import decoder as jdec
from p64tpu.entropy import encode as jenc
from p64tpu.spec.constants import QCIF as JQCIF
from p64tpu_torch.core import decoder as tdec
from p64tpu_torch.entropy import encode as tenc
from p64tpu_torch.entropy import parse as tparse
from p64tpu_torch.entropy.bitio import BitReader, BitWriter
from p64tpu_torch.spec.constants import QCIF
from p64tpu_torch.spec.tables import MTYPE_BY_NAME

torch.set_num_threads(1)


def _one_mb_stream(intra: bool, level: int) -> bytes:
    """A QCIF picture whose only coded MB is MB 0: intra with DC `level`
    in all six blocks, or inter with `level` as block 0's first
    coefficient."""
    n = QCIF.num_mbs
    levels = np.zeros((n, 6, 64), np.int16)
    if intra:
        levels[0, :, 0] = level
        mtype, cbp = MTYPE_BY_NAME["intra"], 63
    else:
        levels[0, 0, 0] = level
        mtype, cbp = MTYPE_BY_NAME["inter"], 32
    f = tenc.FrameSymbols(
        tr=0, gquant=np.full(3, 8, np.int32),
        coded=np.eye(1, n, 0, dtype=bool)[0],
        mtype=np.full(n, mtype, np.int32), mv=np.zeros((n, 2), np.int32),
        cbp=np.full(n, cbp, np.int32), levels=levels)
    return tenc.serialize_sequence_py(QCIF, [f])[0]


def _bit_splice(parts) -> bytes:
    """Concatenate (data, start_bit, end_bit) ranges at the bit level."""
    w = BitWriter()
    for data, start, end in parts:
        bits = np.unpackbits(np.frombuffer(data, np.uint8))[start:end]
        s = "".join("1" if b else "0" for b in bits)
        for i in range(0, len(s), 32):
            w.put_str(s[i:i + 32])
    return w.getvalue()


def _first_gob_start(data: bytes) -> int:
    r = BitReader(data)
    while tparse._scan_start_code(r):
        pos = r.pos
        r.skip(16)
        if r.read(4) != 0:
            return pos
    raise AssertionError("no GOB start code")


@pytest.fixture(scope="module")
def negative_slot0_stream():
    return negative_slot0_data()


def negative_slot0_data() -> bytes:
    """An intra MB (DC 200) re-parsed by a duplicate GOB as inter with
    slot-0 level -64, cut inside that block: slot 0 ends at -64 with the
    intra and coded flags kept."""
    intra = _one_mb_stream(True, 200)
    inter = _one_mb_stream(False, -64)
    start = _first_gob_start(inter)
    for end in range(start + 26, len(inter) * 8):
        data = _bit_splice([(intra, 0, len(intra) * 8), (inter, start, end)])
        frames = tparse.parse_stream(data, strict=False)
        if (len(frames) == 1 and frames[0].levels[0, 0, 0] == -64
                and frames[0].intra[0] and frames[0].coded[0]):
            return data
    raise AssertionError("no cut point leaves slot 0 at -64 with the intra "
                         "flag set")


def test_negative_slot0_decodes_equally_on_both_paths(
        negative_slot0_stream):
    data = negative_slot0_stream
    # the fixture really holds the level, in the engine's parse too
    (frame,) = tdec.parse_any(data, resync=True)
    assert frame.levels[0, 0, 0] == -64 and frame.intra[0] and frame.coded[0]
    assert frame.damaged
    fmt, _, seq = tdec.parse_to_tensors(data, resync=True)
    assert seq["levels8"][0, 0, 0, 0] == -64 and seq["dc"][0, 0, 0] == 0
    assert seq["intra"][0, 0]
    # the port's host split keeps it; the reference's wraps it to +192
    levels = frame.levels[None]
    intra = (frame.intra & frame.coded)[None]
    l8, dc = tdec.split_levels(levels, intra)
    assert (l8[0, 0, 0, 0], dc[0, 0, 0]) == (-64, 0)
    assert jdec.split_levels(levels, intra)[1][0, 0, 0] == 192

    y, cb, cr, _ = tdec.decode_stream(data, resync=True, device="cpu")
    via_tensors = tdec.decode_seq(fmt, seq, device="cpu")
    jfmt, _, jseq = jdec.parse_to_tensors(data, resync=True)
    want = jdec.decode_seq(jfmt, jseq)
    for got in ((y, cb, cr), via_tensors):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError:                 # StreamError is a ValueError
        return "err", None


@pytest.mark.parametrize("seed", range(6))
def test_decode_paths_agree_on_bitflips(seed):
    """Path-level fuzz slice: bit-flipped resync streams decode to the
    same planes through decode_stream and parse_to_tensors + decode_seq
    (or are refused by both)."""
    rng = np.random.default_rng(100 + seed)
    frames = [random_frame_symbols(JQCIF, rng, tr=k, p_mquant=0.2)
              for k in range(3)]
    ours = [tenc.FrameSymbols(**{f.name: getattr(s, f.name) for f in
                                 dataclasses.fields(tenc.FrameSymbols)})
            for s in frames]
    data = tenc.serialize_sequence(QCIF, ours)[0]
    assert data == jenc.serialize_sequence_py(JQCIF, frames)[0]
    n_ok = 0
    for trial in range(8):
        bad = bytearray(data)
        for _ in range(1 + trial % 4):
            p = int(rng.integers(0, len(bad)))
            bad[p] ^= 1 << int(rng.integers(0, 8))
        bad = bytes(bad)
        a = _outcome(lambda: tdec.decode_stream(bad, resync=True,
                                                device="cpu")[:3])

        def via_tensors():
            fmt, _, seq = tdec.parse_to_tensors(bad, resync=True)
            return tdec.decode_seq(fmt, seq, device="cpu")
        b = _outcome(via_tensors)
        assert a[0] == b[0], (seed, trial)
        if a[0] == "ok":
            n_ok += 1
            for x, y in zip(a[1], b[1]):
                np.testing.assert_array_equal(x, y,
                                              err_msg=f"{seed}/{trial}")
    assert n_ok > 0
