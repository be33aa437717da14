"""The JAX package's crafted regression streams, through the port.

Counterparts of the round-5 fuzz findings in test_resync.py (a partial
intra DC above 127 on both decode paths, a QCIF + CIF join with PTYPE
flips, a re-parsed block whose last writer wins, GQUANT recorded before a
truncated GEI) and of the foreign streams in test_foreign_stream.py
(MQUANT mid-GOB, a trailing short MC macroblock, an MV outside the picture).
Each stream is built with the port's own bit writer, serializer or encoder
and is byte-equal to the one the JAX test builds.  `_hold` then parses it
with the port's Python parser and engine, strict and resync, and decodes it
through decode_stream and parse_to_tensors + decode_seq: the fields, the
strict outcome and the planes, or the refusal, must equal the JAX package's
(its planes from parse_to_tensors + decode_seq, whose split of slot 0 the
port's decode_stream matches; see test_torch_decode_paths.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_foreign_stream as jforeign
import test_resync as jresync
from helpers import random_frame_symbols as jax_frame_symbols
from p64tpu.core import decoder as jdec
from p64tpu.core import encoder as jencoder
from p64tpu.entropy import bitio as jbitio
from p64tpu.entropy import encode as jencode
from p64tpu.entropy import parse as jparse
from p64tpu.spec import constants as jconst
from p64tpu.spec.tables import MTYPE_BY_NAME as JMTYPE
from p64tpu_torch.core import decoder as tdec
from p64tpu_torch.core import encoder as tencoder
from p64tpu_torch.entropy import encode as tencode
from p64tpu_torch.entropy import parse as tparse
from p64tpu_torch.entropy.bitio import BitReader, BitWriter
from p64tpu_torch.native import load
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.spec.tables import MTYPE_BY_NAME
from p64tpu_torch.tools.fuzz_differential import (FIELDS, planes_or_refusal,
                                                  random_frame_symbols)

torch.set_num_threads(1)


def _parses(data, resync):
    """Port Python parser, port engine and JAX Python parser on `data`:
    each a list of pictures or the StreamError it raised."""
    def run(fn):
        try:
            return fn()
        except (tparse.StreamError, jparse.StreamError) as e:
            return e
    return (run(lambda: tparse.parse_stream(data, strict=not resync)),
            run(lambda: load().parse(data, resync=resync)),
            run(lambda: jparse.parse_stream(data, strict=not resync)))


def _decodes(data, resync):
    """Planes or refusal of port decode_stream, port parse_to_tensors +
    decode_seq, and JAX parse_to_tensors + decode_seq."""
    def via_tensors():
        fmt, _, seq = tdec.parse_to_tensors(data, resync=resync)
        return tdec.decode_seq(fmt, seq, device="cpu")

    def jax_tensors():
        fmt, _, seq = jdec.parse_to_tensors(data, resync=resync)
        return jdec.decode_seq(fmt, seq)
    return (planes_or_refusal(lambda: tdec.decode_stream(
                data, resync=resync, device="cpu")),
            planes_or_refusal(via_tensors),
            planes_or_refusal(jax_tensors))


def _hold(data):
    """Strict and resync: the port's two parsers give the JAX parser's
    pictures (format, TR, damage, every field) or all refuse; the port's
    two decode paths give JAX's planes or all refuse.  Returns the port's
    resync pictures and whether the strict decode refused."""
    for resync in (False, True):
        what = "resync" if resync else "strict"
        py, eng, ref = _parses(data, resync)
        refused = [isinstance(p, ValueError) for p in (py, eng, ref)]
        assert len(set(refused)) == 1, (what, py, eng, ref)
        if not refused[0]:
            assert len(py) == len(eng) == len(ref), what
            for i, (a, b, c) in enumerate(zip(py, eng, ref)):
                assert (a.fmt.name, a.tr, a.damaged) == \
                    (b.fmt.name, b.tr, b.damaged) == \
                    (c.fmt.name, c.tr, c.damaged), (what, i)
                for f in FIELDS:
                    for got in (a, b):
                        np.testing.assert_array_equal(
                            getattr(got, f), getattr(c, f),
                            err_msg=f"{what} picture {i} {f}")
        planes = _decodes(data, resync)
        kinds = [isinstance(p, ValueError) for p in planes]
        assert len(set(kinds)) == 1, (what, planes)
        if not kinds[0]:
            for got in planes[:2]:
                for name, a, b in zip(("y", "cb", "cr"), got, planes[2]):
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"{what} {name}")
        if not resync:
            strict_refused = kinds[0]
    return py, strict_refused


def _port_stream(fmt, seed, t, **kw):
    """test_resync._stream with the port's generator and serializer."""
    rng = np.random.default_rng(seed)
    frames = [random_frame_symbols(fmt, rng, tr=k, **kw) for k in range(t)]
    return tencode.serialize_sequence(fmt, frames)[0]


def _start_codes(data):
    """(bit_pos, gn) of every start code in a clean stream."""
    r = BitReader(data)
    out = []
    while tparse._scan_start_code(r):
        pos = r.pos
        r.skip(16)
        out.append((pos, r.read(4)))
    return out


def _bit_splice(parts):
    """Concatenate (data, start_bit, end_bit) ranges at the bit level."""
    w = BitWriter()
    for data, start, end in parts:
        bits = np.unpackbits(np.frombuffer(data, np.uint8))[start:end]
        s = "".join("1" if b else "0" for b in bits)
        for i in range(0, len(s), 32):
            w.put_str(s[i:i + 32])
    return w.getvalue()


def test_partial_intra_dc_survives_both_decode_paths():
    """test_resync.py: bright intra-only QCIF with one bit flipped until a
    resync parse keeps a DC of 128..254 in slot 0 of an MB with coded
    unset; every trial's stream is the JAX encoder's."""
    rng = np.random.default_rng(2)
    cfg = tencoder.EncoderConfig(fmt=QCIF, search=0, intra_only=True)
    jcfg = jencoder.EncoderConfig(fmt=jconst.QCIF, search=0, intra_only=True)
    found = None
    for trial in range(400):
        y = rng.integers(150, 256, (2, 144, 176), np.uint8)
        frames = dict(y=y, cb=y[:, ::2, ::2], cr=y[:, 1::2, ::2])
        data = tencoder.encode_to_bytes(
            cfg, {k: np.ascontiguousarray(v)[None] for k, v in
                  frames.items()}, device="cpu")[0][0]
        want = jencoder.encode_to_bytes(
            jcfg, {k: jnp.asarray(v) for k, v in frames.items()})[0]
        assert data == want, trial
        bad = bytearray(data)
        p = int(rng.integers(40, len(bad)))
        bad[p] ^= 1 << int(rng.integers(0, 8))
        for f in tparse.parse_stream(bytes(bad), strict=False):
            partial = ~(f.intra & f.coded)
            if (partial[:, None] & (f.levels[..., 0] > 127)).any():
                found = bytes(bad)
        if found:
            break
    assert found is not None, "no trial produced a partial DC > 127"
    _hold(found)


def test_mixed_format_join_and_ptype_flips():
    """test_resync.py: QCIF (seed 5) + sparse CIF (seed 31) joined, then
    the PTYPE format bit of each QCIF picture flipped."""
    qcif = _port_stream(QCIF, 5, 2)
    assert qcif == jresync._stream(seed=5, t=2)
    rng, jrng = np.random.default_rng(31), np.random.default_rng(31)
    cif = tencode.serialize_sequence(CIF, [
        random_frame_symbols(CIF, rng, tr=t, p_coded=0.1)
        for t in range(2)])[0]
    assert cif == jencode.serialize_sequence(jconst.CIF, [
        jax_frame_symbols(jconst.CIF, jrng, tr=t, p_coded=0.1)
        for t in range(2)])[0]
    frames, strict_refused = _hold(qcif + cif)
    assert [f.fmt.name for f in frames] == ["QCIF", "QCIF", "CIF", "CIF"]
    assert strict_refused         # two formats in one sequence
    flips = 0
    for pos, gn in _start_codes(qcif):
        if gn != 0:
            continue
        bad = bytearray(qcif)
        bit = pos + 20 + 5 + 3
        bad[bit // 8] ^= 0x80 >> (bit % 8)
        _hold(bytes(bad))
        flips += 1
    assert flips == 2


def _one_mb_frame(symbols, mtypes, intra, level):
    """test_resync.py's one-MB QCIF picture in either package: MB 0 intra
    with DC `level` in all six blocks, or inter with `level` as block 0's
    first coefficient."""
    n = QCIF.num_mbs
    levels = np.zeros((n, 6, 64), np.int16)
    if intra:
        levels[0, :, 0] = level
        mtype, cbp = 0, 63
    else:
        levels[0, 0, 0] = level
        mtype, cbp = mtypes["inter"], 32
    return symbols(tr=0, gquant=np.full(3, 8, np.int32),
                   coded=np.eye(1, n, 0, dtype=bool)[0],
                   mtype=np.full(n, mtype, np.int32),
                   mv=np.zeros((n, 2), np.int32),
                   cbp=np.full(n, cbp, np.int32), levels=levels)


@pytest.mark.parametrize("order", ["intra_then_inter", "inter_then_intra"])
def test_reparsed_block_last_writer_wins(order):
    """test_resync.py: a whole one-MB stream, then another's GOB section
    (a duplicate GN re-parses MB 0); slot 0 holds the last writer's
    value."""
    streams = {}
    for intra, level in ((True, 200), (False, 52)):
        data = tencode.serialize_sequence(
            QCIF, [_one_mb_frame(tencode.FrameSymbols, MTYPE_BY_NAME, intra,
                                 level)])[0]
        assert data == jencode.serialize_sequence(
            jconst.QCIF, [_one_mb_frame(jencode.FrameSymbols, JMTYPE, intra,
                                        level)])[0]
        streams[intra] = data
    first, second, want = ((streams[True], streams[False], 52)
                           if order == "intra_then_inter"
                           else (streams[False], streams[True], 200))
    gob_start = next(p for p, gn in _start_codes(second) if gn != 0)
    parts = [(first, 0, len(first) * 8), (second, gob_start,
                                          len(second) * 8)]
    spliced = _bit_splice(parts)
    assert spliced == jresync._bit_splice(parts)
    frames, _ = _hold(spliced)
    assert len(frames) == 1 and int(frames[0].levels[0, 0, 0]) == want


def _truncated_gei_stream(writer):
    """PSC, TR, PTYPE (QCIF), 7 PEI spares, PEI 0, GBSC + GN 1, GQUANT 12:
    exactly 15 bytes, the GEI flag past the end."""
    w = writer()
    w.put_str("0000000000000001" + "0000")
    w.put_str("00000")
    w.put_str("001000")
    for _ in range(7):
        w.put_str("1" + "10100101")
    w.put_str("0")
    w.put_str("0000000000000001" + "0001")
    w.put_str("01100")
    return w.getvalue()


def test_gquant_recorded_before_truncated_gei():
    data = _truncated_gei_stream(BitWriter)
    assert data == _truncated_gei_stream(jbitio.BitWriter)
    assert len(data) == 15
    frames, strict_refused = _hold(data)
    assert strict_refused
    assert len(frames) == 1 and frames[0].damaged
    assert frames[0].gob_damaged[0] and int(frames[0].gquant[0]) == 12


def _mquant_midgob_stream():
    """test_foreign_stream.build_stream with the port's bit writer: an
    intra MB with MQUANT 6 after MBA stuffing, then an intra MB at the
    inherited quantizer."""
    w = BitWriter()
    w.put(0x00010, 20)
    w.put(3, 5)
    w.put(0b000011, 6)
    w.put(0, 1)
    for gn in (1, 3, 5):
        w.put(1, 16)
        w.put(gn, 4)
        w.put(20, 5)
        w.put(0, 1)
        if gn == 1:
            w.put_str("00000001111")       # MBA stuffing
            w.put_str("1")                 # MBA 1
            w.put_str("0000001")           # MTYPE intra + MQUANT
            w.put(6, 5)
            for b in range(6):
                w.put(100, 8)
                if b == 0:
                    w.put_str("11" + "0")  # (run 0, level +1)
                w.put_str("10")            # EOB
            w.put_str("1")                 # MBA 1
            w.put_str("0001")              # MTYPE intra
            for b in range(6):
                w.put(50, 8)
                w.put_str("10")
    return w.getvalue()


def test_mquant_midgob_decodes_as_jax():
    data = _mquant_midgob_stream()
    assert data == jforeign.build_stream()
    (f,), strict_refused = _hold(data)
    assert not strict_refused
    assert f.coded[:2].all() and not f.coded[2:].any()
    assert f.quant[0] == f.quant[1] == 6
    assert f.levels[0, 0, 0] == 100 and f.levels[0, 0, 1] == 1


def _tail_mb_stream():
    """test_foreign_stream._tail_mb_stream with the port's bit writer: GOB
    5 ends with an intra MB and a 6-bit MC macroblock."""
    w = BitWriter()
    w.put(0x00010, 20)
    w.put(0, 5)
    w.put(0b000011, 6)
    w.put(0, 1)
    for gn in (1, 3, 5):
        w.put(1, 16)
        w.put(gn, 4)
        w.put(10, 5)
        w.put(0, 1)
        if gn == 5:
            w.put_str("1")                 # MBA 1
            w.put_str("0001")              # MTYPE intra
            for _ in range(6):
                w.put(50, 8)
                w.put_str("10")
            w.put_str("1")                 # MBA 1: raster 67
            w.put_str("001")               # MTYPE inter + MC, no coefficients
            w.put_str("1")                 # MVD x 0
            w.put_str("1")                 # MVD y 0
    return w.getvalue()


def test_trailing_short_mc_mb_parsed():
    data = _tail_mb_stream()
    assert data == jforeign._tail_mb_stream()
    (f,), strict_refused = _hold(data)
    assert not strict_refused
    assert f.coded[66] and f.intra[66]
    assert f.coded[67] and f.mc[67] and not f.intra[67]
    assert tuple(f.mv[67]) == (0, 0) and f.cbp[67] == 0


def test_mv_outside_picture_rejected():
    """test_foreign_stream.py: MB 0 given MV (-15, -15) is refused in strict
    mode by both parsers, and by both decode paths."""
    def stream(generator, serialize, fmt, mtypes):
        f = generator(fmt, np.random.default_rng(88), tr=0, p_intra=0.0)
        f.coded[0] = True
        f.mtype[0] = mtypes["inter_mc"]
        f.mv[0] = (-15, -15)
        f.cbp[0] = 0
        f.levels[0] = 0
        return serialize(fmt, [f])[0]

    data = stream(random_frame_symbols, tencode.serialize_sequence, QCIF,
                  MTYPE_BY_NAME)
    assert data == stream(jax_frame_symbols, jencode.serialize_sequence,
                          jconst.QCIF, JMTYPE)
    for parse in (tparse.parse_stream, load().parse):
        with pytest.raises(tparse.StreamError, match="outside"):
            parse(data)
    _, strict_refused = _hold(data)
    assert strict_refused
