"""The port's Python parser (the oracle of its native parse) against the
JAX package's parser, strict and resync: equal frames, equal damage flags
and equal error messages on clean, bit-flipped, truncated and mixed-format
streams; the port's native engine agrees with both."""

import numpy as np
import pytest

from helpers import random_frame_symbols
from p64tpu.entropy import encode as jenc
from p64tpu.entropy import parse as jparse
from p64tpu.spec.constants import CIF, QCIF
from p64tpu_torch.entropy import parse as tparse
from p64tpu_torch.spec.constants import FORMATS as TFORMATS
from p64tpu_torch.native import binding

FIELDS = ("gquant", "coded", "intra", "mc", "fil", "quant", "mv", "cbp",
          "levels", "gob_damaged")


def _stream(fmt=QCIF, seed=5, t=4, **kw):
    rng = np.random.default_rng(seed)
    frames = [random_frame_symbols(fmt, rng, tr=k, **kw) for k in range(t)]
    return jenc.serialize_sequence_py(fmt, frames)[0]


def _outcome(parse, data):
    """("ok", frames) or ("err", message) of one parse."""
    try:
        return "ok", parse(data)
    except jparse.StreamError as e:       # the JAX parser's error type
        return "err", str(e)
    except tparse.StreamError as e:       # the port's
        return "err", str(e)


def _assert_same(got, want, what=""):
    assert got[0] == want[0], (what, got, want)
    if got[0] == "err":
        assert got[1] == want[1], what
        return
    assert len(got[1]) == len(want[1]), what
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        # the port's frames carry the port's own format constants
        assert a.fmt is TFORMATS[b.fmt.name] and a.tr == b.tr, (what, i)
        assert bool(a.damaged) == bool(b.damaged), (what, i)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{what} frame {i}: {f}")


def _check_all(data, what=""):
    """Strict and resync: port Python == JAX Python; resync: the port's
    native engine agrees too, and resync never raises."""
    native = binding.load()
    for strict in (True, False):
        want = _outcome(lambda d: jparse.parse_stream(d, strict=strict), data)
        got = _outcome(lambda d: tparse.parse_stream(d, strict=strict), data)
        _assert_same(got, want, f"{what} strict={strict}")
        if not strict:
            assert got[0] == "ok", what
            _assert_same(_outcome(lambda d: native.parse(d, resync=True),
                                  data), want, f"{what} native resync")
    return got[1]


@pytest.mark.parametrize("fmt,seed,kw",
                         [(QCIF, 5, {}), (QCIF, 11, {"p_mquant": 0.2}),
                          (CIF, 2, {"p_coded": 0.3}),
                          (CIF, 9, {"p_mquant": 0.3, "p_coded": 0.3})],
                         ids=["qcif", "qcif_mquant", "cif", "cif_mquant"])
def test_clean_streams(fmt, seed, kw):
    data = _stream(fmt, seed, t=3, **kw)
    frames = _check_all(data)
    assert len(frames) == 3 and not any(f.damaged for f in frames)
    _assert_same(_outcome(tparse.parse_stream, data),
                 _outcome(jparse.parse_stream, data))


@pytest.mark.parametrize("seed", range(6))
def test_bitflips(seed):
    """The bit-flip corpus of the JAX package's resync tests."""
    rng = np.random.default_rng(seed)
    data = _stream(seed=11, t=3, p_mquant=0.2)
    for trial in range(12):
        bad = bytearray(data)
        for _ in range(1 + trial % 5):
            p = int(rng.integers(0, len(bad)))
            bad[p] ^= 1 << int(rng.integers(0, 8))
        for f in _check_all(bytes(bad), f"seed {seed} trial {trial}"):
            assert np.abs(f.mv).max(initial=0) <= 15
            assert (f.quant[f.coded] >= 1).all()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8])
def test_truncated_heads(n):
    rng = np.random.default_rng(77)
    frames = [random_frame_symbols(QCIF, rng, tr=t) for t in range(2)]
    data = jenc.serialize_sequence_py(QCIF, frames)[0]
    _check_all(data[:n], f"head {n}")


def test_truncated_mid_stream_and_every_cut():
    rng = np.random.default_rng(77)
    frames = [random_frame_symbols(QCIF, rng, tr=t) for t in range(2)]
    data = jenc.serialize_sequence_py(QCIF, frames)[0]
    for cut in (len(data) // 3, len(data) // 2, len(data) - 2):
        _check_all(data[:cut], f"cut {cut}")
    # every fifth byte cut of a sparse MQUANT stream: strict outcomes
    # and messages equal
    rng = np.random.default_rng(123)
    frames = [random_frame_symbols(QCIF, rng, tr=t, p_coded=0.15,
                                   p_mquant=0.3) for t in range(2)]
    data = jenc.serialize_sequence_py(QCIF, frames)[0]
    for cut in range(0, len(data) + 1, 5):
        _assert_same(_outcome(tparse.parse_stream, data[:cut]),
                     _outcome(jparse.parse_stream, data[:cut]), f"cut {cut}")


def test_damaged_gob_and_garbage_join():
    data = _stream()
    # GQUANT of frame 1's first GOB zeroed: that GOB is flagged
    r = jparse.BitReader(data)
    codes = []
    while tparse._scan_start_code(r):
        pos = r.pos
        r.skip(16)
        codes.append((pos, r.read(4)))
    pscs = [i for i, (_, gn) in enumerate(codes) if gn == 0]
    pos, _ = codes[pscs[1] + 1]
    bad = bytearray(data)
    for bit in range(pos + 20, pos + 25):
        bad[bit // 8] &= ~(0x80 >> (bit % 8))
    frames = _check_all(bytes(bad), "gquant 0")
    assert [f.damaged for f in frames] == [False, True, False, False]
    _check_all(b"\xaa\x55\xfe" * 40 + data, "garbage join")
    for junk in (b"\xff\x55" * 200, b"\x00" * 64):
        assert _check_all(junk, "junk") == []


def test_qcif_sequence_then_cif_sequence():
    qcif = _stream(seed=5, t=2)
    rng = np.random.default_rng(31)
    cif = jenc.serialize_sequence_py(
        CIF, [random_frame_symbols(CIF, rng, tr=t, p_coded=0.1)
              for t in range(2)])[0]
    frames = _check_all(qcif + cif, "qcif+cif")
    assert [f.fmt.name for f in frames] == ["QCIF", "QCIF", "CIF", "CIF"]


def test_stream_error_is_a_value_error():
    assert issubclass(tparse.StreamError, ValueError)
    with pytest.raises(tparse.StreamError,
                       match="stream does not start with PSC"):
        tparse.parse_stream(b"\xff\xff\xff\xff")
