"""The port's binding of the C++ bit-I/O engine against the JAX package's
binding of the same engine and against both packages' Python oracles:
byte-exact packing and serialization, field-exact parsing (strict and
resync), equal error messages; and its build rules (into build/native/,
never p64tpu/, raising without g++)."""

import dataclasses
import os

import numpy as np
import pytest

from helpers import random_frame_symbols
from p64tpu.core import decoder as jdec
from p64tpu.entropy import encode as jenc
from p64tpu.entropy import parse as jparse
from p64tpu.entropy.bitio import pack_symbols
from p64tpu.native import load as jload
from p64tpu.spec.constants import CIF, FORMATS, QCIF
from p64tpu_torch.entropy import encode as tenc
from p64tpu_torch.entropy import parse as tparse
from p64tpu_torch.kernels import _build
from p64tpu_torch.native import binding
from p64tpu_torch.native.binding import PACKED_KEYS
from p64tpu_torch.spec import luts
from p64tpu_torch.spec.constants import FORMATS as TFORMATS
from p64tpu_torch.spec.constants import QCIF as TQCIF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("gquant", "coded", "intra", "mc", "fil", "quant", "mv", "cbp",
          "levels", "gob_damaged")


def _port_symbols(frames):
    """JAX FrameSymbols -> the port's, field by field."""
    names = [f.name for f in dataclasses.fields(tenc.FrameSymbols)]
    return [tenc.FrameSymbols(**{n: getattr(f, n) for n in names})
            for f in frames]


def _stream(fmt, seed, t=3, p_mquant=0.0, n_stuff=(), **kw):
    rng = np.random.default_rng(seed)
    frames = [random_frame_symbols(fmt, rng, tr=k, p_mquant=p_mquant, **kw)
              for k in range(t)]
    for f, n in zip(frames, n_stuff):
        f.n_stuff = n
    return frames


def _assert_same_frames(got, want, formats=TFORMATS):
    """got's frames equal want's (the JAX package's) field for field;
    got's formats are the constants of `formats` (the port's by
    default)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.fmt is formats[b.fmt.name] and a.tr == b.tr, i
        assert bool(a.damaged) == bool(b.damaged), i
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"frame {i}: {f}")


@pytest.fixture(scope="module")
def native():
    return binding.load()


@pytest.fixture(scope="module")
def jnative():
    lib = jload()
    assert lib is not None, "the JAX package's native engine did not build"
    return lib


def test_pack_symbols_matches(native, jnative):
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 65, 3000)
    codes = np.array([rng.integers(0, 1 << int(n)) if n < 64
                      else rng.integers(0, 1 << 63) for n in lens],
                     np.uint64)
    want = pack_symbols(codes, lens)
    assert native.pack_symbols(codes, lens) == want
    assert jnative.pack_symbols(codes, lens) == want
    with pytest.raises(ValueError, match="0..64"):
        native.pack_symbols(codes[:2], np.array([3, 65]))


@pytest.mark.parametrize("fmt,seed,p_mquant,n_stuff",
                         [(QCIF, 0, 0.0, ()), (QCIF, 8, 0.3, ()),
                          (CIF, 6, 0.0, ()), (CIF, 9, 0.2, ()),
                          (QCIF, 21, 0.0, (0, 5, 117)),
                          (CIF, 22, 0.3, (1, 0, 44))],
                         ids=["qcif", "qcif_mquant", "cif", "cif_mquant",
                              "qcif_stuffing", "cif_mquant_stuffing"])
def test_serialize_matches_jax_and_python(native, jnative, fmt, seed,
                                          p_mquant, n_stuff):
    frames = _stream(fmt, seed, p_mquant=p_mquant, n_stuff=n_stuff)
    want = jenc.serialize_sequence_py(fmt, frames)
    assert jnative.serialize(fmt, frames) == want
    ours, tfmt = _port_symbols(frames), TFORMATS[fmt.name]
    assert native.serialize(tfmt, ours) == want
    assert tenc.serialize_sequence(tfmt, ours) == want
    assert tenc.serialize_sequence_py(tfmt, ours) == want


def test_serialize_empty_and_guards(native):
    assert native.serialize(TQCIF, []) == (b"", 0)
    assert tenc.serialize_sequence(TQCIF, []) == (b"", 0)
    base = _port_symbols(_stream(QCIF, 4, t=1, p_mquant=0.5))[0]
    coded_cbp = np.flatnonzero(base.coded & luts.MTYPE_CBP[base.mtype])
    bad = dataclasses.replace(base, cbp=base.cbp.copy())
    bad.cbp[coded_cbp[0]] = 0
    with pytest.raises(ValueError, match="CBP out of range"):
        native.serialize(TQCIF, [bad])
    mq = np.flatnonzero(base.coded & luts.MTYPE_MQUANT[base.mtype])
    bad = dataclasses.replace(base, quant_mb=base.quant_mb.copy())
    bad.quant_mb[mq[0]] = 0
    with pytest.raises(ValueError, match="MQUANT"):
        native.serialize(TQCIF, [bad])
    bad = dataclasses.replace(base, gquant=np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="GQUANT"):
        native.serialize(TQCIF, [bad])


@pytest.mark.parametrize("fmt,seed,p_mquant,n_stuff",
                         [(QCIF, 1, 0.0, ()), (CIF, 2, 0.0, ()),
                          (QCIF, 10, 0.3, (3, 0, 47)),
                          (CIF, 12, 0.2, (0, 1001, 0))],
                         ids=["qcif", "cif", "qcif_mquant_stuffing",
                              "cif_mquant_stuffing"])
def test_parse_matches_jax_and_python(native, jnative, fmt, seed, p_mquant,
                                      n_stuff):
    data, _ = jenc.serialize_sequence_py(
        fmt, _stream(fmt, seed, p_mquant=p_mquant, n_stuff=n_stuff))
    want = jparse.parse_stream(data)
    _assert_same_frames(jnative.parse(data), want, FORMATS)
    _assert_same_frames(native.parse(data), want)
    _assert_same_frames(native.parse(data, copy=True), want)
    _assert_same_frames(native.parse(data, resync=True), want)
    _assert_same_frames(tparse.parse_stream(data), want)

    got_fmt, got_tr, got = native.parse_tensors(data)
    want_fmt, want_tr, want_seq = jnative.parse_tensors(data)
    assert got_fmt is TFORMATS[fmt.name] and want_fmt is fmt
    np.testing.assert_array_equal(got_tr, want_tr)
    # the port's dict adds the packed levels (tests/test_torch_levels.py)
    # and each frame's damage word, all zero in a clean stream
    assert set(got) == set(want_seq) | set(PACKED_KEYS) | {"damage"}
    assert not got["damage"].any()
    for k in want_seq:
        assert got[k].dtype == want_seq[k].dtype, k
        np.testing.assert_array_equal(got[k], want_seq[k], err_msg=k)


def test_parse_copy_gives_independent_frames(native):
    data, _ = jenc.serialize_sequence_py(QCIF, _stream(QCIF, 21))
    for a, b in zip(native.parse(data), native.parse(data, copy=True)):
        for field in ("gquant", "quant", "mv", "cbp", "levels"):
            va, vb = getattr(a, field), getattr(b, field)
            np.testing.assert_array_equal(va, vb)
            assert va.base is not None      # view path: borrows buffers
            assert vb.base is None          # copy path: owns its data


@pytest.mark.parametrize("data", [b"\xff\xff\xff\xff", b"\x00\x01\x00",
                                  b"\x00\x01\x0a", b""],
                         ids=["garbage", "bare_psc", "psc_tr", "empty"])
def test_parse_errors_equal_jax(native, jnative, data):
    with pytest.raises(jparse.StreamError) as want:
        jnative.parse(data)
    with pytest.raises(tparse.StreamError) as got:
        native.parse(data)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
    # resync never raises; none of these holds a complete picture header
    assert native.parse(data, resync=True) == []


def test_parse_tensors_errors(native, jnative):
    for data in (b"", b"\x00" * 64):
        with pytest.raises(tparse.StreamError, match="empty stream"):
            native.parse_tensors(data, resync=True)
    q, _ = jenc.serialize_sequence_py(QCIF, _stream(QCIF, 5, t=2))
    c, _ = jenc.serialize_sequence_py(CIF, _stream(CIF, 6, t=1,
                                                   p_coded=0.1))
    with pytest.raises(tparse.StreamError) as got:
        native.parse_tensors(q + c, resync=True)
    with pytest.raises(jparse.StreamError) as want:
        jnative.parse_tensors(q + c, resync=True)
    assert str(got.value) == str(want.value) == (
        "mixed picture formats in one sequence")


def test_parse_adaptive_buffer_growth(native, jnative):
    frames = [random_frame_symbols(QCIF, np.random.default_rng(51 + t),
                                   tr=t % 32, p_coded=0.1)
              for t in range(70)]
    data, _ = jenc.serialize_sequence_py(QCIF, frames)
    _assert_same_frames(native.parse(data), jparse.parse_stream(data))
    fmt, tr, seq = native.parse_tensors(data)
    assert fmt is TQCIF and seq["levels8"].shape[0] == 70
    np.testing.assert_array_equal(seq["levels8"],
                                  jnative.parse_tensors(data)[2]["levels8"])
    with pytest.raises(tparse.StreamError) as got:
        native.parse_tensors(data, max_frames=8)
    with pytest.raises(jparse.StreamError) as want:
        jnative.parse_tensors(data, max_frames=8)
    assert str(got.value) == str(want.value)


def test_parse_many_and_decoder_parsers_use_the_engine(native):
    from p64tpu_torch.core import decoder as tdec

    datas = [jenc.serialize_sequence_py(QCIF, _stream(QCIF, 31 + i, t=2))[0]
             for i in range(5)]
    for d, got in zip(datas, tdec.parse_many(datas)):
        _assert_same_frames(got, jparse.parse_stream(d))
    fmt, tr, seq = tdec.parse_to_tensors(datas[0])
    want = jdec.frames_to_tensors(jparse.parse_stream(datas[0]))
    for k in want:
        np.testing.assert_array_equal(seq[k], np.asarray(want[k]),
                                      err_msg=k)


def test_engine_is_built_into_build_native(native):
    path = native._lib._name
    assert os.path.realpath(path) == os.path.realpath(
        os.path.join(REPO, "build", "native", "libp64bitio.so"))
    assert os.path.getmtime(path) >= os.path.getmtime(_build.NATIVE_SOURCE)
    line = " ".join(_build.cxx_command("g++", "src.cpp", "out.so"))
    assert line == "g++ -O3 -Wall -Wextra -fPIC -std=c++17 -shared " \
                   "-o out.so src.cpp"


def test_load_raises_without_gxx(monkeypatch, tmp_path):
    native_dir = os.path.join(REPO, "p64tpu", "native")
    before = sorted(os.listdir(native_dir))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(_build, "NATIVE_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(binding, "_cached", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.find_cxx()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        binding.load()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        binding.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tenc.serialize_sequence(TQCIF, [])
    assert binding._cached is None
    assert not (tmp_path / "build").exists()
    assert sorted(os.listdir(native_dir)) == before


def test_failed_compile_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE_SOURCE", str(bad))
    monkeypatch.setattr(_build, "NATIVE_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed on .*bad.cpp"):
        _build.build_native()
    assert os.listdir(tmp_path / "build") == []


def test_python_oracles_are_off_every_path():
    """Only the tests, chip_smoke.py's oracle check and the two fuzz tools,
    which hold the engine to the Python parser, call the Python parser and
    serializer; every other port module parses and serializes through the
    engine."""
    import ast

    oracles = {"parse_stream", "serialize_sequence_py"}
    fuzz_tools = {os.path.join("p64tpu_torch", "tools", f"{n}.py")
                  for n in ("fuzz_encoder", "fuzz_differential")}
    pkg = os.path.join(REPO, "p64tpu_torch")
    callers = []
    for root, _, names in os.walk(pkg):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(root, n)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call):
                    fn = node.func
                    name = getattr(fn, "id", None) or getattr(fn, "attr", "")
                    if name in oracles:
                        callers.append(os.path.relpath(path, REPO))
    assert set(callers) == fuzz_tools, callers
