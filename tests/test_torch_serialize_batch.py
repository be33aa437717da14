"""The batch serializer (`csrc/serialize_batch.cpp`, bound by
`native.BatchSerializer`, run by `core.encoder.serialize_streams`) on the
CPU: every stream's (bytes, nbits) equals the per-stream native engine over
`outputs_to_symbols` and the Python oracle, on the thirteen pins, the
encoder-fuzz samples, random symbols with escapes, MQUANT and stuffing, and
crafted edges (an intra DC of 128, negative slot-0 inter levels, a stream
that skipped every frame); ranges of streams equal the whole chunk; the
symbol checks keep their messages; a bit count off the device model raises;
and no FrameSymbols is built on the way."""

import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from helpers import random_frame_symbols
from p64tpu.spec.constants import CIF as JCIF
from p64tpu.spec.constants import QCIF as JQCIF
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.entropy import encode as tenc
from p64tpu_torch.entropy.parse import parse_stream
from p64tpu_torch.kernels import _build
from p64tpu_torch.native import binding
from p64tpu_torch.spec import luts
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import fuzz_encoder, pinned
from p64tpu_torch.tools import golden_content as gc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: encoder-fuzz samples of seed 77 (the tool's seed) held to the oracles
FUZZ_SAMPLES = 40


def _oracles(cfg, outputs):
    """Per stream, (bytes, nbits) of the per-stream native engine over
    outputs_to_symbols, held to the Python oracle."""
    want = []
    for syms in enc.outputs_to_symbols(cfg, outputs):
        got = tenc.serialize_sequence(cfg.fmt, syms)
        assert tenc.serialize_sequence_py(cfg.fmt, syms) == got
        want.append(got)
    return want


def _assert_equals_oracles(cfg, outputs):
    got = enc.serialize_streams(cfg, outputs)
    assert got == _oracles(cfg, outputs)
    return got


def _numpy(outputs):
    return {k: outputs[k].numpy().copy() for k in enc.SYMBOL_KEYS}


def _with_oracle_bits(cfg, outputs):
    """outputs with each stream's total_bits summing to the oracle's count
    (for symbols edited after the encode)."""
    bits = [n for _, n in _oracles(cfg, outputs)]
    outputs["total_bits"][:] = 0
    outputs["total_bits"][:, 0] = bits
    return outputs


def _encode(cfg, frames):
    return enc.encode_sequence(cfg, frames, device="cpu")[1]


@pytest.fixture(scope="module")
def chunk():
    """Five QCIF streams x 5 frames at 384 kbit/s with three MQUANT
    segments: four skip some of their frames, the smooth one (stream 2)
    codes every frame and fills with MBA stuffing.  (cfg, host arrays)."""
    adv = gc.adversarial_sequences()
    seqs = [gc.config2_qcif_inter()] + [
        gc.luma_to_frames(adv[n]) for n in ("noise", "smooth", "periodic",
                                            "scenecut")]
    frames = {k: np.stack([s[k][:5] for s in seqs]) for k in ("y", "cb", "cr")}
    cfg = enc.EncoderConfig(fmt=QCIF, search=15, rate=RateConfig(
        bit_rate=384_000, mquant_segments=3))
    out = _numpy(_encode(cfg, frames))
    assert not out["frame_coded"].all()
    assert out["n_stuff"].any()
    assert luts.MTYPE_MQUANT[out["mtype"]][out["coded"]].any()
    return cfg, out


@pytest.mark.parametrize("name", pinned.ALL_PINS)
def test_pins_equal_the_per_stream_engine_and_the_oracle(name):
    cfg, frames = pinned.pinned_case(name)
    out = _encode(cfg, frames)
    ((data, nbits),) = _assert_equals_oracles(cfg, out)
    assert nbits == int(out["total_bits"].sum())


@pytest.fixture(scope="module")
def fuzz_samples():
    rng = np.random.default_rng(77)
    return [fuzz_encoder.sample(rng) for _ in range(FUZZ_SAMPLES)]


def test_fuzz_samples_cover_the_encoder_paths(fuzz_samples):
    rates = [s["rate"] for s in fuzz_samples]
    assert any(r["fixed_quant"] > 0 for r in rates)
    assert any(r["bit_rate"] > 0 and r["mquant_segments"] > 1
               for r in rates)
    assert any(r["bit_rate"] > 0 and r["min_rate_fill"] for r in rates)
    assert any(s["intra_period"] > 0 for s in fuzz_samples)
    assert any(s["intra_only"] for s in fuzz_samples)
    assert {s["fmt"] for s in fuzz_samples} == {"CIF", "QCIF"}


@pytest.mark.parametrize("index", range(FUZZ_SAMPLES))
def test_fuzz_sample_equals_the_per_stream_engine_and_the_oracle(
        index, fuzz_samples):
    s = fuzz_samples[index]
    cfg = fuzz_encoder.port_config(s)
    out = _encode(cfg, {k: v[None] for k, v in s["frames"].items()})
    ((data, nbits),) = _assert_equals_oracles(cfg, out)
    assert nbits == int(out["total_bits"].sum())


def test_rate_controlled_chunk_with_skips_mquant_and_stuffing(chunk):
    cfg, out = chunk
    got = _assert_equals_oracles(cfg, out)
    assert [n for _, n in got] == out["total_bits"].sum(axis=1).tolist()
    # the same chunk as CPU tensors
    tensors = {k: torch.from_numpy(v) for k, v in out.items()}
    assert enc.serialize_streams(cfg, tensors) == got


def test_strided_streams_equal_their_streams_of_the_whole(chunk):
    cfg, out = chunk
    whole = enc.serialize_streams(cfg, out)
    part = {k: v[::2] for k, v in out.items()}
    assert not part["levels8"].flags["C_CONTIGUOUS"]
    assert enc.serialize_streams(cfg, part) == whole[::2]


@pytest.mark.parametrize("cpus", [1, 2, 3, 64])
def test_fan_out_width_does_not_change_the_bytes(chunk, monkeypatch, cpus):
    cfg, out = chunk
    want = enc.serialize_streams(cfg, out)
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    assert enc.serialize_streams(cfg, out) == want


def test_ranges_that_split_a_chunk_equal_the_whole(chunk):
    cfg, out = chunk
    engine = binding.load_batch()
    whole = engine.prepare(cfg.fmt, out)
    want = engine.run(whole, 0, whole.streams)
    n = whole.streams
    for cut in range(n + 1):
        batch = engine.prepare(cfg.fmt, out)
        # the second range first: each range writes only its own slots
        got = engine.run(batch, cut, n)
        got = engine.run(batch, 0, cut) + got
        assert got == want, cut
        np.testing.assert_array_equal(batch.nbits, whole.nbits)
        assert not batch.errors.any()
        batch.check()
    for first in range(n):
        batch = engine.prepare(cfg.fmt, out)
        assert engine.run(batch, first, first + 1) == [want[first]]


@pytest.mark.parametrize("fmt", [QCIF, CIF], ids=["qcif", "cif"])
def test_random_symbols_with_escapes_mquant_and_stuffing(fmt):
    """Random valid symbols (every level of -127..127, so escapes, intra DCs
    of 1..254, MQUANT, stuffing) stacked as the encoder stacks its
    outputs: 3 streams x 4 frames, one frame skipped."""
    jfmt = {"CIF": JCIF, "QCIF": JQCIF}[fmt.name]
    rng = np.random.default_rng(17 + fmt.num_mbs)
    s, t = 3, 4
    frames = [[random_frame_symbols(jfmt, rng, tr=i, p_mquant=0.3)
               for i in range(t)] for _ in range(s)]
    out = {
        "frame_coded": np.ones((s, t), bool),
        "tr": np.array([[f.tr for f in fs] for fs in frames], np.int32),
        "n_stuff": rng.integers(0, 40, (s, t)).astype(np.int32),
        "total_bits": np.zeros((s, t), np.int32)}
    for k in ("gquant", "coded", "mtype", "mv", "cbp", "quant_mb"):
        out[k] = np.stack([np.stack([getattr(f, k) for f in fs])
                           for fs in frames]).astype(
            bool if k == "coded" else np.int32)
    levels = np.stack([np.stack([f.levels for f in fs]) for fs in frames])
    intra = (luts.MTYPE_INTRA[out["mtype"]] & out["coded"])[..., None]
    out["dc_intra"] = np.where(intra, levels[..., 0], 0).astype(np.uint8)
    levels[..., 0] = np.where(intra, 0, levels[..., 0])
    out["levels8"] = levels.astype(np.int8)
    assert (out["levels8"] == levels).all()
    out["frame_coded"][1, 2] = False
    cfg = enc.EncoderConfig(fmt=fmt, rate=RateConfig(fixed_quant=8))
    got = _assert_equals_oracles(cfg, _with_oracle_bits(cfg, out))
    assert all(n > 0 for _, n in got)


def test_intra_dc_of_128_is_written_as_255(chunk):
    cfg, out = chunk
    out = {k: v.copy() for k, v in out.items()}
    # an intra coded MB of stream 0's first picture
    mb = int(np.flatnonzero(out["dc_intra"][0, 0, :, 0])[0])
    out["dc_intra"][0, 0, mb, 0] = 128
    got = _assert_equals_oracles(cfg, out)
    (first, *_) = parse_stream(got[0][0])
    assert first.levels[mb, 0, 0] == 128
    syms = enc.outputs_to_symbols(cfg, out)[0][0]
    assert syms.levels[mb, 0, 0] == 128


@pytest.mark.parametrize("level", [-1, -2, -127])
def test_negative_slot0_inter_level(chunk, level):
    cfg, out = chunk
    out = {k: v.copy() for k, v in out.items()}
    # a block an inter MB with CBP transmits, in a coded P picture
    for si, f in zip(*np.nonzero(out["frame_coded"][:, 1:])):
        f = f + 1
        mt = out["mtype"][si, f]
        inter = (out["coded"][si, f] & luts.MTYPE_CBP[mt]
                 & ~luts.MTYPE_INTRA[mt])
        if inter.any():
            mb = int(np.flatnonzero(inter)[0])
            break
    b = next(b for b in range(6) if (out["cbp"][si, f, mb] >> (5 - b)) & 1)
    out["levels8"][si, f, mb, b, 0] = level
    got = _assert_equals_oracles(cfg, _with_oracle_bits(cfg, out))
    parsed = parse_stream(got[si][0])
    n = int(out["frame_coded"][si, :f + 1].sum()) - 1
    assert parsed[n].levels[mb, b, 0] == level


def test_a_stream_that_skipped_every_frame(chunk):
    cfg, out = chunk
    want = enc.serialize_streams(cfg, out)
    out = {k: v.copy() for k, v in out.items()}
    out["frame_coded"][2] = False
    out["total_bits"][2] = 0
    got = _assert_equals_oracles(cfg, out)
    assert got[2] == (b"", 0)
    assert got[:2] + got[3:] == want[:2] + want[3:]
    none = {k: v[2:3] for k, v in out.items()}
    assert enc.serialize_streams(cfg, none) == [(b"", 0)]


def _coded_where(out, flag):
    """(stream, frame, MB) of the first coded MB whose MTYPE has `flag`,
    in a coded picture."""
    hit = (flag[out["mtype"]] & out["coded"]
           & out["frame_coded"][..., None])
    return tuple(int(i) for i in np.argwhere(hit)[0])


def test_cbp_out_of_range_raises(chunk):
    """Counted over the whole chunk: two streams, two ranges."""
    cfg, out = chunk
    out = {k: v.copy() for k, v in out.items()}
    first = _coded_where(out, luts.MTYPE_CBP)
    out["cbp"][first] = 0
    later = {k: v[first[0] + 1:] for k, v in out.items()}
    si, f, mb = _coded_where(later, luts.MTYPE_CBP)
    out["cbp"][first[0] + 1 + si, f, mb] = 64
    with pytest.raises(ValueError, match=re.escape(
            "CBP out of range 1..63 on 2 coded CBP-bearing MBs")):
        enc.serialize_streams(cfg, out)


def test_mquant_without_a_valid_quant_raises(chunk):
    cfg, out = chunk
    out = {k: v.copy() for k, v in out.items()}
    where = _coded_where(out, luts.MTYPE_MQUANT)
    out["quant_mb"][where] = 32
    with pytest.raises(ValueError, match=re.escape(
            "MQUANT MTYPE without a valid 1..31 quant_mb on 1 MBs")):
        enc.serialize_streams(cfg, out)


def test_gquant_out_of_range_raises(chunk):
    cfg, out = chunk
    out = {k: v.copy() for k, v in out.items()}
    out["gquant"][0, 0, 1] = 0
    with pytest.raises(ValueError, match=re.escape(
            "GQUANT out of range 1..31")):
        enc.serialize_streams(cfg, out)


@pytest.mark.parametrize("edit", ["mtype", "mv"])
def test_symbols_outside_the_code_tables_raise(chunk, edit):
    cfg, out = chunk
    out = {k: v.copy() for k, v in out.items()}
    if edit == "mtype":
        out["mtype"][_coded_where(out, luts.MTYPE_CBP)] = 10
    else:
        out["mv"][_coded_where(out, luts.MTYPE_MC)] = (60, 0)
    # an MVD out of range also throws its successor's out of range
    with pytest.raises(ValueError, match=re.escape(
            "MTYPE or MVD outside the code tables on ") + "[12] MBs"):
        enc.serialize_streams(cfg, out)


@pytest.mark.parametrize("key", ["levels8", "dc_intra", "gquant", "mv"])
def test_a_shape_the_engine_cannot_walk_raises(chunk, key):
    cfg, out = chunk
    out = dict(out, **{key: out[key][..., :-1]})
    with pytest.raises(ValueError, match=f"^{key} of shape"):
        enc.serialize_streams(cfg, out)
    with pytest.raises(ValueError, match="^gquant of shape"):
        enc.serialize_streams(enc.EncoderConfig(fmt=CIF), chunk[1])


def test_a_range_outside_the_batch_raises(chunk):
    cfg, out = chunk
    engine = binding.load_batch()
    batch = engine.prepare(cfg.fmt, out)
    for first, last in ((0, batch.streams + 1), (-1, 2), (3, 2)):
        with pytest.raises(ValueError, match="outside the batch's 5"):
            engine.run(batch, first, last)


def test_many_threads_over_one_batch(chunk, monkeypatch):
    """More threads than cores, one stream each, switching often: every
    stream's bytes land in its own slot."""
    cfg, out = chunk
    want = enc.serialize_streams(cfg, out)
    tiled = {k: np.concatenate([v] * 12) for k, v in out.items()}
    monkeypatch.setattr(os, "cpu_count", lambda: 4 * 60)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            assert enc.serialize_streams(cfg, tiled) == want * 12
    finally:
        sys.setswitchinterval(interval)


def test_checks_pass_over_skipped_pictures(chunk):
    """As the per-stream engine's checks, which see coded frames only."""
    cfg, out = chunk
    want = enc.serialize_streams(cfg, out)
    out = {k: v.copy() for k, v in out.items()}
    skipped = np.argwhere(~out["frame_coded"])[0]
    out["gquant"][tuple(skipped)] = 0
    out["cbp"][tuple(skipped)] = 0
    assert enc.serialize_streams(cfg, out) == want


@pytest.mark.parametrize("delta", [1, -1])
def test_total_bits_off_by_one_raises_the_diverged_model_error(chunk,
                                                               delta):
    cfg, out = chunk
    out = {k: v.copy() for k, v in out.items()}
    nbits = int(out["total_bits"][3].sum())
    out["total_bits"][3, 0] += delta
    with pytest.raises(AssertionError, match=re.escape(
            f"stream 3: serializer produced {nbits} bits, device model "
            f"predicted {nbits + delta} -- length model and serializer "
            "have diverged")):
        enc.serialize_streams(cfg, out)


def test_a_stream_that_outgrows_its_slot_spills_nowhere(chunk):
    cfg, out = chunk
    want = enc.serialize_streams(cfg, out)
    out = {k: v.copy() for k, v in out.items()}
    out["total_bits"][1] = 0            # a slot of SLOT_SLACK bytes
    engine = binding.load_batch()
    batch = engine.prepare(cfg.fmt, out)
    assert batch.offsets[2] - batch.offsets[1] == binding.SLOT_SLACK
    got = engine.run(batch, 0, batch.streams)
    assert got[1][1] == want[1][1]
    assert got[1][0] == want[1][0][:binding.SLOT_SLACK]
    assert got[:1] + got[2:] == want[:1] + want[2:]
    with pytest.raises(AssertionError, match="predicted 0 -- length model"):
        enc.serialize_streams(cfg, out)


def test_encode_to_bytes_holds_the_model_through_the_batch_engine(
        chunk, monkeypatch):
    cfg, out = chunk
    tensors = {k: torch.from_numpy(v.copy()) for k, v in out.items()}
    tensors["total_bits"][0, 0] += 8
    monkeypatch.setattr(enc, "encode_sequence",
                        lambda *a, **k: (None, tensors))
    with pytest.raises(AssertionError, match="stream 0: .* have diverged"):
        enc.encode_to_bytes(cfg, {}, device="cpu")


def test_serialize_streams_builds_no_frame_symbols(chunk, monkeypatch):
    cfg, out = chunk
    want = _oracles(cfg, out)

    def refuse(*a, **k):
        raise AssertionError("a FrameSymbols was built")

    monkeypatch.setattr(enc, "FrameSymbols", refuse)
    monkeypatch.setattr(tenc, "FrameSymbols", refuse)
    assert enc.serialize_streams(cfg, out) == want
    with pytest.raises(AssertionError, match="FrameSymbols was built"):
        enc.outputs_to_symbols(cfg, out)


def test_engine_is_built_into_build_native():
    engine = binding.load_batch()
    path = engine._lib._name
    assert os.path.realpath(path) == os.path.realpath(
        os.path.join(REPO, "build", "native", "libp64serialize.so"))
    for src in (_build.BATCH_SOURCE, _build.NATIVE_SOURCE):
        assert os.path.getmtime(path) >= os.path.getmtime(src)
    assert os.path.dirname(_build.BATCH_SOURCE) == os.path.dirname(
        _build.NATIVE_SOURCE)
    with open(_build.BATCH_SOURCE) as f:
        assert '#include "bitio.cpp"' in f.read()


def test_rebuilt_when_the_included_engine_is_newer(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    for f in (_build.BATCH_SOURCE, _build.NATIVE_SOURCE):
        shutil.copy(f, src)
    batch_src = str(src / os.path.basename(_build.BATCH_SOURCE))
    engine_src = str(src / os.path.basename(_build.NATIVE_SOURCE))
    monkeypatch.setattr(_build, "BATCH_SOURCE", batch_src)
    monkeypatch.setattr(_build, "NATIVE_SOURCE", engine_src)
    monkeypatch.setattr(_build, "NATIVE_BUILD_DIR", str(tmp_path / "build"))
    lib = _build.build_batch_serializer()
    assert lib == str(tmp_path / "build" / _build.BATCH_LIB)
    built = os.path.getmtime(lib)
    os.utime(batch_src, (built - 10, built - 10))
    os.utime(engine_src, (built - 10, built - 10))
    assert _build.build_batch_serializer() == lib
    assert os.path.getmtime(lib) == built
    os.utime(engine_src, (built + 10, built + 10))
    _build.build_batch_serializer()
    assert os.path.getmtime(lib) > built


def test_load_batch_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(_build, "NATIVE_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(binding, "_cached", None)
    monkeypatch.setattr(binding, "_cached_batch", None)
    with pytest.raises(_build.BuildError, match="g\\+\\+ not found"):
        binding.load_batch()
    with pytest.raises(_build.BuildError, match="g\\+\\+ not found"):
        enc.serialize_streams(enc.EncoderConfig(fmt=QCIF), {})
    assert binding._cached_batch is None
    assert not (tmp_path / "build").exists()
