"""The room for calls over an errored line: the channel, the reference's
resync parse and playback, and the decode entry's accounting of streams
that the port and the reference refuse.

The reference is held to the port's resync decode (its Python oracle
`entropy.parse.parse_stream(strict=False)`, its engine through
`parse_to_tensors(resync=True)` + `decode_seq`) and to the JAX package's,
on seeded damaged streams of each configuration at a small size.  The
harness imports neither package's decoder for this; only the tests do,
and the JAX package only in a process of its own, since a run of the
harness in a process that holds JAX stops."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from p64tpu_torch.core import decoder as tdec
from p64tpu_torch.entropy import parse as tparse
from port_bench import channel, entries, harness
from port_bench.content import make_content
from port_bench.reference import luts as ref_luts
from port_bench.reference import parse as ref_parse
from port_bench.reference import playback
from port_bench.reference import serialize as ref_serialize
from port_bench.tests.small import small_checkout

CONFIGS = ("cif_q10", "cif_rc_p16", "cif_rc_p30_mq3", "qcif_p2")
CPU = torch.device("cpu")
#: the format bit of PTYPE, counted from the PSC's first bit: PSC (20
#: bits), TR (5), then PTYPE's bits 5, 4, 3 before bit 2
PTYPE_FORMAT_BIT = 20 + 5 + 3


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return small_checkout(str(tmp_path_factory.mktemp("small")))


@pytest.fixture(scope="module")
def encoded(small):
    """Per configuration: its small config, 3 QCIF streams × 5 frames of
    the reference, and the symbols they carry."""
    out = {}
    for name in CONFIGS:
        config = harness.load_json(os.path.join(
            small.root, small.configs[name]["file"]))
        frames = make_content(144, 176, 3, 5, 16, 2**31 + 3, CPU)
        streams, symbols = entries.reference_encode(
            config, frames, keep=ref_serialize.SYMBOL_KEYS)
        out[name] = config, streams, symbols
    return out


def _psc_bits(data: bytes):
    """The bit offsets of the start codes with GN 0."""
    r = ref_parse.Reader(data)
    out = []
    for p in r.codes.tolist():
        r.pos = p + 16
        if r.peek(4) == 0:
            out.append(p)
    return out


def _flip_bits(data: bytes, at) -> bytes:
    out = np.frombuffer(data, np.uint8).copy()
    for b in at:
        out[b >> 3] ^= 0x80 >> (b & 7)
    return out.tobytes()


def _damaged(streams):
    """Seeded damage of each stream at two rates, a PTYPE format flip of
    a later picture (two formats: refused), one of the first picture of
    all (the first picture's format differs from the rest: refused) and
    a stream with no start code left."""
    out = []
    for seed in (2**31 + 11, 5, 123456789):
        for rate in (3e-4, 3e-3):
            out += channel.flip(streams, rate, seed)[0]
    for data, _ in streams:
        pscs = _psc_bits(data)
        out.append(_flip_bits(data, [pscs[-1] + PTYPE_FORMAT_BIT]))
        out.append(_flip_bits(data, [pscs[0] + PTYPE_FORMAT_BIT]))
    out.append(bytes([0xFF]) * 64)
    return out


def _fields_equal(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert (a.fmt.name, a.tr, a.damaged) == (b.fmt.name, b.tr, b.damaged)
        for f in ("gquant", "coded", "intra", "mc", "fil", "quant", "mv",
                  "cbp", "gob_damaged"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert np.array_equal(a.dense_levels(), b.levels)


def _port_planes(data):
    try:
        fmt, _, seq = tdec.parse_to_tensors(data, resync=True)
    except tparse.StreamError:
        return None
    return tdec.decode_seq(fmt, seq, device="cpu")


#: the JAX package's resync decode of each stream in argv[1] (an npz of
#: byte strings), written to argv[2]: its planes, or nothing where it
#: refuses the stream
_JAX_DECODE = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from p64tpu.core import decoder
from p64tpu.entropy.parse import StreamError
out = {}
with np.load(sys.argv[1]) as z:
    for k in z.files:
        try:
            fmt, _, seq = decoder.parse_to_tensors(z[k].tobytes(),
                                                   resync=True)
        except StreamError:
            continue
        for n, p in zip(("y", "cb", "cr"), decoder.decode_seq(fmt, seq)):
            out[f"{k}_{n}"] = np.asarray(p)
np.savez(sys.argv[2], **out)
"""


def _jax_planes(datas, tmp_path):
    """The JAX package's planes of each stream, or None where it refuses
    it, decoded in a process of its own."""
    src, dst = tmp_path / "streams.npz", tmp_path / "planes.npz"
    np.savez(src, **{f"s{i}": np.frombuffer(d, np.uint8)
                     for i, d in enumerate(datas)})
    subprocess.run([sys.executable, "-c", _JAX_DECODE, str(src), str(dst)],
                   cwd=harness.ROOT, check=True, timeout=600,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    with np.load(dst) as z:
        return [tuple(z[f"s{i}_{n}"] for n in ("y", "cb", "cr"))
                if f"s{i}_y" in z.files else None
                for i in range(len(datas))]


def _same_planes(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(x.shape == y.shape and np.array_equal(x, y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("name", CONFIGS)
def test_the_reference_decodes_damage_as_the_port_and_jax(encoded, name,
                                                         tmp_path):
    _, streams, _ = encoded[name]
    datas = _damaged(streams)
    parsed = playback.parse_streams(datas)
    played = playback.play(parsed, CPU, 4)
    refused = 0
    for data, pics, mine, theirs in zip(datas, parsed, played,
                                        _jax_planes(datas, tmp_path)):
        pictures = ref_parse.parse_resync(data)
        _fields_equal(pictures, tparse.parse_stream(data, strict=False))
        assert (pics is None) == (ref_parse.refusal(pictures) is not None)
        refused += pics is None
        assert _same_planes(mine, _port_planes(data))
        assert _same_planes(mine, theirs)
    # the two format flips of each stream and the stream with no code
    assert refused >= 2 * len(streams) + 1
    # and the seeded damage made the concealment work
    assert any(p.damaged for pics in parsed if pics for p in pics)


@pytest.mark.parametrize("name", CONFIGS)
def test_a_clean_stream_parses_to_the_encoders_symbols(encoded, name):
    _, streams, sym = encoded[name]
    for s, (data, _) in enumerate(streams):
        pictures = ref_parse.parse_resync(data)
        frames = np.flatnonzero(sym["frame_coded"][s])
        assert len(pictures) == len(frames)
        for pic, t in zip(pictures, frames):
            coded = sym["coded"][s, t]
            mtype = sym["mtype"][s, t]
            mc = ref_luts.MTYPE_MC[mtype] & coded
            assert not pic.damaged and pic.tr == sym["tr"][s, t]
            assert np.array_equal(pic.gquant, sym["gquant"][s, t])
            assert np.array_equal(pic.coded, coded)
            assert np.array_equal(pic.intra, ref_luts.MTYPE_INTRA[mtype]
                                  & coded)
            assert np.array_equal(pic.mc, mc)
            assert np.array_equal(pic.fil, ref_luts.MTYPE_FIL[mtype] & coded)
            # the quantizer of every MB that carries coefficients (one
            # without keeps the last MQUANT sent, whatever its segment's)
            sent = coded & (pic.cbp != 0)
            assert np.array_equal(pic.quant[sent], sym["quant_mb"][s, t][sent])
            assert np.array_equal(pic.mv[mc], sym["mv"][s, t][mc])
            assert np.array_equal(pic.cbp[coded], sym["cbp"][s, t][coded])
            want = np.where(coded[:, None, None], sym["levels"][s, t], 0)
            assert np.array_equal(pic.dense_levels(), want)
        # and the playback of the clean stream is the encoder's
        # reconstruction, which the port's strict decode gives too
        got = playback.play([pictures], CPU, 1)[0]
        assert _same_planes(got, _port_planes(data))


def test_the_channel_is_seeded_and_keeps_its_rate():
    rng = np.random.default_rng(3)
    streams = []
    for _ in range(400):
        nbits = int(rng.integers(20_000, 60_000))
        streams.append((rng.bytes(-(-nbits // 8)), nbits))
    rate = 1e-4
    one, flips = channel.flip(streams, rate, 2**31 + 7)
    again, flips_again = channel.flip(streams, rate, 2**31 + 7)
    other, _ = channel.flip(streams, rate, 2**31 + 8)
    assert one == again and flips == flips_again and one != other
    total = sum(n for _, n in streams)
    seen = 0
    for (data, nbits), got, n in zip(streams, one, flips):
        bits = np.unpackbits(np.frombuffer(data, np.uint8)
                             ^ np.frombuffer(got, np.uint8))
        assert int(bits.sum()) == n and not bits[nbits:].any()
        seen += n
    sigma = (total * rate * (1 - rate)) ** 0.5
    assert abs(seen - total * rate) < 5 * sigma
    # a stream's draw is its index's: the same stream at index 0 draws
    # other bits
    assert flips[5] > 0
    assert channel.flip(streams[5:6], rate, 2**31 + 7)[0][0] != one[5]
    assert channel.flip([], rate, 1) == ([], [])


def test_a_channel_states_a_rate_and_its_streams_get_the_resync_parse(
        small, monkeypatch):
    cell = "cif_rc_p16.decode"
    config, traffic = small.config(cell), small.traffic(cell)
    make = entries.ENTRIES["batch_decode"]

    def entry(**keys):
        return make(dict(config, **keys), traffic, 1, CPU, lambda m: None,
                    "unused")
    with pytest.raises(ValueError):
        entry(channel={"bit_error_rate": 2.0})
    with pytest.raises(ValueError):
        entry(channel={"bit_error_rate": 1e-5, "burst": 3})
    calls = []
    monkeypatch.setattr(tdec, "parse_to_tensors",
                        lambda data, **kw: calls.append(kw))
    entry()._parse_one(b"")
    entry(channel={"bit_error_rate": 1e-5})._parse_one(b"")
    assert calls == [{}, {"resync": True}]


def _old_key(config, traffic, seed):
    """The clean streams' cache key as the decode entry has always made
    it."""
    return hashlib.sha256(json.dumps(
        [config, traffic["streams"], traffic["frames"], traffic["noise"],
         seed, "cpu", entries.reference_digest()],
        sort_keys=True).encode()).hexdigest()[:32]


def test_without_the_keys_the_inputs_and_cache_key_are_as_before(small):
    cell = "cif_rc_p16.decode"
    config, traffic = small.config(cell), small.traffic(cell)
    seed = 2**31 + 9
    make = entries.ENTRIES["batch_decode"]
    cache = os.path.join(small.root, harness.INPUT_CACHE)
    plain = make(config, traffic, seed, CPU, lambda m: None, cache)
    assert plain._clean_key() == _old_key(config, traffic, seed)
    plain.setup()
    assert plain.datas == [d for d, _ in plain.inputs]
    assert plain.refused == set()
    assert [n for n, _, _ in plain.check()] == ["pixels_differ"]
    # a twin on a line shares the clean streams and damages its own copy
    logs = []
    twin = make(dict(config, channel={"bit_error_rate": 3e-3}), traffic,
                seed, CPU, logs.append, cache)
    assert twin._clean_key() == plain._clean_key()
    twin.setup()
    assert twin.inputs == plain.inputs and twin.datas != plain.datas
    assert entries.load_streams(os.path.join(
        cache, f"streams-{plain._clean_key()}.npz")) == plain.inputs
    assert any(m.startswith("channel: bit error rate 0.003") and
               "per stream [" in m for m in logs)


def _refusing_line(monkeypatch, refuse):
    """The channel, then the streams in `refuse` made such that no decoder
    has an answer: stream 0 loses every start code, any other gets a
    second picture format."""
    flip = channel.flip

    def line(streams, rate, seed):
        datas, flips = flip(streams, rate, seed)
        for i in refuse:
            datas[i] = (bytes([0xFF]) * len(datas[i]) if i == 0 else
                        _flip_bits(datas[i], [_psc_bits(datas[i])[-1]
                                              + PTYPE_FORMAT_BIT]))
        return datas, flips
    monkeypatch.setattr(channel, "flip", line)


def _line_checkout(tmp_path, cell):
    m = small_checkout(str(tmp_path))
    path = os.path.join(m.root, m.configs[m.cells[cell]["config"]]["file"])
    config = harness.load_json(path)
    config.update(channel={"bit_error_rate": 1e-3})
    with open(path, "w") as f:
        json.dump(config, f)
    return harness.Manifest(m.root)


@pytest.mark.parametrize("cell", ["cif_rc_p16.decode", "cif_q10.decode"])
def test_streams_both_refuse_are_attempted_and_agreed(tmp_path,
                                                      monkeypatch, cell):
    m = _line_checkout(tmp_path, cell)
    _refusing_line(monkeypatch, (0, 2))
    r = harness.run(cell, 2**31 + 31, 0.01, False, CPU, 0.0, m)
    assert r["correct"] and r["failed"] == 0
    assert r["attempted"] % 3 == 0 and r["attempted"] > 0
    assert r["checks"] == {"pixels_differ": {"value": 0, "limit": 0},
                           "streams_refused": {"value": 2, "limit": 2},
                           "refused_alone": {"value": 0, "limit": 0}}


def test_a_stream_only_the_port_refuses_fails(tmp_path, monkeypatch):
    cell = "cif_rc_p16.decode"
    m = _line_checkout(tmp_path, cell)
    _refusing_line(monkeypatch, (2,))
    parse_one = entries.BatchDecode._parse_one

    def refuse_first(self, data):
        return None if data == self.datas[1] else parse_one(self, data)
    monkeypatch.setattr(entries.BatchDecode, "_parse_one", refuse_first)
    r = harness.run(cell, 2**31 + 33, 0.01, False, CPU, 0.0, m)
    # the refusals are judged after the window, not counted in it
    assert not r["correct"] and r["failed"] == 0
    assert r["checks"]["streams_refused"] == {"value": 2, "limit": 1}
    assert r["checks"]["refused_alone"] == {"value": 1, "limit": 0}
    assert r["checks"]["pixels_differ"]["value"] > 0


def test_a_stream_the_port_answers_where_the_reference_refuses_differs(
        tmp_path, monkeypatch):
    cell = "cif_rc_p16.decode"
    m = _line_checkout(tmp_path, cell)
    _refusing_line(monkeypatch, (2,))
    parse_one = entries.BatchDecode._parse_one

    def answer_all(self, data):
        return parse_one(self, self.inputs[2][0] if data == self.datas[2]
                         else data)
    monkeypatch.setattr(entries.BatchDecode, "_parse_one", answer_all)
    r = harness.run(cell, 2**31 + 35, 0.01, False, CPU, 0.0, m)
    assert not r["correct"] and r["failed"] == 0
    assert r["checks"]["streams_refused"] == {"value": 0, "limit": 1}
    assert r["checks"]["refused_alone"] == {"value": 0, "limit": 0}
    assert r["checks"]["pixels_differ"]["value"] > 0


def test_without_a_line_a_refused_stream_fails(tmp_path, monkeypatch):
    cell = "cif_rc_p16.decode"
    m = small_checkout(str(tmp_path))
    parse_one = entries.BatchDecode._parse_one

    def refuse_first(self, data):
        return None if data == self.datas[1] else parse_one(self, data)
    monkeypatch.setattr(entries.BatchDecode, "_parse_one", refuse_first)
    r = harness.run(cell, 2**31 + 37, 0.01, False, CPU, 0.0, m)
    assert not r["correct"] and r["failed"] == r["attempted"] // 3
    assert list(r["checks"]) == ["pixels_differ"]
    assert r["checks"]["pixels_differ"]["value"] > 0


def test_the_control_of_a_line_is_the_reference_at_a_lower_precision(
        tmp_path):
    from port_bench import control
    cell = "cif_rc_p16.decode"
    m = _line_checkout(tmp_path, cell)
    r = control.run_control(cell, 2**31 + 39, "tf32", CPU, m)
    assert not r["correct"] and r["failed"] == 0
    assert r["checks"]["pixels_differ"]["value"] > 0
    assert r["checks"]["streams_refused"]["value"] <= \
        r["checks"]["streams_refused"]["limit"]
    assert r["checks"]["refused_alone"]["value"] == 0
