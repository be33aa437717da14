"""The H.320 videophone over an errored line on the port's CPU path: the
benchmark's `qcif_p2_ber1e5` streams (QCIF at p = 2), at a few streams and
frames and at bit error rates that damage several GOBs, through
`parse_to_tensors(resync=True)` and `decode_seq_batch` in groups of equal
picture count, as the benchmark's decode entry calls them.  The planes
equal the benchmark's plain resync playback and the refused streams its
refusals; the damage counters equal its damage flags; batches padded to
the decoder's sizes give the unpadded planes and capture nothing after a
job's first pass; the parse's buffers hold the stream's pictures and grow
where the start-code count misleads; and `tools/batch_decode.py` refuses a
stream alone."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from p64tpu_torch import trace
from p64tpu_torch.core import decoder, graphs
from p64tpu_torch.entropy.parse import StreamError
from p64tpu_torch.io import yuv
from p64tpu_torch.native import binding, load
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import batch_decode
from port_bench import channel, entries, harness
from port_bench.content import make_content
from port_bench.reference import parse as ref_parse
from port_bench.reference import playback

torch.set_num_threads(1)

CELL = "qcif_p2_ber1e5.decode"
CPU = torch.device("cpu")
STREAMS, FRAMES = 6, 10
CONTENT_SEED = 2**31 + 27
#: (line seed, bit error rate): rates at which most pictures lose a GOB
LINES = [(2**31 + 101, 1e-3), (202, 3e-3), (2**33 + 303, 1e-3)]
#: the format bit of PTYPE, counted from the PSC's first bit: PSC (20
#: bits), TR (5), then PTYPE's bits 5, 4, 3 before bit 2
PTYPE_FORMAT_BIT = 20 + 5 + 3
#: bytes of the parse's output buffers a frame
FRAME_BYTES = sum(int(np.prod(shape)) * np.dtype(dt).itemsize
                  for _, shape, dt in binding.NativeBitIO._RAW_FIELDS)


@pytest.fixture(scope="module")
def clean():
    """The reference's (bytes, nbits) of the configuration's content."""
    m = harness.Manifest()
    noise = m.traffic(CELL)["noise"]
    frames = make_content(QCIF.height, QCIF.width, STREAMS, FRAMES, noise,
                          CONTENT_SEED, CPU)
    streams, _ = entries.reference_encode(m.config(CELL), frames)
    return streams


def _pscs(data: bytes):
    """Bit offsets of the picture start codes (the reference reader's
    start codes with GN 0)."""
    r = ref_parse.Reader(data)
    out = []
    for p in r.codes.tolist():
        r.pos = p + 16
        if r.peek(4) == 0:
            out.append(p)
    return out


def _flip(data: bytes, bits) -> bytes:
    out = np.frombuffer(data, np.uint8).copy()
    for b in bits:
        out[b >> 3] ^= 0x80 >> (b & 7)
    return out.tobytes()


def _line(clean, seed, rate):
    """The streams after the line; then stream 0 loses every start code
    and stream 1 is the clean one with its last picture turned CIF: two
    streams no decoder has an answer for."""
    datas, _ = channel.flip(clean, rate, seed)
    datas[0] = bytes([0xFF]) * len(datas[0])
    data = clean[1][0]
    datas[1] = _flip(data, [_pscs(data)[-1] + PTYPE_FORMAT_BIT])
    return datas


def _parse(data):
    try:
        return decoder.parse_to_tensors(data, resync=True)
    except StreamError:
        return None


def _port_job(datas):
    """The decode entry's job: the resync parse, then one decode_seq_batch
    per group of equal format and picture count; None where refused."""
    parsed = [_parse(d) for d in datas]
    groups = {}
    for i, got in enumerate(parsed):
        if got is not None:
            groups.setdefault((got[0], got[2]["levels8"].shape[0]),
                              []).append(i)
    planes = [None] * len(datas)
    for (fmt, _), idxs in groups.items():
        for i, p in zip(idxs, decoder.decode_seq_batch(
                fmt, [parsed[i][2] for i in idxs], device=CPU)):
            planes[i] = p
    return planes


def _added(before):
    return {k: v - before.get(k, 0) for k, v in trace.counters().items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("seed,rate", LINES)
def test_the_port_plays_the_line_as_the_reference(clean, seed, rate):
    datas = _line(clean, seed, rate)
    want = playback.play(playback.parse_streams(datas), CPU, 4)
    got = _port_job(datas)
    assert {i for i, p in enumerate(got) if p is None} == {
        i for i, p in enumerate(want) if p is None} == {0, 1}
    for g, w in zip(got, want):
        if w is not None:
            assert all(a.shape == b.shape and np.array_equal(a, b)
                       for a, b in zip(g, w))
    # the picture counts differ: more than one group
    assert len({p[0].shape[0] for p in got if p is not None}) > 1


@pytest.mark.parametrize("seed,rate", LINES)
def test_the_damage_counters_equal_the_reference_flags(clean, seed, rate):
    datas = _line(clean, seed, rate)
    pictures = [p for p in playback.parse_streams(datas) if p is not None]
    before = trace.counters()
    _port_job(datas)
    assert _added(before) == {}                  # tracing off: nothing
    with profile(activities=[ProfilerActivity.CPU]):
        _port_job(datas)
    added = _added(before)
    gobs = sum(int(p.gob_damaged.sum()) for pics in pictures for p in pics)
    damaged = sum(p.damaged for pics in pictures for p in pics)
    assert gobs >= 3 and damaged >= 3
    assert added["p64.decode.damaged_gobs"] == gobs
    assert added["p64.decode.damaged_pictures"] == damaged
    assert added["p64.decode.gobs"] == sum(
        len(pics) for pics in pictures) * QCIF.num_gobs
    assert added["p64.decode.refused_streams"] == 2


def test_a_clean_parse_carries_zero_damage_words(clean):
    for data, _ in clean:
        _, _, seq = decoder.parse_to_tensors(data)
        assert seq["damage"].dtype == np.int32
        assert seq["damage"].shape == (seq["levels8"].shape[0],)
        assert not seq["damage"].any()


@pytest.mark.parametrize("streams,want", [
    (1, 1), (2, 2), (3, 4), (5, 8), (100, 128), (128, 128), (129, 256),
    (512, 512), (513, 1024), (1100, 1536)])
def test_batch_streams(streams, want):
    assert decoder.batch_streams(streams) == want


def _seqs(clean, n):
    """n parsed copies of the clean streams, all of one picture count."""
    parsed = [decoder.parse_to_tensors(d)[2] for d, _ in clean]
    t = min(s["levels8"].shape[0] for s in parsed)
    same = [s for s in parsed if s["levels8"].shape[0] == t]
    return [same[i % len(same)] for i in range(n)]


@pytest.mark.parametrize("streams", [3, 5, 6])
def test_a_padded_batch_decodes_as_the_unpadded_one(clean, streams):
    seqs = _seqs(clean, streams)
    padded = decoder.batch_streams(streams)
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = decoder.decode_seq_batch(QCIF, seqs, device=CPU)
    want = decoder.reconstruct_seq_eager(
        QCIF, decoder.stack_seqs(QCIF, seqs, CPU))
    assert len(got) == streams and padded > streams
    for i, planes in enumerate(got):
        for a, b in zip(planes, want):
            assert np.array_equal(a, b[i].numpy())
    t = seqs[0]["levels8"].shape[0]
    added = _added(before)
    assert added["p64.decode.padded_mbs"] == t * (padded - streams) * 99
    assert added["p64.decode.macroblocks"] == t * streams * 99
    assert added["p64.decode.packed_mbs"] == t * streams * 99


def test_the_padding_codes_nothing(clean):
    """The streams a batch is padded with are all zeros: no coded MB, no
    level; their planes stay black."""
    seqs = _seqs(clean, 3)
    batch = decoder.stack_seqs(QCIF, seqs, CPU, streams=8)
    for k, v in batch.items():
        assert v.shape[1] == 8 and not v[:, 3:].any(), k
    y, cb, cr = decoder.reconstruct_seq_eager(QCIF, batch)
    assert not y[3:].any() and not cb[3:].any() and not cr[3:].any()
    with pytest.raises(ValueError, match="cannot hold"):
        decoder.stack_seqs(QCIF, seqs, CPU, streams=2)


def test_a_job_of_many_group_sizes_captures_only_in_its_first(
        clean, monkeypatch):
    """The decode entry's call pattern, a decode_seq_batch per group of
    its own stream count, twice, through programs on the CPU (capture
    off): the first job builds one program per padded size, the second
    none; every plane equals the eager decode."""
    cache = graphs.ProgramCache(decoder.PROGRAMS.size)
    monkeypatch.setattr(decoder, "reconstruct_seq",
                        lambda fmt, batch: decoder.reconstruct_seq_graphed(
                            fmt, batch, cache=cache))
    sizes = (1, 3, 5, 7, 9, 17)
    groups = [_seqs(clean, n) for n in sizes]
    for job in range(2):
        for seqs in groups:
            got = decoder.decode_seq_batch(QCIF, seqs, device=CPU)
            want = decoder.reconstruct_seq_eager(
                QCIF, decoder.stack_seqs(QCIF, seqs, CPU))
            for i, planes in enumerate(got):
                assert all(np.array_equal(a, b[i].numpy())
                           for a, b in zip(planes, want))
        assert cache.builds == len({decoder.batch_streams(n)
                                    for n in sizes}) == 5
    assert len(cache) == 5


def test_the_decode_cache_holds_every_size_of_both_formats():
    """Every batch size of both formats stays cached: a second pass over
    them builds nothing."""
    cache = graphs.ProgramCache(decoder.PROGRAMS.size)
    keys = [("decode", fmt, n, CPU) for fmt in (QCIF, CIF)
            for n in decoder.BATCH_STREAMS]
    for _ in range(2):
        for k in keys:
            cache.get(k, object, CPU)
    assert cache.builds == len(keys) == len(cache)
    assert decoder.PROGRAMS is not graphs.PROGRAMS
    assert graphs.PROGRAMS.size == graphs.MAX_PROGRAMS


def _psc_count(data: bytes) -> int:
    """Picture start codes bit by bit: 15 zeros, a one, GN 0, the stream
    read as if zeros followed it."""
    bits = np.concatenate([np.unpackbits(np.frombuffer(data, np.uint8)),
                           np.zeros(4, np.uint8)])
    want = np.array([0] * 15 + [1] + [0] * 4, np.uint8)
    if bits.size < 20:
        return 0
    windows = np.lib.stride_tricks.sliding_window_view(bits, 20)
    return int((windows == want).all(axis=1).sum())


def _odd_bytes():
    rng = np.random.default_rng(5)
    out = [b"", b"\x00", b"\x00\x01\x00", b"\x00\x00\x10\x00",
           b"\xff\x00\x08\x00\x00\x01\x00"]
    for _ in range(20):
        out.append(rng.choice([0, 0, 1, 0x10, 0x80, 0xFF, 7],
                              size=int(rng.integers(1, 200))).astype(
                                  np.uint8).tobytes())
    return out


def test_picture_starts_counts_every_code(clean):
    for data in _odd_bytes() + [d for d, _ in clean] + _line(
            clean, *LINES[1]):
        got = load().picture_starts(np.frombuffer(data, np.uint8))
        assert got == _psc_count(data)


def test_the_parse_holds_no_more_frames_than_its_pictures(clean):
    """A clean stream's buffers hold its pictures exactly; a damaged one's
    at least its parsed pictures, and no more than its start codes."""
    engine = load()
    for data in [d for d, _ in clean] + _line(clean, *LINES[0])[2:]:
        n, out = engine._raw_parse(data, 65536, resync=True)
        starts = engine.picture_starts(np.frombuffer(data, np.uint8))
        assert n <= out["levels8"].shape[0] == starts
    for data, _ in clean:
        before = trace.counters()
        with profile(activities=[ProfilerActivity.CPU]):
            _, _, seq = decoder.parse_to_tensors(data)
        assert _added(before) == {
            "p64.parse.alloc_bytes": seq["levels8"].shape[0] * FRAME_BYTES}


def test_the_parse_grows_where_the_count_misleads(clean, monkeypatch):
    """A count of one picture for a stream of many: the buffers grow 4x a
    try, every try's bytes counted, and the parse is the same."""
    data = b"".join(d for d, _ in clean)     # every stream's pictures
    want_fmt, want_tr, want = decoder.parse_to_tensors(data, resync=True)
    n = want["levels8"].shape[0]
    assert 16 < n <= 64
    monkeypatch.setattr(binding.NativeBitIO, "picture_starts",
                        lambda self, buf: 1)
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        fmt, tr, got = decoder.parse_to_tensors(data, resync=True)
    assert _added(before) == {
        "p64.parse.alloc_bytes": (1 + 4 + 16 + 64) * FRAME_BYTES}
    assert fmt is want_fmt and np.array_equal(tr, want_tr)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    with pytest.raises(StreamError, match="frame-cap overflow"):
        load().parse_tensors(data, max_frames=8, resync=True)


@pytest.mark.parametrize("resync", [True, False], ids=["e", "strict"])
def test_batch_decode_refuses_one_stream_and_writes_the_rest(
        clean, tmp_path, capsys, resync):
    datas = [d for d, _ in clean[:3]]
    datas[1] = bytes([0xFF]) * 64
    paths = []
    for i, d in enumerate(datas):
        paths.append(str(tmp_path / f"s{i}.p64"))
        with open(paths[-1], "wb") as f:
            f.write(d)
    outdir = tmp_path / "out"
    argv = ["-o", str(outdir), "--device", "cpu"] + paths
    assert batch_decode.main((["-e"] if resync else []) + argv) == 1
    err = capsys.readouterr().err
    assert f"{paths[1]}: invalid H.261 stream" in err
    assert f"1 stream(s) REFUSED: {paths[1]}" in err
    assert sorted(os.listdir(outdir)) == ["s0.y4m", "s2.y4m"]
    for i in (0, 2):
        got, _ = yuv.read_y4m(str(outdir / f"s{i}.y4m"))
        fmt, _, seq = decoder.parse_to_tensors(datas[i])
        want = decoder.decode_seq(fmt, seq, device=CPU)
        for k, w in zip(("y", "cb", "cr"), want):
            assert np.array_equal(got[k], w), k


def test_the_line_configuration():
    """qcif_p2 unchanged but for its name, source and assumptions, plus
    the line's rate; nothing reduced; the manifest states the same."""
    m = harness.Manifest()
    line, clean_config = m.config(CELL), m.config("qcif_p2.decode")
    differ = {"name", "source", "assumed"}
    assert set(line) == set(clean_config) | {"channel"}
    for k in set(clean_config) - differ:
        assert line[k] == clean_config[k], k
    assert line["channel"] == {"bit_error_rate": 1e-5}
    assert channel.check(line["channel"]) == 1e-5
    assert line["reduced"] == [] == m.configs["qcif_p2_ber1e5"]["reduced"]
    assert line["source"] == m.configs["qcif_p2_ber1e5"]["source"]
    assert len(line["source"]) <= 200
    assert line["name"] == m.cells[CELL]["config"] == "qcif_p2_ber1e5"
    assert {k: v for k, v in line["assumed"].items() if k != "channel"} \
        == clean_config["assumed"]
