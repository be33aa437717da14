"""The port's spans and counters (`p64tpu_torch.trace`) on the CPU: tracing
off records nothing; under the profiler a batch encode and a decode record
every host stage once per chunk or group, nested as the code nests them and
on the profiler's own clock; the copy-counting rule; the self-time table;
and the benchmark's twelve readers of the span log, on synthetic traces and
logs."""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from p64tpu_torch import trace
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import decoder, encoder, graphs
from p64tpu_torch.distrib import mesh as dm
from p64tpu_torch.spec.constants import QCIF
from p64tpu_torch.tools import profile as profile_tool
from p64tpu_torch.tools.batch_encode import encode_resilient
from p64tpu_torch.utils import fan_map
from port_bench import harness, spanlog, tracing

torch.set_num_threads(1)

STREAMS, FRAMES, CHUNK = 4, 3, 2
CPU = torch.device("cpu")
CUDA = torch.device("cuda")


def _batch():
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:QCIF.height, 0:QCIF.width]
    ys = np.stack([np.stack([
        ((xx * 2 + yy + 9 * t + 5 * s) % 200 + rng.integers(0, 5, xx.shape))
        .astype(np.uint8) for t in range(FRAMES)]) for s in range(STREAMS)])
    return dict(y=ys, cb=(ys[:, :, ::2, ::2] // 2 + 40).astype(np.uint8),
                cr=(ys[:, :, 1::2, ::2] // 2 + 60).astype(np.uint8))


def _cfg():
    return encoder.EncoderConfig(fmt=QCIF, emit_recon=False,
                                 rate=RateConfig(fixed_quant=10))


def _encode():
    return encode_resilient(_cfg(), _batch(), dm.make_mesh(devices=[CPU]),
                            chunk=CHUNK)


def _decode(datas):
    parsed = fan_map(decoder.parse_to_tensors, datas)
    return decoder.decode_seq_batch(parsed[0][0], [p[2] for p in parsed],
                                    device=CPU)


def _new(before):
    return [r for r in trace.spans() if r.id > before]


def _last_id():
    return max((r.id for r in trace.spans()), default=0)


def test_tracing_off_records_nothing():
    assert not trace.enabled()
    spans, counters = trace.spans(), trace.counters()
    assert all(r is not None for r in _encode())
    assert trace.spans() == spans and trace.counters() == counters
    assert trace.span("p64.x") is trace.span("p64.y")   # the shared no-op


@pytest.fixture(scope="module")
def traced():
    """One encode job and the decode of its bytes under the profiler:
    (untraced bytes, traced bytes, traced planes, encode records, decode
    records, counters added, profiler events)."""
    want = _encode()
    before, counted = _last_id(), trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        got = _encode()
        middle = _last_id()
        planes = _decode([d for d, _ in got])
    assert not trace.enabled()
    records = _new(before)
    added = {k: v - counted.get(k, 0) for k, v in trace.counters().items()
             if v != counted.get(k, 0)}
    return (want, got, planes, [r for r in records if r.id <= middle],
            [r for r in records if r.id > middle], added,
            list(prof.profiler.kineto_results.events()))


def test_traced_job_gives_the_same_bytes_and_planes(traced):
    want, got, planes, *_ = traced
    assert got == want
    assert len(planes) == STREAMS
    assert all(p[0].shape == (FRAMES, QCIF.height, QCIF.width)
               for p in planes)


def test_encode_spans_nest_per_chunk(traced):
    records = traced[3]
    names = sorted(r.name for r in records)
    chunks = STREAMS // CHUNK
    assert names == sorted(
        ["p64.encode.job"] + chunks * [
            "p64.encode.dispatch", "p64.encode.frames_in",
            "p64.encode.wait", "p64.encode.symbols", "p64.fan.serialize"])
    by_id = {r.id: r for r in records}
    (job,) = [r for r in records if r.name == "p64.encode.job"]
    assert job.parent is None and job.root == job.id
    parent = {"p64.encode.dispatch": "p64.encode.job",
              "p64.encode.frames_in": "p64.encode.dispatch",
              "p64.encode.wait": "p64.encode.job",
              "p64.encode.symbols": "p64.encode.job",
              "p64.fan.serialize": "p64.encode.job"}
    for r in records:
        assert r.root == job.id and r.thread == job.thread
        assert job.start_ns <= r.start_ns <= r.end_ns <= job.end_ns
        if r is not job:
            assert by_id[r.parent].name == parent[r.name]


def test_decode_spans(traced):
    records = traced[4]
    assert sorted(r.name for r in records) == [
        "p64.decode.planes_out", "p64.decode.stack", "p64.decode.wait",
        "p64.fan.parse_to_tensors"]
    assert all(r.parent is None and r.root == r.id for r in records)
    order = [r.name for r in sorted(records, key=lambda r: r.start_ns)]
    assert order == ["p64.fan.parse_to_tensors", "p64.decode.stack",
                     "p64.decode.wait", "p64.decode.planes_out"]


def test_counters_of_the_jobs(traced):
    mbs = STREAMS * FRAMES * QCIF.num_mbs
    # every copy stays on the CPU: no copy counter moves; a fixed
    # quantizer codes every frame; every decoded MB's levels crossed packed
    assert traced[5] == {"p64.encode.macroblocks": mbs,
                         "p64.serialize.streams": STREAMS,
                         "p64.rate.coded_frames": STREAMS * FRAMES,
                         "p64.decode.macroblocks": mbs,
                         "p64.decode.packed_mbs": mbs}


@pytest.mark.parametrize("streams", [1, 3])
def test_batch_serializer_counts_its_streams(streams):
    """A traced job's p64.serialize.streams equals its streams, however
    they are chunked; untraced, and in a decode, the counter stays."""
    batch = {k: v[:streams] for k, v in _batch().items()}
    mesh = dm.make_mesh(devices=[CPU])
    before = trace.counters().get("p64.serialize.streams", 0)
    encode_resilient(_cfg(), batch, mesh, chunk=CHUNK)
    assert trace.counters().get("p64.serialize.streams", 0) == before
    with profile(activities=[ProfilerActivity.CPU]):
        got = encode_resilient(_cfg(), batch, mesh, chunk=CHUNK)
        middle = trace.counters()["p64.serialize.streams"]
        _decode([d for d, _ in got])
    assert middle - before == streams
    assert trace.counters()["p64.serialize.streams"] == middle


def test_only_the_batch_serializer_opens_the_symbols_span():
    """Under the profiler the oracle (outputs_to_symbols) opens no
    p64.encode.symbols span on CPU outputs; serialize_streams opens
    exactly one."""
    cfg = _cfg()
    _, out = encoder.encode_sequence(cfg, _batch(), device=CPU)

    def symbols_spans(fn):
        before = _last_id()
        with profile(activities=[ProfilerActivity.CPU]):
            fn(cfg, out)
        return [r for r in _new(before) if r.name == "p64.encode.symbols"]

    assert symbols_spans(encoder.outputs_to_symbols) == []
    assert len(symbols_spans(encoder.serialize_streams)) == 1


def test_spans_are_on_the_profiler_clock(traced):
    records = traced[3] + traced[4]
    events = {}
    for e in traced[6]:
        if e.name().startswith("p64."):
            events.setdefault(e.name(), []).append(e)
    for name in {r.name for r in records}:
        mine = sorted((r for r in records if r.name == name),
                      key=lambda r: r.start_ns)
        theirs = sorted(events[name], key=lambda e: e.start_ns())
        assert len(mine) == len(theirs)
        for r, e in zip(mine, theirs):
            assert abs(e.start_ns() - r.start_ns) < 1_000_000, name
            assert abs(e.start_ns() + e.duration_ns() - r.end_ns) \
                < 1_000_000, name


def test_program_spans_build_then_replays():
    cache = graphs.ProgramCache()
    state = dict(acc=torch.zeros(2, 3, dtype=torch.int32))
    inputs = dict(x=torch.arange(12, dtype=torch.int32).reshape(2, 2, 3))

    def step(st, fr):
        new = dict(acc=st["acc"] + fr["x"])
        return new, dict(out=new["acc"] * 2)

    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]):
        graphs.run("k", step, state, inputs, axis=1, cache=cache)
        graphs.run("k", step, state, inputs, axis=1, cache=cache)
    records = sorted(_new(before), key=lambda r: r.start_ns)
    assert [r.name for r in records] == [
        "p64.graphs.build", "p64.graphs.replays", "p64.graphs.replays"]
    assert cache.builds == 1


@pytest.mark.parametrize("src,dst,pinned,want", [
    (CPU, CUDA, False, "p64.copy.h2d.pageable_bytes"),
    (CPU, CUDA, True, "p64.copy.h2d.pinned_bytes"),
    (CUDA, CPU, False, "p64.copy.d2h.pageable_bytes"),
    (CUDA, CPU, True, "p64.copy.d2h.pinned_bytes"),
    (CPU, CPU, False, None),
    (CUDA, CUDA, False, None),
    (torch.device("cuda", 0), torch.device("cuda", 1), False, None),
])
def test_copy_counter_rule(src, dst, pinned, want):
    assert trace.copy_counter(src, dst, pinned) == want


def test_count_copy_counts_only_while_tracing():
    host = torch.zeros(8, dtype=torch.uint8)
    counted = trace.counters()
    trace.count_copy(host, CUDA, host.nbytes)      # off: nothing
    trace.count("p64.test.count", 3)
    assert trace.counters() == counted
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count_copy(host, CUDA, host.nbytes)
        trace.count_copy(np.zeros(4, np.uint8), CUDA, 4)
        trace.count_copy(host, CPU, host.nbytes)   # stays on the host
        trace.count("p64.test.count", 3)
    got = trace.counters()
    assert got["p64.copy.h2d.pageable_bytes"] - counted.get(
        "p64.copy.h2d.pageable_bytes", 0) == 12
    assert got["p64.test.count"] - counted.get("p64.test.count", 0) == 3


def _span(name, start, end, thread=1, id=0, parent=None, root=0):
    return trace.Span(name, int(start), int(end), thread, id, parent, root)


def test_summarize_self_time():
    records = [_span("p64.a", 0, 100, id=1, root=1),
               _span("p64.b", 10, 40, id=2, parent=1, root=1),
               _span("p64.b", 30, 60, id=3, parent=1, root=1),
               _span("p64.c", 20, 30, id=4, parent=2, root=1)]
    assert trace.summarize(records) == [("p64.a", 1, 100, 50),
                                        ("p64.b", 2, 60, 50),
                                        ("p64.c", 1, 10, 10)]


def test_profile_tool_prints_spans_and_counters(tmp_path, capsys):
    assert profile_tool.main(["--device", "cpu", "--streams", "2",
                              "--frames", "2", "--format", "QCIF",
                              "--trace-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    rows = {line.split()[0]: line.split()[1:] for line in out.splitlines()
            if line.startswith("p64.")}
    assert rows["p64.encode.job"][0] == "1"
    assert rows["p64.fan.serialize"][0] == "1"
    assert rows["p64.encode.macroblocks"] == [str(2 * 2 * QCIF.num_mbs)]


# ---------------------------------------------------------------------------
# the benchmark's readers, on synthetic traces and span logs
# ---------------------------------------------------------------------------

MS = 1_000_000
CALLER, WORKER = 11, 22


def _events(launches, extra_kernels=()):
    """A window of 10 ms; one replay of one kernel per (launch, start ms,
    end ms); more kernels outside any replay."""
    ev = [tracing.Event(tracing.WINDOW, "annotation", 0, 10 * MS)]
    for corr, (at, s, e) in enumerate(launches, 1):
        ev.append(tracing.Event("cudaGraphLaunch", "runtime", int(at * MS),
                                int(at * MS) + 5_000, corr))
        ev.append(tracing.Event("step_kernel", "kernel", int(s * MS),
                                int(e * MS), corr))
    for s, e in extra_kernels:
        ev.append(tracing.Event("other_kernel", "kernel", int(s * MS),
                                int(e * MS), 999))
    return ev


def _reading(events, launches):
    return harness.Reading(tracing.read_trace(events, launches), {}, {}, {})


def _log(rows):
    """Span records from (name, start ms, end ms, thread)."""
    return [_span(n, s * MS, e * MS, thread=t, id=i)
            for i, (n, s, e, t) in enumerate(rows, 1)]


ENCODE_LOG = [
    ("p64.encode.frames_in", 1.0, 1.2, CALLER),
    ("p64.encode.wait", 2.0, 2.1, CALLER),
    ("p64.encode.symbols", 2.1, 2.6, CALLER),
    ("p64.fan.serialize", 2.6, 3.6, CALLER),
    ("p64.encode.job", 1.0, 4.0, CALLER),
    ("p64.encode.frames_in", 5.0, 5.2, CALLER),
    ("p64.encode.wait", 6.0, 6.1, CALLER),
    ("p64.encode.symbols", 6.1, 6.6, CALLER),
    ("p64.fan.serialize", 6.6, 7.6, CALLER),
    ("p64.encode.job", 5.0, 8.0, CALLER),
    # another thread's spans and spans outside the window do not count
    ("p64.encode.symbols", 2.0, 3.0, WORKER),
    ("p64.encode.symbols", 11.0, 12.0, CALLER),
    ("p64.encode.job", 11.0, 12.5, CALLER),
]
ENCODE_COUNTERS = {"p64.copy.h2d.pageable_bytes": 1000,
                   "p64.copy.d2h.pinned_bytes": 600,
                   "p64.pinned.alloc_bytes": 600,
                   "p64.encode.macroblocks": 2}
DECODE_LOG = [
    ("p64.fan.parse_to_tensors", 1.0, 1.5, CALLER),
    ("p64.decode.stack", 1.5, 1.8, CALLER),
    ("p64.graphs.replays", 1.8, 1.9, CALLER),
    ("p64.decode.wait", 1.9, 2.2, CALLER),
    ("p64.decode.planes_out", 2.2, 2.6, CALLER),
    ("p64.fan.parse_to_tensors", 5.0, 5.7, CALLER),
    ("p64.decode.stack", 5.7, 6.0, CALLER),
    ("p64.graphs.replays", 6.0, 6.1, CALLER),
    ("p64.decode.wait", 6.1, 6.2, CALLER),
    ("p64.decode.planes_out", 6.2, 6.4, CALLER),
    ("p64.decode.stack", 1.0, 1.9, WORKER),
]
DECODE_COUNTERS = {"p64.copy.h2d.pageable_bytes": 900,
                   "p64.copy.d2h.pageable_bytes": 700,
                   "p64.decode.macroblocks": 4,
                   "p64.decode.packed_mbs": 4}
# encode: replays at 1.3-2.0 and 5.3-6.0 ms, one more kernel at 3.0-3.2 ms;
# idle under symbols and serialize: 2.1-3.0, 3.2-3.6 and 6.1-7.6 ms
ENCODE_TRACE = ([(1.25, 1.3, 2.0), (5.25, 5.3, 6.0)], [(3.0, 3.2)])
# decode: replays at 1.8-2.1 and 6.0-6.2 ms, a copy-like kernel 2.2-2.5;
# idle under parse and stack: 1.0-1.8 and 5.0-6.0 ms
DECODE_TRACE = ([(1.8, 1.8, 2.1), (6.0, 6.0, 6.2)], [(2.2, 2.5)])

READERS = [
    ("frames_in_ms.encode", ENCODE_LOG, ENCODE_COUNTERS, ENCODE_TRACE, 0.2),
    ("host_wait_ms.encode", ENCODE_LOG, ENCODE_COUNTERS, ENCODE_TRACE, 0.1),
    ("symbols_ms.encode", ENCODE_LOG, ENCODE_COUNTERS, ENCODE_TRACE, 0.5),
    ("serialize_ms.encode", ENCODE_LOG, ENCODE_COUNTERS, ENCODE_TRACE, 1.0),
    ("finalize_idle_pct.encode", ENCODE_LOG, ENCODE_COUNTERS, ENCODE_TRACE,
     100 * (0.9 + 0.4 + 1.5) / 10),
    ("host_card_bytes_per_mb.encode", ENCODE_LOG, ENCODE_COUNTERS,
     ENCODE_TRACE, 800.0),
    ("native_parse_ms.decode", DECODE_LOG, DECODE_COUNTERS, DECODE_TRACE,
     0.6),
    ("stack_ms.decode", DECODE_LOG, DECODE_COUNTERS, DECODE_TRACE, 0.3),
    ("host_wait_ms.decode", DECODE_LOG, DECODE_COUNTERS, DECODE_TRACE, 0.2),
    ("planes_out_ms.decode", DECODE_LOG, DECODE_COUNTERS, DECODE_TRACE,
     0.3),
    ("parse_idle_pct.decode", DECODE_LOG, DECODE_COUNTERS, DECODE_TRACE,
     100 * (0.8 + 1.0) / 10),
    ("host_card_bytes_per_mb.decode", DECODE_LOG, DECODE_COUNTERS,
     DECODE_TRACE, 400.0),
    ("packed_mb_share.decode", DECODE_LOG, DECODE_COUNTERS, DECODE_TRACE,
     1.0),
    ("planes_pinned_share.decode", DECODE_LOG, DECODE_COUNTERS,
     DECODE_TRACE, 0.0),
]


def _program(monkeypatch, log, counters):
    monkeypatch.setattr(trace, "spans", lambda: list(log))
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))


@pytest.mark.parametrize("name,rows,counters,tr,want", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_reads_the_hand_computed_value(monkeypatch, name, rows,
                                              counters, tr, want):
    launches, extra = tr
    _program(monkeypatch, _log(rows), counters)
    reading = _reading(_events(launches, extra), len(launches))
    assert reading.trace.whole
    got = harness.Manifest().reader(name)(reading)
    assert got == pytest.approx(want, rel=1e-9)


JOBS = {"p64.encode.job", "p64.fan.parse_to_tensors"}
#: readers whose stage spans are not the job spans
STAGE_READERS = {"frames_in_ms.encode", "host_wait_ms.encode",
                 "symbols_ms.encode", "serialize_ms.encode",
                 "finalize_idle_pct.encode", "stack_ms.decode",
                 "host_wait_ms.decode", "planes_out_ms.decode"}


@pytest.mark.parametrize("name,rows,counters,tr,want", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_reads_none_without_its_spans(monkeypatch, name, rows,
                                             counters, tr, want):
    launches, extra = tr
    read = harness.Manifest().reader(name)
    reading = _reading(_events(launches, extra), len(launches))
    # no span log at all, as in a program without the trace module
    monkeypatch.delattr(sys.modules["p64tpu_torch"], "trace")
    monkeypatch.setitem(sys.modules, "p64tpu_torch.trace", None)
    assert read(reading) is None
    monkeypatch.undo()
    # the log holds no span of the cell
    _program(monkeypatch, [], counters)
    assert read(reading) is None
    # the job spans alone, without the stage's own
    if name in STAGE_READERS:
        _program(monkeypatch, _log([r for r in rows if r[0] in JOBS]),
                 counters)
        assert read(reading) is None
    # a trace that is not whole (one replay short)
    _program(monkeypatch, _log(rows), counters)
    assert read(_reading(_events(launches, extra),
                         len(launches) + 1)) is None


@pytest.mark.parametrize("drop", ["p64.decode.packed_mbs",
                                  "p64.decode.macroblocks"])
def test_packed_share_reads_none_without_its_counters(monkeypatch, drop):
    """A program without the packed-levels counter (the parent of the
    change that added it) or without decoded macroblocks reads nothing."""
    counters = {k: v for k, v in DECODE_COUNTERS.items() if k != drop}
    _program(monkeypatch, _log(DECODE_LOG), counters)
    launches, extra = DECODE_TRACE
    read = harness.Manifest().reader("packed_mb_share.decode")
    assert read(_reading(_events(launches, extra), len(launches))) is None


@pytest.mark.parametrize("pinned,pageable,want", [
    (700, 0, 1.0), (300, 100, 0.75), (0, 0, None), (None, None, None)])
def test_pinned_share_reads_the_copies_back(monkeypatch, pinned, pageable,
                                            want):
    """The planes out's share of pinned bytes; nothing where no byte
    crossed back, as in a decode on the CPU.  The copies to the card do
    not count."""
    counters = {k: v for k, v in DECODE_COUNTERS.items()
                if not k.startswith("p64.copy.d2h.")}
    if pinned is not None:
        counters.update({"p64.copy.d2h.pinned_bytes": pinned,
                         "p64.copy.d2h.pageable_bytes": pageable})
    _program(monkeypatch, _log(DECODE_LOG), counters)
    launches, extra = DECODE_TRACE
    read = harness.Manifest().reader("planes_pinned_share.decode")
    got = read(_reading(_events(launches, extra), len(launches)))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("cell", ["encode", "decode"])
def test_byte_readers_need_their_macroblocks(monkeypatch, cell):
    rows, counters, (launches, extra) = (
        (ENCODE_LOG, ENCODE_COUNTERS, ENCODE_TRACE) if cell == "encode"
        else (DECODE_LOG, DECODE_COUNTERS, DECODE_TRACE))
    counters = {k: v for k, v in counters.items()
                if not k.endswith("macroblocks")}
    _program(monkeypatch, _log(rows), counters)
    read = harness.Manifest().reader(f"host_card_bytes_per_mb.{cell}")
    assert read(_reading(_events(launches, extra), len(launches))) is None


def test_idle_by_innermost_span():
    log = _log(ENCODE_LOG)
    caller = [r for r in log if r.thread == CALLER and r.end_ns <= 10 * MS]
    launches, extra = ENCODE_TRACE
    got = spanlog.idle_by_span(_events(launches, extra), caller, 0,
                               10 * MS)
    want = {"p64.encode.job": 0.1 + 0.4 + 0.1 + 0.4,
            "p64.encode.frames_in": 0.2 + 0.2,
            "p64.encode.wait": 0.1 + 0.1, "p64.encode.symbols": 0.5 + 0.5,
            "p64.fan.serialize": 0.8 + 1.0, "none": 1.0 + 1.0 + 2.0}
    assert {k: v / MS for k, v in got.items()} == pytest.approx(want)
