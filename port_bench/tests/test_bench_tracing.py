"""The trace reader on synthetic profiler events, and the SAD search's
work count."""

import pytest
import torch

from port_bench import harness, tracing
from port_bench.tracing import Event

US = 1000


def replay(corr, t0, kernels, each=10 * US, gap=2 * US, sad=None):
    """A cudaGraphLaunch at t0 and its kernels back to back after it."""
    evs = [Event("cudaGraphLaunch", "runtime", t0, t0 + 5 * US, corr)]
    t = t0 + 5 * US
    for k in range(kernels):
        name = sad if (sad and k == 1) else f"kernel_{k}"
        evs.append(Event(name, "kernel", t, t + each, corr))
        t += each + gap
    return evs


def window(t0, t1):
    return [Event(tracing.WINDOW, "annotation", t0, t1)]


def test_idle_busy_and_replays_of_a_whole_trace():
    evs = window(0, 1000 * US)
    evs += replay(1, 100 * US, 3)           # kernels 105..139 us
    evs += replay(2, 500 * US, 3)           # kernels 505..539 us
    evs += [Event("aten::copy_", "cpu_op", 300 * US, 450 * US, 7),
            Event("Memcpy DtoH (Device -> Pinned)", "memcpy", 310 * US,
                  330 * US, 9)]
    tr = tracing.read_trace(evs, expected_replays=2)
    assert tr.whole
    assert tr.window_ns == 1000 * US
    assert tr.busy_ns == 2 * 30 * US + 20 * US
    assert tr.idle_pct == pytest.approx(100 * (1 - 80 / 1000))
    assert tr.replay_ms == pytest.approx(0.034)
    names = dict(tr.breakdown["idle_gaps"])
    # the gap 330..505 us has its midpoint inside the copy
    assert names["aten::copy_"] == pytest.approx(175e-6)
    assert names["none"] == pytest.approx((105 + 171 + 461) * 1e-6)
    assert names[tracing.SHORT_GAP_NAME] == pytest.approx(4 * 2e-6)
    assert dict(tr.breakdown["device_ops"])["kernel_0"] == pytest.approx(
        20e-6)


def test_a_trace_that_lost_a_kernel_is_not_read():
    evs = window(0, 1000 * US) + replay(1, 0, 3) + replay(2, 500 * US, 2)
    tr = tracing.read_trace(evs, expected_replays=2)
    assert not tr.whole
    assert tr.idle_pct is None and tr.replay_ms is None
    assert tr.kernel_ms("kernel_0") is None
    # nor one that lost a launch
    evs = window(0, 1000 * US) + replay(1, 0, 3)
    assert not tracing.read_trace(evs, expected_replays=2).whole


def test_jobs_of_programs_of_several_sizes_are_whole_job_by_job():
    """A decode job replays one program per group size, whose kernel
    counts may differ: each job has to repeat the first's."""
    def trace(counts):
        evs = window(0, 10_000 * US)
        for i, k in enumerate(counts):
            evs += replay(i + 1, i * 1000 * US, k)
        return evs
    assert tracing.read_trace(trace([3, 2, 3, 2]), 4, jobs=2).whole
    assert tracing.read_trace(trace([3, 2, 2, 3, 2, 2]), 6, jobs=2).whole
    # one job alone cannot tell a lost kernel from a program's count
    assert not tracing.read_trace(trace([3, 2, 3, 2]), 4).whole
    # a kernel lost in the second job, a launch lost, jobs cut unevenly
    assert not tracing.read_trace(trace([3, 2, 3, 1]), 4, jobs=2).whole
    assert not tracing.read_trace(trace([3, 2, 3]), 4, jobs=2).whole
    assert not tracing.read_trace(trace([3, 2, 3]), 3, jobs=2).whole
    # and one program's replays stay whole as they were
    assert tracing.read_trace(trace([3, 3, 3]), 3, jobs=3).whole
    assert not tracing.read_trace(trace([3, 2, 3]), 3, jobs=3).whole


def test_graph_builds_per_job_reads_the_span_log(monkeypatch):
    from p64tpu_torch.trace import Span
    from port_bench import spanlog
    read = harness.Manifest().reader("graph_builds_per_job.decode")
    evs = window(0, 10_000 * US) + replay(1, 0, 3) + replay(2, 10 * US, 3)
    tr = tracing.read_trace(evs, expected_replays=2)
    job, build = "p64.fan.parse_to_tensors", "p64.graphs.build"
    spans = [Span(job, 100 * US, 200 * US, 1, 1, None, 1),
             Span(build, 300 * US, 400 * US, 1, 2, None, 2),
             Span(build, 450 * US, 500 * US, 1, 3, None, 3),
             Span(job, 600 * US, 700 * US, 1, 4, None, 4),
             Span(build, 800 * US, 900 * US, 2, 5, None, 5),
             Span(build, 20_000 * US, 20_100 * US, 1, 6, None, 6)]
    monkeypatch.setattr(spanlog, "program_log", lambda: (spans, {}))
    reading = harness.Reading(tr, {}, {}, {})
    # two builds on the jobs' thread inside the window, over two jobs
    assert read(reading) == 1.0
    monkeypatch.setattr(spanlog, "program_log", lambda: (spans[:1], {}))
    assert read(reading) == 0.0
    monkeypatch.setattr(spanlog, "program_log", lambda: (spans[1:3], {}))
    assert read(reading) is None


def test_gaps_are_named_by_the_innermost_host_event():
    evs = window(0, 100 * US) + [
        Event("aten::to", "cpu_op", 10 * US, 90 * US),
        Event("cudaHostAlloc", "runtime", 20 * US, 80 * US),
        Event("k", "kernel", 0, 10 * US, 1),
        Event("k", "kernel", 90 * US, 100 * US, 1)]
    tr = tracing.read_trace(evs, expected_replays=0)
    assert tr.breakdown["idle_gaps"] == [["cudaHostAlloc", 80e-6]]
    evs = window(0, 100 * US) + [Event("k", "kernel", 0, 10 * US, 1)]
    assert tracing.read_trace(evs, 0).breakdown["idle_gaps"] == [
        ["none", 90e-6]]


def test_sad_absdiff_counts():
    assert tracing.sad_absdiffs(128, 288, 352, 15) == 11_280_580_608
    assert tracing.sad_absdiffs(32, 288, 352, 15) == 2_820_145_152
    ms, by = tracing.sad_bound_ms(128, 288, 352, 15, 132, 1.98e9)
    assert by == "operations"
    assert ms == pytest.approx(11_280_580_608 / (4 * 64 * 132 * 1.98e9) * 1e3)


def test_roofline_reader_on_a_synthetic_trace():
    read = harness.Manifest().reader("sad_search_roofline")
    evs = window(0, 10_000 * US)
    for i in range(4):
        evs += replay(i + 1, i * 1000 * US, 3, each=100 * US,
                      sad="void sad_search_kernel<15>(...)")
    tr = tracing.read_trace(evs, expected_replays=4)
    shapes = dict(launch_streams=32, height=288, width=352, search=15)
    card = dict(sms=132, clock_hz=1.98e9)
    got = read(harness.Reading(tr, {}, shapes, card))
    bound, _ = tracing.sad_bound_ms(32, 288, 352, 15, 132, 1.98e9)
    assert got == pytest.approx(100 * bound / 0.1)
    assert read(harness.Reading(tr, {}, shapes,
                                dict(sms=132, clock_hz=None))) is None


@pytest.mark.cuda
def test_a_traced_graph_replay_is_whole_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.ones(1 << 20, device="cuda")
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        y = x * 2
        torch.cuda.synchronize()
        with torch.cuda.graph(g):
            y = x * 2 + 1
            y = y.sqrt()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.WINDOW):
            for _ in range(5):
                g.replay()
            torch.cuda.synchronize()
    tr = tracing.read_trace(tracing.events_from_profiler(prof), 5)
    assert tr.whole and tr.busy_ns > 0 and 0 <= tr.idle_pct < 100
    assert float(y[0]) == pytest.approx(3 ** 0.5)
