"""Reading the port's own span log and counters (`p64tpu_torch.trace`) over
a traced window.

The port records a span at each boundary of its batch host path while a
torch profiler is active, stamped with `time.time_ns()`, the clock the
profiler stamps its events with.  The readers here take the log, not the
trace's annotation events: the log holds each span once, with its thread
and parent, where a trace with CUDA activity holds a second, device-side
copy of each range.

Rules:
  * the window is `tracing.window_bounds` of the trace; only spans that lie
    inside it, on the thread that ran the jobs (the thread of the job
    spans), count;
  * "per job" divides by the number of job spans inside the window;
  * a reading is None where the trace is not whole, the window or the
    spans are missing, or the program has no span log (a program before
    `p64tpu_torch.trace`).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

from port_bench import tracing

#: the counters of copies between host and card
COPY_COUNTERS = tuple(f"p64.copy.{way}.{kind}_bytes"
                      for way in ("h2d", "d2h")
                      for kind in ("pageable", "pinned"))


def program_log():
    """(spans, counters) of the port's trace module, or None where the
    program has none."""
    try:
        from p64tpu_torch import trace
    except ImportError:
        return None
    return trace.spans(), trace.counters()


def window_spans(reading, job: str) -> Optional[Tuple[list, int, int, int]]:
    """(the caller thread's spans inside the window, the number of `job`
    spans there, window start, window end), or None."""
    got = program_log()
    if got is None or not reading.trace.whole:
        return None
    bounds = tracing.window_bounds(reading.trace.events)
    if bounds is None:
        return None
    lo, hi = bounds
    inside = [r for r in got[0] if r.start_ns >= lo and r.end_ns <= hi]
    threads = {r.thread for r in inside if r.name == job}
    if not threads:
        return None
    caller = [r for r in inside if r.thread in threads]
    return caller, sum(r.name == job for r in caller), lo, hi


def per_job_ms(reading, job: str, stage: str) -> Optional[float]:
    """Host ms per job inside the `stage` spans."""
    got = window_spans(reading, job)
    if got is None:
        return None
    caller, jobs, _, _ = got
    ns = [r.end_ns - r.start_ns for r in caller if r.name == stage]
    return sum(ns) / jobs / 1e6 if ns else None


def intersect(a: Sequence[Tuple[int, int]],
              b: Sequence[Tuple[int, int]]) -> int:
    """ns that two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(reading, job: str, stages: Sequence[str]) -> Optional[float]:
    """Share of the window in which the card is idle and the caller thread
    is inside one of the `stages` spans."""
    got = window_spans(reading, job)
    if got is None:
        return None
    caller, _, lo, hi = got
    held = tracing.merge((r.start_ns, r.end_ns) for r in caller
                         if r.name in stages)
    if not held or hi <= lo:
        return None
    events = reading.trace.events
    gaps = tracing.idle_gaps(tracing.busy_intervals(events, lo, hi), lo, hi)
    return 100.0 * intersect(gaps, held) / (hi - lo)


def bytes_per_mb(reading, job: str, macroblocks: str) -> Optional[float]:
    """Bytes copied between host and card per macroblock, over the traced
    jobs (the counters of every traced job of the process)."""
    if window_spans(reading, job) is None:
        return None
    _, counters = program_log()
    mbs = counters.get(macroblocks, 0)
    if not mbs:
        return None
    return sum(counters.get(c, 0) for c in COPY_COUNTERS) / mbs


def innermost(records: Sequence) -> List[Tuple[int, int, str]]:
    """(start, end, name) pieces of time, each under one innermost span of
    `records` (spans of one thread, which nest)."""
    points = sorted([(r.start_ns, 1, -r.end_ns, i) for i, r in
                     enumerate(records)]
                    + [(r.end_ns, 0, 0, i) for i, r in enumerate(records)])
    open_, out, t = [], [], None
    for at, starts, _, i in points:
        if open_ and t is not None and at > t:
            out.append((t, at, records[open_[-1]].name))
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        t = at
    return out


def idle_by_span(events, records, lo: int, hi: int) -> Dict[str, int]:
    """Idle ns of the card inside [lo, hi] by the innermost span of
    `records` over it ("none" where no span is open)."""
    gaps = tracing.idle_gaps(tracing.busy_intervals(events, lo, hi), lo, hi)
    out: Dict[str, int] = collections.Counter()
    pieces = innermost(records)
    for name in {n for _, _, n in pieces}:
        out[name] = intersect(gaps, [(s, e) for s, e, n in pieces
                                     if n == name])
    out["none"] = sum(e - s for s, e in gaps) - sum(out.values())
    return out
