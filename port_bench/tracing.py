"""Reading a torch.profiler trace of the benchmark's traced window, and the
SAD search's work count.

The trace is turned into plain `Event` records first, so that everything
below runs on synthetic events in the CPU tests.  Rules:

  * the window is the span of the `WINDOW` annotation the harness wraps
    the traced jobs in; busy time is the union of every kernel, copy and
    set on the card inside it, and the idle share is the rest;
  * a graph replay is a `cudaGraphLaunch`; each kernel it runs carries the
    launch's correlation id.  `torch.profiler` can lose kernel records
    under host load, so a trace is whole only when it holds every replay
    the jobs made and the same number of kernels in each, or, where a job
    replays programs of several sizes (a decode job's groups), the first
    job's numbers replay by replay in every job; a trace that is not whole
    is taken again, not read;
  * an idle gap is named by the host event that covered its midpoint,
    the innermost one (a runtime call or an operator), or "none" where the
    host was running Python outside any operator.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the annotation around the traced jobs
WINDOW = "port_bench.window"
#: device event kinds: all count as busy
DEVICE_KINDS = ("kernel", "memcpy", "memset")
#: host event kinds that can name an idle gap
HOST_KINDS = ("runtime", "cpu_op")
#: gaps shorter than this are summed under one name, not named one by one
SHORT_GAP_NS = 20_000
SHORT_GAP_NAME = "between kernels (<20 us)"
#: entries of each breakdown list
BREAKDOWN_ENTRIES = 10

# Hopper's integer lanes (whitepaper): 4 byte abs-diffs per VABSDIFF4, 64
# integer lanes per SM; HBM3 at 3.35 TB/s (data sheet, H100 SXM)
ABSDIFFS_PER_LANE, INT_LANES_PER_SM = 4, 64
MEMORY_BYTES_PER_S = 3.35e12
MB_SIZE = 16


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str           # DEVICE_KINDS, HOST_KINDS, "annotation" or "other"
    start: int          # ns
    end: int            # ns
    corr: int = 0       # correlation id (runtime calls and device events)


def _kind(e) -> str:
    activity = e.activity_type() if hasattr(e, "activity_type") else ""
    name = e.name()
    if "user_annotation" in activity or name == WINDOW:
        return "annotation"
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy") or activity == "gpu_memcpy":
            return "memcpy"
        if name.startswith("Memset") or activity == "gpu_memset":
            return "memset"
        return "kernel"
    if activity in ("cuda_runtime", "cuda_driver") or name.startswith(
            ("cuda", "cu")) and not name.startswith("cudnn"):
        return "runtime"
    if activity == "cpu_op" or "::" in name:
        return "cpu_op"
    return "other"


def events_from_profiler(prof) -> List[Event]:
    """The records of a finished torch.profiler run."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Event(e.name(), _kind(e), start,
                         start + e.duration_ns(), e.correlation_id()))
    return out


def window_bounds(events: Sequence[Event]) -> Optional[Tuple[int, int]]:
    spans = [(e.start, e.end) for e in events if e.name == WINDOW]
    if not spans:
        return None
    return min(s for s, _ in spans), max(e for _, e in spans)


def merge(intervals) -> List[Tuple[int, int]]:
    """Union of (start, end) intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_intervals(events: Sequence[Event], lo: int,
                   hi: int) -> List[Tuple[int, int]]:
    """The card's busy intervals, clipped to [lo, hi]."""
    return merge((max(e.start, lo), min(e.end, hi)) for e in events
                 if e.kind in DEVICE_KINDS and e.end > lo and e.start < hi)


def idle_gaps(busy: Sequence[Tuple[int, int]], lo: int,
              hi: int) -> List[Tuple[int, int]]:
    """The complement of `busy` inside [lo, hi]."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


@dataclasses.dataclass
class Replay:
    kernels: int
    start: int          # first kernel start, ns
    end: int            # last kernel end, ns


def replays(events: Sequence[Event],
            launch: str = "cudaGraphLaunch") -> List[Replay]:
    """Per graph launch, in launch order: its kernels' count and span."""
    order = sorted((e.start, e.corr) for e in events
                   if e.kind == "runtime" and launch in e.name)
    per: Dict[int, List[Event]] = collections.defaultdict(list)
    for e in events:
        if e.kind == "kernel":
            per[e.corr].append(e)
    out = []
    for _, corr in order:
        ks = per.get(corr, [])
        out.append(Replay(len(ks), min((k.start for k in ks), default=0),
                          max((k.end for k in ks), default=0)))
    return out


def is_whole(reps: Sequence[Replay], expected: int, jobs: int = 1) -> bool:
    """Every replay the `jobs` jobs made, each with the same kernel count,
    or each with the count of the same replay of the first job."""
    counts = [r.kernels for r in reps]
    if not counts or len(counts) != expected or 0 in counts:
        return False
    if len(set(counts)) == 1:
        return True
    if jobs < 2 or expected % jobs:
        return False
    per = expected // jobs
    return all(counts[i:i + per] == counts[:per]
               for i in range(per, expected, per))


def kernel_mean_ns(events: Sequence[Event], name: str) -> Optional[float]:
    """Mean duration of the kernels whose name holds `name`."""
    durs = [e.end - e.start for e in events
            if e.kind == "kernel" and name in e.name]
    return float(np.mean(durs)) if durs else None


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def name_gaps(events: Sequence[Event], gaps) -> Dict[str, int]:
    """Idle ns by the host event that covered each gap's midpoint."""
    host = sorted((e for e in events if e.kind in HOST_KINDS),
                  key=lambda e: e.start)
    starts = [e.start for e in host]
    out: Dict[str, int] = collections.Counter()
    for s, e in gaps:
        if e - s < SHORT_GAP_NS:
            out[SHORT_GAP_NAME] += e - s
            continue
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "none"
        for j in range(i, max(i - 256, -1), -1):
            if host[j].end > mid:           # latest start covering mid
                name = _short(host[j].name)
                break
        out[name] += e - s
    return out


@dataclasses.dataclass
class Trace:
    """What a traced window shows; `None` fields had nothing to read."""

    events: List[Event]
    window_ns: int
    busy_ns: int
    replays: List[Replay]
    whole: bool
    breakdown: dict

    @property
    def idle_pct(self) -> Optional[float]:
        if not self.whole or self.window_ns <= 0:
            return None
        return 100.0 * (1.0 - self.busy_ns / self.window_ns)

    @property
    def replay_ms(self) -> Optional[float]:
        if not self.whole:
            return None
        return float(np.mean([r.end - r.start for r in self.replays])) / 1e6

    def kernel_ms(self, name: str) -> Optional[float]:
        if not self.whole:
            return None
        ns = kernel_mean_ns(self.events, name)
        return None if ns is None else ns / 1e6


def read_trace(events: List[Event], expected_replays: int,
               jobs: int = 1) -> Trace:
    bounds = window_bounds(events)
    if bounds is None:
        lo = min((e.start for e in events), default=0)
        hi = max((e.end for e in events), default=0)
    else:
        lo, hi = bounds
    busy = busy_intervals(events, lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    reps = replays(events)
    ops: Dict[str, int] = collections.Counter()
    for e in events:
        if e.kind in DEVICE_KINDS and e.end > lo and e.start < hi:
            ops[_short(e.name)] += e.end - e.start
    gaps = name_gaps(events, idle_gaps(busy, lo, hi))
    breakdown = {
        "device_ops": [[n, ns / 1e9] for n, ns in
                       ops.most_common(BREAKDOWN_ENTRIES)],
        "idle_gaps": [[n, ns / 1e9] for n, ns in
                      gaps.most_common(BREAKDOWN_ENTRIES)],
    }
    return Trace(events, hi - lo, busy_ns, reps,
                 is_whole(reps, expected_replays, jobs), breakdown)


# ---------------------------------------------------------------------------
# the SAD search's work (copy of chip_smoke.py::sad_bound)
# ---------------------------------------------------------------------------


def sad_absdiffs(streams: int, height: int, width: int, search: int) -> int:
    """Byte abs-diffs of every (offset, MB) pair whose 16x16 window lies
    inside the picture."""
    d = np.arange(-search, search + 1)
    rows = sum(int(((y0 + d >= 0) & (y0 + d + MB_SIZE <= height)).sum())
               for y0 in range(0, height, MB_SIZE))
    cols = sum(int(((x0 + d >= 0) & (x0 + d + MB_SIZE <= width)).sum())
               for x0 in range(0, width, MB_SIZE))
    return streams * rows * cols * MB_SIZE * MB_SIZE


def sad_bound_ms(streams: int, height: int, width: int, search: int,
                 sms: int, clock_hz: float) -> Tuple[float, str]:
    """The least time the card could take for one search launch: the
    abs-diffs at 4 per VABSDIFF4 on every integer lane of every SM at the
    highest clock, against both planes read once and (mv, best SAD, SAD at
    zero) written once.  Returns (ms, "operations" or "bytes")."""
    ops_ms = (sad_absdiffs(streams, height, width, search)
              / (ABSDIFFS_PER_LANE * INT_LANES_PER_SM * sms * clock_hz)
              * 1e3)
    n_mb = (height // MB_SIZE) * (width // MB_SIZE)
    nbytes = 2 * streams * height * width + 16 * streams * n_mb
    bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")
