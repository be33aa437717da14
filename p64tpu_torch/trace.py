"""Spans and counters of the port's batch host path, on the profiler's clock.

Tracing is on exactly while a torch profiler is active
(`torch.autograd.profiler._is_profiler_enabled`): profile a run, with
`tools.profile` or `torch.profiler.profile`, and the port records its host
stages.  There is no other switch.  With tracing off a span site costs one
read of that flag and a counter site the same.

  * `span(name)` is a context manager.  On, it opens a profiler range
    named `name`, so the range is on the trace's timeline as a host
    operator, and on exit appends a `Span` to an in-memory log: the name,
    start and end from `time.time_ns()` (the clock the profiler stamps its
    host events with), the thread, the enclosing span on that thread and
    the outermost one, the root, which the spans of one job share.  The log
    keeps the last LOG_SIZE records.
  * `count(name, n)` adds n to a counter; `count_copy` counts the bytes of
    a copy that crosses between host and card, as pinned or pageable.

The range is a function-scope record (`_RecordFunctionFast`), not
`torch.profiler.record_function`'s user scope: with CUDA activity on, the
profiler gives a user-scope range a second, device-side copy over the
kernels it launched, which a trace read without activity types (torch
2.11's events have none) cannot tell from a kernel.

Spans and counters go on the calling thread only: a range opened on a
thread-pool worker is not in the trace, so `utils.fan_map` spans the whole
fan-out instead.  No span goes inside a captured step.  Names begin with
`p64.`; `spans()`, `counters()` and `summarize()` are for readers and
tools.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

#: records the span log keeps, the oldest dropped first
LOG_SIZE = 100_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    #: the enclosing span's id on the same thread, None for a root
    parent: Optional[int]
    #: the outermost enclosing span's id (its own for a root)
    root: int


_LOG: "collections.deque[Span]" = collections.deque(maxlen=LOG_SIZE)
_COUNTERS: Dict[str, int] = collections.Counter()
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_THREAD = threading.local()
_NOOP = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a torch profiler is active, which turns tracing on."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_THREAD, "stack", None)
    if stack is None:
        stack = _THREAD.stack = []
    return stack


class _Range:
    __slots__ = ("name", "range", "start", "id", "parent", "root")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.start = time.time_ns()
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        try:
            self.range.__exit__(*exc)
        finally:
            _stack().pop()
            _LOG.append(Span(self.name, self.start, end,
                             threading.get_ident(), self.id, self.parent,
                             self.root))
        return False


def span(name: str):
    """A context manager: a traced range named `name` while tracing is on,
    a shared no-op otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Range(name)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` while tracing is on."""
    if _autograd_profiler._is_profiler_enabled:
        with _LOCK:
            _COUNTERS[name] += int(n)


Side = Union[torch.Tensor, np.ndarray, torch.device]


def copy_counter(src: torch.device, dst: torch.device,
                 host_pinned: bool) -> Optional[str]:
    """The counter a copy from `src` to `dst` adds its bytes to: one that
    crosses between host and card, pinned when its host side is pinned,
    pageable otherwise; None for a copy that stays on one side."""
    if (src.type == "cuda") == (dst.type == "cuda"):
        return None
    way = "d2h" if src.type == "cuda" else "h2d"
    return f"p64.copy.{way}.{'pinned' if host_pinned else 'pageable'}_bytes"


def _device(x: Side) -> torch.device:
    if isinstance(x, torch.device):
        return x
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def count_copy(src: Side, dst: Side, nbytes: int) -> None:
    """Count a copy of nbytes from `src` to `dst` (copy_counter).  Each
    side is a tensor or array, or a device where the copy makes a fresh
    (pageable) buffer there."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    sdev, ddev = _device(src), _device(dst)
    host = dst if sdev.type == "cuda" else src
    name = copy_counter(sdev, ddev, isinstance(host, torch.Tensor)
                        and host.is_pinned())
    if name is not None:
        count(name, nbytes)


def spans() -> List[Span]:
    """A copy of the span log, in the order the spans ended."""
    return list(_LOG)


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    with _LOCK:
        return dict(_COUNTERS)


def summarize(records: Sequence[Span]) -> List[Tuple[str, int, int, int]]:
    """Per span name, in order of first start: (name, count, total ns,
    self ns), where a span's self time is its duration less the part of it
    its child spans cover."""
    children: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(
        list)
    for r in records:
        if r.parent is not None:
            children[r.parent].append((r.start_ns, r.end_ns))
    out: Dict[str, List[int]] = {}
    for r in sorted(records, key=lambda r: r.start_ns):
        covered, t = 0, r.start_ns
        for s, e in sorted(children.get(r.id, ())):
            s, e = max(s, t), min(e, r.end_ns)
            if e > s:
                covered += e - s
                t = e
        row = out.setdefault(r.name, [0, 0, 0])
        row[0] += 1
        row[1] += r.end_ns - r.start_ns
        row[2] += r.end_ns - r.start_ns - covered
    return [(name, c, total, own) for name, (c, total, own) in out.items()]
