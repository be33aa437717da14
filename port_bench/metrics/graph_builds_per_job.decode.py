"""Reconstruct programs captured per decode job: the `p64.graphs.build`
spans (`core/graphs.py`: a capture on a miss of the program cache, which
keeps `MAX_PROGRAMS` programs a card, one per group size) on the caller
thread, over the traced jobs (port span log, spanlog).  0 where every
group's program was captured before the window; a job whose groups need
more programs than the cache keeps captures some of them again."""

from port_bench import spanlog

JOB = "p64.fan.parse_to_tensors"


def read(reading):
    got = spanlog.window_spans(reading, JOB)
    if got is None:
        return None
    caller, jobs, _, _ = got
    return sum(r.name == "p64.graphs.build" for r in caller) / jobs
