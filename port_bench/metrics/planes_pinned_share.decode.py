"""Share of the bytes copied from the card to host memory that landed in
pinned host memory: the port counter `p64.copy.d2h.pinned_bytes` over it
and `p64.copy.d2h.pageable_bytes` (port counters, spanlog), over the traced
decode jobs, whose copies back are the planes out.  It reads 1.0 where
every plane crossed into pinned blocks, 0.0 where every one crossed into
fresh pageable memory, and nothing without the job spans or with no bytes
copied back.  It witnesses where the planes out lands."""

from port_bench import spanlog

PINNED = "p64.copy.d2h.pinned_bytes"
PAGEABLE = "p64.copy.d2h.pageable_bytes"


def read(reading):
    if spanlog.window_spans(reading, "p64.fan.parse_to_tensors") is None:
        return None
    _, counters = spanlog.program_log()
    pinned = counters.get(PINNED, 0)
    total = pinned + counters.get(PAGEABLE, 0)
    if not total:
        return None
    return pinned / total
