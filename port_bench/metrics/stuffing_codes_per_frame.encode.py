"""MBA stuffing codes per stream and frame: the port counter
`p64.rate.stuffing_codes` (the sum of `n_stuff`) over
`p64.serialize.streams` times the frames of a stream (port counters,
spanlog).  The bytes fix it: every stream's bytes are held to the
reference's, so no change to the program can move it.  It witnesses how
much of the channel the minimum-rate fill pads rather than the content
fills: a few a frame where the buffer law regulates, near 900 in the
low-texture p = 16 cell."""

from port_bench import spanlog

COUNTER = "p64.rate.stuffing_codes"


def read(reading):
    if spanlog.window_spans(reading, "p64.encode.job") is None:
        return None
    _, counters = spanlog.program_log()
    streams = counters.get("p64.serialize.streams", 0)
    if COUNTER not in counters or not streams:
        return None
    return counters[COUNTER] / (streams * reading.shapes["frames"])
