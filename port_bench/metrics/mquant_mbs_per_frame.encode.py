"""MBs written with an MQUANT MTYPE per stream and frame: the port counter
`p64.rate.mquant_mbs` over `p64.serialize.streams` times the frames of a
stream (port counters, spanlog).  The bytes fix it: every stream's bytes
are held to the reference's, so no change to the program can move it.  It
witnesses that the cell still runs the mid-GOB MQUANT rate control it is
for (0 where the rate control keeps one quantizer a GOB)."""

from port_bench import spanlog

COUNTER = "p64.rate.mquant_mbs"


def read(reading):
    if spanlog.window_spans(reading, "p64.encode.job") is None:
        return None
    _, counters = spanlog.program_log()
    streams = counters.get("p64.serialize.streams", 0)
    if COUNTER not in counters or not streams:
        return None
    return counters[COUNTER] / (streams * reading.shapes["frames"])
