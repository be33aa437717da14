"""Share of the input frames the buffer law coded: the port counter
`p64.rate.coded_frames` (the sum of `frame_coded`) over
`p64.serialize.streams` times the frames of a stream (port counters,
spanlog).  The bytes fix it: every stream's bytes are held to the
reference's, so no change to the program can move it.  It witnesses how
much of the frame step's work a cell keeps: 1.0 where no frame is
skipped, about half in the QCIF videophone at 128 kbit/s, where the step
still encodes every picture and the skip select drops the rest."""

from port_bench import spanlog

COUNTER = "p64.rate.coded_frames"


def read(reading):
    if spanlog.window_spans(reading, "p64.encode.job") is None:
        return None
    _, counters = spanlog.program_log()
    streams = counters.get("p64.serialize.streams", 0)
    if COUNTER not in counters or not streams:
        return None
    return counters[COUNTER] / (streams * reading.shapes["frames"])
