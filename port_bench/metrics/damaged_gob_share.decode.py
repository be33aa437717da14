"""Share of the decoded GOBs that a damaged stream left damaged: the port
counter `p64.decode.damaged_gobs` (the GOBs whose parse the resync parse
gave up, from each parsed frame's damage word, counted by
`core.decoder.decode_seq_batch`) over `p64.decode.gobs` (every GOB of the
pictures it decoded; port counters, spanlog).  The bytes fix it: it
witnesses that the line damaged what the port decoded, and no program
change moves it.  Nothing on a program without the counters."""

from port_bench import spanlog

COUNTER = "p64.decode.damaged_gobs"


def read(reading):
    if spanlog.window_spans(reading, "p64.fan.parse_to_tensors") is None:
        return None
    _, counters = spanlog.program_log()
    gobs = counters.get("p64.decode.gobs", 0)
    if COUNTER not in counters or not gobs:
        return None
    return counters[COUNTER] / gobs
