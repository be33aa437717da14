"""Share of the reconstructed macroblocks that were padding: the port
counter `p64.decode.padded_mbs` (the macroblocks of the streams that
`core.decoder.decode_seq_batch` adds to round a batch up to one of the
sizes its programs are kept for) over those and `p64.decode.macroblocks`
(port counters, spanlog): the card's work spent on padding.  0.0 where
every batch's stream count is one of the sizes; nothing on a program
without the counter."""

from port_bench import spanlog

COUNTER = "p64.decode.padded_mbs"


def read(reading):
    if spanlog.window_spans(reading, "p64.fan.parse_to_tensors") is None:
        return None
    _, counters = spanlog.program_log()
    if COUNTER not in counters:
        return None
    total = counters.get("p64.decode.macroblocks", 0) + counters[COUNTER]
    return counters[COUNTER] / total if total else None
