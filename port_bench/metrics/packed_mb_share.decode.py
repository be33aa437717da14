"""Share of the decoded macroblocks whose levels crossed to the card
packed: the port counter `p64.decode.packed_mbs` (the macroblocks of every
batch `core.decoder.stack_seqs` shipped as packed levels and expanded on
the card) over `p64.decode.macroblocks` (port counters, spanlog).  It reads
1.0 where every macroblock's levels crossed packed, and nothing on a
program without the counter.  It witnesses that the mechanism engaged."""

from port_bench import spanlog

COUNTER = "p64.decode.packed_mbs"


def read(reading):
    if spanlog.window_spans(reading, "p64.fan.parse_to_tensors") is None:
        return None
    _, counters = spanlog.program_log()
    mbs = counters.get("p64.decode.macroblocks", 0)
    if COUNTER not in counters or not mbs:
        return None
    return counters[COUNTER] / mbs
