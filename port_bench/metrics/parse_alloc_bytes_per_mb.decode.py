"""Bytes of output buffers the native parse allocated per decoded
macroblock: the port counter `p64.parse.alloc_bytes` (every try's
buffers in `native.binding.NativeBitIO._raw_parse`, counted on the parse
threads) over `p64.decode.macroblocks` (port counters, spanlog).  The
engine writes every frame at the CIF stride of 396 MBs (410 bytes an MB
slot), so a parse whose buffers hold just its pictures reads about 410
B/MB at CIF and four times that at QCIF.  Nothing on a program without
the counter."""

from port_bench import spanlog

COUNTER = "p64.parse.alloc_bytes"


def read(reading):
    if spanlog.window_spans(reading, "p64.fan.parse_to_tensors") is None:
        return None
    _, counters = spanlog.program_log()
    mbs = counters.get("p64.decode.macroblocks", 0)
    if COUNTER not in counters or not mbs:
        return None
    return counters[COUNTER] / mbs
