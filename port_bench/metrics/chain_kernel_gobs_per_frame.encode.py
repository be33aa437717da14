"""GOBs per stream and frame whose rate-control chain ran as the chain's
kernels: the port counter `p64.rate.chain_kernel_gobs` (the (stream, GOB)
pairs of every replay of a captured step whose chain is the kernels, added
by the host per replay) over `p64.serialize.streams` times the frames of a
stream (port counters, spanlog).  It reads the GOBs a picture has (12 at
CIF) where every encoded frame went through the kernels, and nothing on a
program without the counter.  It witnesses that the mechanism engaged."""

from port_bench import spanlog

COUNTER = "p64.rate.chain_kernel_gobs"


def read(reading):
    if spanlog.window_spans(reading, "p64.encode.job") is None:
        return None
    _, counters = spanlog.program_log()
    streams = counters.get("p64.serialize.streams", 0)
    if COUNTER not in counters or not streams:
        return None
    return counters[COUNTER] / (streams * reading.shapes["frames"])
