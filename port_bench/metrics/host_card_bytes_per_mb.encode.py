"""Bytes copied between host memory and the card per macroblock encoded: the
four `p64.copy.*` counters over `p64.encode.macroblocks` (port counters,
spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.bytes_per_mb(reading, "p64.encode.job",
                                "p64.encode.macroblocks")
