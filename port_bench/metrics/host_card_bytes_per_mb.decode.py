"""Bytes copied between host memory and the card per macroblock decoded: the
four `p64.copy.*` counters over `p64.decode.macroblocks` (port counters,
spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.bytes_per_mb(reading, "p64.fan.parse_to_tensors",
                                "p64.decode.macroblocks")
