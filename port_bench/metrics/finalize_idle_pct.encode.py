"""Share of the traced window in which the card is idle while the caller
thread is inside `p64.encode.symbols` or `p64.fan.serialize`: the idle time
the host finalize holds (port span log and trace, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.idle_pct(reading, "p64.encode.job",
                            ("p64.encode.symbols", "p64.fan.serialize"))
