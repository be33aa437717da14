"""Share of the traced window in which the card is idle while the caller
thread is inside `p64.fan.parse_to_tensors` or `p64.decode.stack`: the idle
time the host parse and stack hold (port span log and trace, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.idle_pct(reading, "p64.fan.parse_to_tensors",
                            ("p64.fan.parse_to_tensors", "p64.decode.stack"))
