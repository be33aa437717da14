"""Host ms per decode job in `p64.decode.stack`: the stack of every group's
parsed sequences and their copy to the card (port span log, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.per_job_ms(reading, "p64.fan.parse_to_tensors",
                              "p64.decode.stack")
