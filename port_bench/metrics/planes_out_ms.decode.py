"""Host ms per decode job in `p64.decode.planes_out`: the planes copied from
the card to host memory (port span log, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.per_job_ms(reading, "p64.fan.parse_to_tensors",
                              "p64.decode.planes_out")
