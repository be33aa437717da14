"""Host ms per decode job in `p64.decode.wait`: the host waiting for the
reconstruct replays (port span log, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.per_job_ms(reading, "p64.fan.parse_to_tensors",
                              "p64.decode.wait")
