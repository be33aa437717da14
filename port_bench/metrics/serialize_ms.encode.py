"""Host ms per encode job in `p64.fan.serialize`: the native serialize fanned
over threads (port span log, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.per_job_ms(reading, "p64.encode.job", "p64.fan.serialize")
