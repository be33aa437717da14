"""Host ms per decode job in `p64.fan.parse_to_tensors`: the native parse
fanned over threads (port span log, spanlog)."""

from port_bench import spanlog

JOB = "p64.fan.parse_to_tensors"


def read(reading):
    return spanlog.per_job_ms(reading, JOB, JOB)
