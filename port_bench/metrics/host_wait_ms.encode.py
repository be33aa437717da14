"""Host ms per encode job in `p64.encode.wait`: the host waiting on the
card for the chunks' copies to pinned memory (port span log, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.per_job_ms(reading, "p64.encode.job", "p64.encode.wait")
