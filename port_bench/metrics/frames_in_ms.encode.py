"""Host ms per encode job in `p64.encode.frames_in`: the chunks' states and
frames copied from host memory to the card (port span log, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.per_job_ms(reading, "p64.encode.job",
                              "p64.encode.frames_in")
