"""Host ms per encode job in `p64.encode.symbols`: `outputs_to_symbols`'
per-stream Python loop (port span log, spanlog)."""

from port_bench import spanlog


def read(reading):
    return spanlog.per_job_ms(reading, "p64.encode.job",
                              "p64.encode.symbols")
