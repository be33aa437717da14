"""Share of the traced window in which no kernel, copy or set ran on the
card (a whole trace only)."""


def read(reading):
    return reading.trace.idle_pct
