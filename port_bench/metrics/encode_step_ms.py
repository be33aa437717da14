"""Device ms of one replay of the captured encoder frame step, first kernel
start to last kernel end, the mean over the traced replays (a whole trace
only)."""


def read(reading):
    return reading.trace.replay_ms
