"""Host ms per job of the fanned native parse plus the stack and copy of
every group to the card (BatchDecode.spans), the mean over the measured
jobs."""


def read(reading):
    spans = reading.spans.get("parse")
    return 1e3 * sum(spans) / len(spans) if spans else None
