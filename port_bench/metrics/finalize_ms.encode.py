"""Host ms per job from the chunks' encoded outputs on the card to their
bytes: copies to pinned memory, the wait, outputs_to_symbols and the
native serialize (BatchEncode.spans), the mean over the measured jobs."""


def read(reading):
    spans = reading.spans.get("finalize")
    return 1e3 * sum(spans) / len(spans) if spans else None
