"""The SAD search kernel's (K2, `sad_search_kernel`) share of its bound:
the least time the card could take for one launch at the traced shapes
(`tracing.sad_bound_ms`: in-picture abs-diffs at 4 per VABSDIFF4 on 64
integer lanes per SM at the highest SM clock, a rate derived from the
Hopper whitepaper, not a data-sheet peak; against both planes read once
and the results written once), over the kernel's mean traced time."""

from port_bench import tracing


def read(reading):
    ms = reading.trace.kernel_ms("sad_search_kernel")
    if ms is None or not reading.card.get("clock_hz"):
        return None
    s = reading.shapes
    bound, _ = tracing.sad_bound_ms(s["launch_streams"], s["height"],
                                    s["width"], s["search"],
                                    reading.card["sms"],
                                    reading.card["clock_hz"])
    return 100.0 * bound / ms
