"""Share of the window the host spent in StreamCounter.feed_codes (the
counter's host side and the launches it makes), by the benchmark's span
around each call."""

UNIT = "%"
LAYER = "counter host side"
SOURCE = "program_span"
MOVES = "count_kmers_per_s"


def read(run):
    return 100.0 * run.spans.get("feed", 0.0) / run.window_s
