"""Seconds of StreamCounter.finish() at the window's end (the last batch,
the masks still to drain and their recount, the depth's fetch): the
benchmark's span."""

UNIT = "s"
LAYER = "finish"
SOURCE = "program_span"
MOVES = "count_kmers_per_s"


def read(run):
    return run.spans.get("finish")
