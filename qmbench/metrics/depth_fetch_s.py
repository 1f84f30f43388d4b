"""Seconds of finish() spent fetching the slot-space depth from the card
(`counter.depth_fetch`): the program's phase_depth_fetch_s, its change
over the window."""

UNIT = "s"
LAYER = "finish: depth fetch"
SOURCE = "program_span"
MOVES = "count_kmers_per_s"


def read(run):
    return run.counter_delta("phase_depth_fetch_s")
