"""Seconds of finish() spent putting the mono counter's slot-space depth
in rank order on the host, side counts added (`counter.depth_rank`): the
program's phase_depth_rank_s, its change over the window."""

UNIT = "s"
LAYER = "finish: slot to rank on the host"
SOURCE = "program_span"
MOVES = "count_kmers_per_s"


def read(run):
    return run.counter_delta("phase_depth_rank_s")
