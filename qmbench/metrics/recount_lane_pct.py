"""Share of the batches' window lanes that K2 left unresolved and the
mono counter re-encoded on the host: the program's n_recount_lanes over
its total_windows, both their changes over the window."""

UNIT = "%"
LAYER = "mono host recount"
SOURCE = "program_counter"
MOVES = "count_kmers_per_s"


def read(run):
    lanes = run.counter_delta("n_recount_lanes")
    windows = run.counter_delta("total_windows")
    return None if lanes is None or not windows else 100.0 * lanes / windows
