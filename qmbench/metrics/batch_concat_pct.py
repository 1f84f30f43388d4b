"""Share of the window the flat counter spent joining its carry and
pending codes into batches (`counter.concat`): the program's
phase_concat_s, its change over the window."""

UNIT = "%"
LAYER = "counter batching"
SOURCE = "program_span"
MOVES = "count_kmers_per_s"


def read(run):
    s = run.counter_delta("phase_concat_s")
    return None if s is None else 100.0 * s / run.window_s
