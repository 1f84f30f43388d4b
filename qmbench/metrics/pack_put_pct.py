"""Share of the window the flat counter spent packing batches to 2 bits
and putting them on the card: the program's phase_pack_put_s, its
change over the window."""

UNIT = "%"
LAYER = "pack + H2D, flat"
SOURCE = "program_counter"
MOVES = "count_kmers_per_s"


def read(run):
    s = run.counter_delta("phase_pack_put_s")
    return None if s is None else 100.0 * s / run.window_s
