"""Share of the window the flat counter spent in its two pageable
host-to-card copies a batch (`counter.put`): the program's phase_put_s,
its change over the window. The pack is pack_put_pct less this."""

UNIT = "%"
LAYER = "H2D put, flat"
SOURCE = "program_span"
MOVES = "count_kmers_per_s"


def read(run):
    s = run.counter_delta("phase_put_s")
    return None if s is None else 100.0 * s / run.window_s
