"""Seconds of set-up spent building the count's table: the mono table
with the StreamCounter's construction. The benchmark's span around
them."""

UNIT = "s"
LAYER = "set-up: table builds"
SOURCE = "program_span"
MOVES = "setup_s"


def read(run):
    return run.spans.get("table_build")
