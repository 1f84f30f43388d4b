"""Share of the window the host spent in the FASTQ packer
(make_packer(...).feed: the native parser), by the benchmark's span
around each feed."""

UNIT = "%"
LAYER = "host parse"
SOURCE = "program_span"
MOVES = "count_kmers_per_s"


def read(run):
    return 100.0 * run.spans.get("parse", 0.0) / run.window_s
