"""Share of the window in which no kernel, copy or memset ran on the
card: 100 - the union of their intervals over the window, from the
profiler's trace (trace.busy_share)."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "count_kmers_per_s"


def read(run):
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
