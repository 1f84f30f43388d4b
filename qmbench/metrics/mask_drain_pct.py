"""Share of the window the mono counter spent draining its batches'
unresolved-lane masks (`counter.drain`: the wait on the mask's copy, its
scan and the host recount of the lanes): the program's phase_drain_s,
its change over the window. A counter whose drain holds no mask_scan
phase gives no value: its phase_drain_s timed the mask's fetch and
unpack alone."""

UNIT = "%"
LAYER = "mono mask drain + host recount"
SOURCE = "program_span"
MOVES = "count_kmers_per_s"


def read(run):
    s = run.counter_delta("phase_drain_s")
    if s is None or run.counter_delta("phase_mask_scan_s") is None:
        return None
    return 100.0 * s / run.window_s
