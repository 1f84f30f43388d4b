"""K2's (csrc/count_mono.cu, the flat mono count) share of its roofline:
the least time for the window's inputs (roofline.py) over K2's summed
device time in the trace."""

UNIT = "%"
LAYER = "kernel K2"
SOURCE = "device_trace"
MOVES = "count_kmers_per_s"

KERNELS = ("count_mono_hist_kernel", "count_mono_scatter_kernel",
           "count_mono_probe_kernel", "count_mono_direct_kernel")


def read(run):
    return run.roofline("k2", KERNELS)
