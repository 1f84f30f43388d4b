"""Profiling hooks on torch.profiler, the port's counterpart of
quickmer2_tpu/utils/profiling.py (same two names).

`trace(dir, device)` wraps a run in `torch.profiler.profile` and writes
one Chrome trace, `<dir>/<host>_<pid>.<ns>.pt.trace.json`, which
TensorBoard's profiler plugin and Perfetto (ui.perfetto.dev) open: the
host's operators and, on a CUDA device, every kernel, copy and memset
with its time. `annotate(name)` names a pipeline region (search.tabulate
/ filter / emit, count.stream / finish): in a trace it is a
`user_annotation` on the host's timeline and a `gpu_user_annotation`
over the device work launched inside it. Outside a trace both cost next
to nothing, so the hot paths carry them always.
"""

from __future__ import annotations

import contextlib

import torch

from quickmer2_tpu_torch.device import resolve_device


@contextlib.contextmanager
def trace(trace_dir: str | None, device: str | torch.device = "cuda"):
    """Profile the enclosed region into trace_dir (no-op when None).
    `device` is the run's: its CUDA activity is traced with the host's,
    and "cuda" without a card raises, as every entry point does."""
    if not trace_dir:
        yield
        return
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities, record_shapes=False, with_stack=False,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                trace_dir)):
        yield
        if dev.type == "cuda":
            # the last launches' device events land inside the window, on
            # every card a mesh (--data-devices, --emit-devices, ...) used
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)


def annotate(name: str):
    """Named region for the profiler's timelines (a context manager)."""
    return torch.profiler.record_function(name)
