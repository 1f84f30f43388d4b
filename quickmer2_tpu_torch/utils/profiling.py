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

`Phases` is a counter's own account of its host side: each phase a
profiler range under the counter's prefix (`counter.drain`,
`anchored.put_wait`, ...) and its summed seconds, beside plain counts.
Its prefixes are not the pipeline regions' (`count.`), so filters on
those still see only the pipeline regions.
"""

from __future__ import annotations

import contextlib
import threading
import time

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


class Phases:
    """Seconds of a counter's phases, and its plain counts.

    `with phases("drain"):` is the profiler range `<prefix>drain` (on the
    trace's clock, beside the device's kernels and copies) and adds its
    perf_counter seconds to the phase; `phases.add("recount_lanes", m)`
    adds to a count. Phases nest: a phase opened inside another is its
    child, and the parent's self time is its seconds less its children's.
    The sums take a lock, so a transfer thread may time its phases too.
    No synchronize and no device work: the seconds are the host's."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        with torch.profiler.record_function(self.prefix + name):
            yield
        dt = time.perf_counter() - t
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + int(n)

    def stats(self) -> dict:
        """`phase_<name>_s` for each phase (rounded to 0.1 ms) and
        `n_<name>` for each count."""
        with self._lock:
            out = {f"phase_{n}_s": round(v, 4)
                   for n, v in self.seconds.items()}
            out.update((f"n_{n}", v) for n, v in self.counts.items())
        return out
