"""Reading a torch.profiler trace of the window.

kernel_name and busy_share are copies of chip_smoke.py's at commit
0be96d5. The window is the benchmark's `qmbench.window` annotation; its
host spans (`qmbench.parse`, `qmbench.feed`, `qmbench.finish`) name what
the host was doing in each gap of the device's timeline.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

DEVICE_BUSY = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "qmbench.window"
SPAN_PREFIX = "qmbench."
TOP = 10


def kernel_name(name: str) -> str:
    """A device kernel's trace name without return type, namespace,
    template and parameter lists."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].split("<")[0]


def busy_share(events, lo, hi) -> float:
    """The share of [lo, hi] (µs) that the union of the device's kernel,
    copy and memset intervals covers."""
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events if e.get("cat") in DEVICE_BUSY
                   and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / (hi - lo) if hi > lo else 0.0


def profile():
    """A profiler of the host and the card, for the window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False)


def events_of(prof) -> list[dict]:
    """The trace's events, through a Chrome trace in a temporary file."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "window.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def summarize(events: list[dict]) -> dict | None:
    """What the metrics and the breakdown read from the window's trace:
    window_s, busy_s, kernel seconds by name, the device operations that
    took the most time and the longest idle gaps, each named by the host
    span open over most of it. None without the window's annotation."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        return None
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_BUSY
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    by_name: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for e in dev:
        name = kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        dur = (min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)) / 1e6
        by_name[name] = by_name.get(name, 0.0) + dur
        if e["cat"] == "kernel":
            kernels[name] = kernels.get(name, 0.0) + dur
    window_s = (hi - lo) / 1e6
    host = [(e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):])
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(SPAN_PREFIX)
            and e["name"] != WINDOW]
    gaps = sorted(_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": window_s,
            "busy_s": busy_share(dev, lo, hi) * window_s,
            "kernels": kernels,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"{_label(a, b, host)} +{(a - lo) / 1e6:.3f}s",
                           (b - a) / 1e6] for a, b in gaps]}


def _gaps(dev: list[dict], lo: float, hi: float):
    """The intervals of [lo, hi] that no device operation covers."""
    end = lo
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if a > end:
            yield end, min(a, hi)
        end = max(end, b)
    if end < hi:
        yield end, hi


def _label(a: float, b: float, host) -> str:
    """The host span that covers most of [a, b], or "other"."""
    best, name = 0.0, "other"
    for s, t, n in host:
        cover = min(b, t) - max(a, s)
        if cover > best:
            best, name = cover, n
    return name
