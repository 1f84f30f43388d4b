"""One run of one cell of the benchmark of quickmer2_tpu_torch's count.

    python -m qmbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the configuration's reference (world.py), the mix's read pool
from --seed (traffic.py), the program's dictionary, mono table and
StreamCounter (program.py), and a warm-up count of the stream's first
MiB on a counter of its own. Then the timed counter takes the stream's
first chunk, and the window feeds it on chunk by chunk, as run_count does,
until --seconds have passed, and ends with finish(). The depth vector
finish() returns is held, key by key, against the plain reference
(reference.py) over every byte the counter took. The last line of
standard output is the result, one JSON object; with --trace 1 the
window runs under torch.profiler and the line carries the per-layer
metrics and a breakdown of the device's time.

Everything a cell needs is found by name: BENCHMARK.json at the root of
the checkout names the cells and metrics, configs/<name>.json each
configuration, traffic/<name>.json each mix and metrics/<name>.py each
per-layer metric's reader.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from qmbench import program, reference, roofline, trace, traffic, world

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "quickmer2_tpu")
# the warm-up count's share of the stream: enough reads that each kernel
# and host path (the mask drain and its recount too) runs once
WARM_BYTES = 1 << 20


class Registry:
    """Configurations, mixes and per-layer metrics, each a file of its
    own under `root`, found by its name."""

    def __init__(self, root: str = HERE):
        self.root = root

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.root, kind, name + ".json")) as f:
            return dict(json.load(f), name=name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def metric(self, name: str):
        path = os.path.join(self.root, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "qmbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def check_metric(entry: dict, mod) -> None:
    """A metric's file and its BENCHMARK.json entry must agree."""
    for key in ("unit", "layer", "source", "moves"):
        if getattr(mod, key.upper()) != entry[key]:
            raise ValueError(
                f"metric {entry['name']}: {key} is {entry[key]!r} in "
                f"BENCHMARK.json, {getattr(mod, key.upper())!r} in its file")


def metrics_of(entries: list[dict], cell: str) -> list[dict]:
    """The metrics a cell reports: those naming it, or naming no cell."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


class Spans:
    """Host seconds by span name; each span is also a profiler range
    (`qmbench.<name>`) for the trace's idle gaps."""

    def __init__(self):
        self.s: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        with torch.profiler.record_function("qmbench." + name):
            yield
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""
    window_s: float
    spans: dict
    stats_start: dict
    stats_end: dict
    trace: dict | None
    work: dict
    notes: list

    def counter_delta(self, key: str):
        """A program counter's change over the window, or None."""
        if key not in self.stats_end:
            return None
        return self.stats_end[key] - self.stats_start.get(key, 0.0)

    def roofline(self, kernel: str, names) -> float | None:
        if self.trace is None:
            return None
        t = sum(s for n, s in self.trace["kernels"].items() if n in names)
        got = roofline.share_pct(t, self.work, kernel)
        if got is None:
            return None
        self.notes.append(f"{kernel} roofline {got[0]} % of {t} s, bound by "
                          f"{got[1]}")
        return got[0]


def log(msg: str) -> None:
    print(f"[qmbench] {msg}", file=sys.stderr, flush=True)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, *, device: str = "cuda", t_start: float,
             registry: Registry | None = None,
             cache_dir: str = world.CACHE_DIR) -> tuple[dict, dict]:
    """One run: (the result's object, the numbers compared with their
    limits). device "cpu" runs the program's plain kernels (tests only)."""
    reg = registry or Registry()
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no cell {cell_name!r} in BENCHMARK.json; one of "
                         f"{sorted(cells)}")
    cell = cells[cell_name]
    cfg, mix = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    e2e = metrics_of(bench["end_to_end"], cell_name)
    per_layer = metrics_of(bench["per_layer"], cell_name)
    readers = {}
    for m in per_layer:
        readers[m["name"]] = reg.metric(m["name"])
        check_metric(m, readers[m["name"]])
    dev = torch.device(device)
    k, chunk = int(cfg["k"]), int(cfg["chunk_bytes"])
    spans = Spans()

    t = time.perf_counter()
    spans.s["imports"] = t - t_start
    ref_world = world.load_world(cfg, cache_dir, dev, log=log)
    pool = traffic.make_pool(np.random.default_rng(seed % (1 << 64)),
                             ref_world.genome, mix, k)
    inputs_s = time.perf_counter() - t
    log(f"inputs in {inputs_s:.2f} s: {len(ref_world.keys)} keys, "
        f"{pool.n_reads} reads of {pool.read_len}, {len(pool.data)} bytes")

    count = program.Count(cfg, ref_world, dev, spans, log=log)
    with spans("warm_up"):
        count.warm_up(pool.chunk(0, min(chunk, WARM_BYTES)))
        count.feed_codes(count.feed_bytes(pool.chunk(0, chunk)))
    warm = chunk
    stats_start = count.stats()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof = trace.profile() if traced else contextlib.nullcontext()

    with prof:
        with torch.profiler.record_function(trace.WINDOW):
            t0 = time.perf_counter()
            at = warm
            while True:
                data = pool.chunk(at, chunk)
                at += len(data)
                with spans("parse"):
                    codes = count.feed_bytes(data)
                with spans("feed"):
                    count.feed_codes(codes)
                if time.perf_counter() - t0 >= seconds:
                    break
            with spans("finish"):
                depth = count.finish()
            t1 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    window_s = t1 - t0
    setup_s = t0 - t_start - inputs_s
    stats_end = count.stats()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window {window_s:.3f} s, {at} bytes fed ({at // chunk} chunks), "
        f"set-up {setup_s:.3f} s (spans {spans.s}); counter {stats_end}")
    summary = trace.summarize(trace.events_of(prof)) if traced else None
    del count
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref_total, ref_warm = reference.count_stream(
        pool.data, ref_world.keys, k, [at, warm], dev)
    log(f"reference in {time.perf_counter() - t:.2f} s")
    gap = np.abs(depth.astype(np.int64) - ref_total.astype(np.int64))
    checks = {"depth_mismatch": (int(np.count_nonzero(gap)), 0),
              "depth_max_gap": (int(gap.max()) if len(gap) else 0, 0),
              "depth_length_gap": (abs(len(depth) - len(ref_total)), 0)}
    correct = all(v <= lim for v, lim in checks.values())

    reads = pool.reads_started(at) - pool.reads_started(warm)
    # the flat count refuses no read and reports none; a read it dropped
    # shows in the depth comparison
    failed = 0
    windows = pool.windows_fed(at) - pool.windows_fed(warm)
    window_depth = ref_total.astype(np.int64) - ref_warm.astype(np.int64)
    work = {"bases": pool.bases_fed(at) - pool.bases_fed(warm),
            "windows": windows,
            "distinct_keys": int(np.count_nonzero(window_depth))}
    metrics = {}
    if traced:
        run = Run(window_s, spans.s, stats_start, stats_end, summary, work,
                  [])
        for m in per_layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        for note in run.notes:
            log(f"{note}; card {card_power()}")
    else:
        values = {"count_kmers_per_s": windows / window_s, "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(reads),
              "failed": int(failed), "metrics": metrics, "device": dev_out}
    if summary is not None:
        dev_out["busy_s"] = summary["busy_s"]
        dev_out["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    return result, checks


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python -m qmbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(BENCHMARK) as f:
        bench = json.load(f)
    chips = {c["name"]: int(c["chips"]) for c in bench["workloads"]}
    need = chips.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"qmbench: the cell needs {need} CUDA card(s), {n} found; "
              f"it does not run on the CPU", file=sys.stderr)
        return 2
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(world.CACHE_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(world.CACHE_DIR, "triton"))
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"qmbench: the run loaded {bad}; the benchmark measures "
              f"quickmer2_tpu_torch alone", file=sys.stderr)
        return 3
    for name, (v, lim) in checks.items():
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
