"""A tiny benchmark for the CPU: the repository's metrics, cut-down
copies of its configurations and mixes, and cells over them."""

import copy
import json
import os
import shutil

from qmbench import run

QM = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(QM)


# the readers whose BENCHMARK.json entries name their cells; the rest
# read every cell
NAMED_CELLS = ("pack_put_pct", "k2_roofline")


def metric_names() -> list[str]:
    """Every per-layer metric's reader under qmbench/metrics/."""
    return [f[:-3] for f in os.listdir(os.path.join(QM, "metrics"))
            if f.endswith(".py")]


def metric_entry(reg, name: str) -> dict:
    """A BENCHMARK.json entry for a reader, over the tiny cells."""
    mod = reg.metric(name)
    entry = {"name": name, "unit": mod.UNIT, "source": mod.SOURCE,
             "layer": mod.LAYER, "moves": mod.MOVES}
    if name in NAMED_CELLS:
        entry["workloads"] = ["f", "g"]
    return entry


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_bench(root: str) -> dict:
    """Write tiny configurations and mixes under root (with the
    repository's metrics) and return a BENCHMARK.json naming cells over
    them: f (150 bp reads) and g (1,500 bp reads), both flat."""
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(QM, "metrics"), os.path.join(root, "metrics"),
                    dirs_exist_ok=True)
    reg = run.Registry(QM)
    cfg = dict(reg.config("grch38cut99m-flat-mono"), genome_bases=1 << 15,
               dup_len=1 << 12, batch_bases=1 << 12, chunk_bytes=5000)
    with open(os.path.join(root, "configs", "tiny-flat.json"), "w") as f:
        json.dump(cfg, f)
    il = reg.traffic("il150-e0.3")
    for name, mix in (("tiny-il", dict(il, n_reads=300, sub_rate=0.01)),
                      ("tiny-long", dict(il, n_reads=12, read_len=1500,
                                         sub_rate=0.002))):
        with open(os.path.join(root, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    bench = copy.deepcopy(load_bench())
    bench["workloads"] = [
        {"name": "f", "config": "tiny-flat", "traffic": "tiny-il",
         "chips": 1, "why": "flat"},
        {"name": "g", "config": "tiny-flat", "traffic": "tiny-long",
         "chips": 1, "why": "flat, long reads"}]
    bench["per_layer"] = [metric_entry(reg, name)
                          for name in sorted(metric_names())]
    return bench
