"""The comparison's control and faults, at a cell's own size.

    python -m qmbench.control --workload <cell> --seeds 1,2,3 --chunks 60

For each seed it makes the cell's pool, counts the first `chunks` chunks
of its stream with the plain reference, and holds against that count
the answers a faulty program would give, as run.py's comparison does:
  forward_only  the reference with its canonical guarantee broken: each
                window counted on its forward strand alone (the control);
  u16           the depth kept in 16 bits, wrapping (the .bin's width);
  tail_dropped  the stream's last chunk left out, as a finish() that did
                not flush its tail would.
It prints one JSON line a seed: each variant's count of keys whose depth
differs (the number the run's check holds at 0). It runs no program.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from qmbench import reference, run, traffic, world


def readings(cell: str, seed: int, chunks: int, device: torch.device,
             bench: dict | None = None,
             registry: run.Registry | None = None,
             cache_dir: str = world.CACHE_DIR) -> dict:
    if bench is None:
        with open(run.BENCHMARK) as f:
            bench = json.load(f)
    reg = registry or run.Registry()
    c = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg, mix = reg.config(c["config"]), reg.traffic(c["traffic"])
    k, chunk = int(cfg["k"]), int(cfg["chunk_bytes"])
    ref_world = world.load_world(cfg, cache_dir, device)
    pool = traffic.make_pool(np.random.default_rng(seed % (1 << 64)),
                             ref_world.genome, mix, k)
    n = chunks * chunk
    truth, short = reference.count_stream(pool.data, ref_world.keys, k,
                                          [n, n - chunk], device)
    fwd, = reference.count_stream(pool.data, ref_world.keys, k, [n], device,
                                  forward_only=True)

    def mismatch(depth):
        return int(np.count_nonzero(depth != truth))
    return {"cell": cell, "seed": seed, "bytes": n,
            "keys": len(truth), "max_depth": int(truth.max()),
            "forward_only": mismatch(fwd),
            "u16": mismatch(truth & 0xFFFF),
            "tail_dropped": mismatch(short)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qmbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--chunks", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qmbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.chunks,
                                  torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
