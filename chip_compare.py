"""K3 on rows wider than 1,024 bases: this checkout's kernel against
another checkout's, in one process on one card.

    python3 chip_compare.py OTHER

OTHER is the root of another checkout of the repo (an unpacked `git
archive` of the parent commit, say). Both checkouts' csrc/anchored.cu are
built with nvcc (OTHER's into chip_smoke's work directory); the smoke
genome is made, searched and indexed as chip_smoke.py does it, and the
wide batches of chip_smoke.check_anchored_edges are built by the same
function, chip_smoke.edge_inputs (3,480 rows of 2,048, 1,016 of 16,384).
This checkout's kernel is held against its plain version on the batches
of 2,048 and 16,384 in all three branches, lens and mask; then tier 1 is
timed on the lens batches of 2,048 and 16,384 (chip_smoke.
time_anchored_wide: ms back to back and queued) in turns: OTHER, this,
this, OTHER. Prints the card's name and power limit, each kernel
variant's ptxas report and one line a timing, `AB <side> <width> ms <ms>
queued <ms> bound <ms>`. Exits 1 without a card.
"""

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device is available", file=sys.stderr)
        return 1
    other = os.path.abspath(sys.argv[1])
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from quickmer2_tpu_torch.config import SearchConfig
    from quickmer2_tpu_torch.kernels import anchored as ka, build
    from quickmer2_tpu_torch.ops.anchored import AnchoredDepthCounter
    from quickmer2_tpu_torch.pipelines.search import run_search
    dev = torch.device("cuda")
    os.makedirs(cs.WORK, exist_ok=True)
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    built = build.build_all(["anchored"])
    for line in cs.ptxas_summary(built["anchored"]["log"]):
        if "wide" in line:
            cs.log(f"  this: {line}")
    so = os.path.join(cs.WORK, "libanchored-other.so")
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so,
                        os.path.join(other, "quickmer2_tpu_torch", "csrc",
                                     "anchored.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {other}:\n{r.stdout}{r.stderr}")
    for line in cs.ptxas_summary(r.stdout + r.stderr):
        if "wide" in line:
            cs.log(f"  other: {line}")
    libs = {"this": ka._lib(), "other": ctypes.CDLL(so)}
    libs["other"].qm2t_error_string.argtypes = [ctypes.c_int]
    libs["other"].qm2t_error_string.restype = ctypes.c_char_p
    libs["other"].qm2t_anchored.argtypes = ka._ARGTYPES
    for width in cs.WIDE_TIMED:
        cs.log(f"  rows of {width}, blocks of "
               f"{cs.wide_block_threads(width)} threads")

    t = time.time()
    world = cs.make_world(np.random.default_rng(2024))
    run_search(world["fa"], SearchConfig(
        kmer_size=30, edit_distance=2, edit_depth_threshold=100,
        window_size=1000, control_bed=world["ctrl"]),
        verbose=False, device="cuda")
    _, _, index, counter = cs.anchored_setup(world["fa"], dev)
    g, k, B = world["g"], counter.k, counter.batch_reads
    cs.log(f"genome, search and index in {time.time() - t:.1f} s")
    wide = cs.edge_inputs(g, k, B)[2]
    counters = {width: AnchoredDepthCounter(index, k, width,
                                            prefetch_puts=False, device=dev)
                for width in cs.WIDE_TIMED}
    err = 0
    for width in cs.WIDE_TIMED:
        for batch in wide[width]:
            err = max(err, cs.compare_wide(index, batch, counters[width],
                                           dev))
    cs.log(f"this checkout's kernel against its plain version: max |kernel "
           f"- plain| = {err}")
    out, own_lib = [], ka._lib
    try:
        for side in ("other", "this", "this", "other"):
            # the wrappers resolve the library through _lib at each call
            ka._lib = lambda lib=libs[side]: lib
            for width in cs.WIDE_TIMED:
                row = cs.time_anchored_wide(
                    index, counters[width]._tier_kw(1), wide[width][0], dev)
                out.append(f"AB {side} {width} ms {row['ms']:.4f} queued "
                           f"{row['queued_ms']:.4f} bound "
                           f"{row['bound_ms']:.4f}")
    finally:
        ka._lib = own_lib
    print("\n".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
