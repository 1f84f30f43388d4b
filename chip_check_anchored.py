"""Quick check of the anchored path's kernels on one NVIDIA card, at a
small size (a 2 Mb realistic genome, a dictionary of its unique 30-mers):

    python3 chip_check_anchored.py

It builds the kernels, then holds K4 (neighbor sweep), K3 (anchored read
pass, tier 1 and tier 2) and K2r (exact row recount) against their plain
PyTorch versions on the card with chip_smoke.py's checks (times and
bounds included), K3 also in the mask format (N bases), in the
point-probe branch and at 1024-wide rows (segmented long reads), and
counts 120 k reads with `run_count` in flat and anchored mode on the
card and in anchored mode on the CPU: the three .bin files must be
identical. Tolerance: exact equality (integer outputs). Takes about a
minute on an H100; chip_smoke.py is the full run at the main path's
size.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_anchored")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_check_anchored: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.kernels import build
    from quickmer2_tpu_torch.kernels.anchored import (
        anchored_count, anchored_count_plain)
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops.anchored import (
        AnchoredDepthCounter, rows_from_flat_codes)
    from quickmer2_tpu_torch.pipelines.count import run_count
    from tools.realistic_genome import make_genome, to_fasta

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        t = time.time()
        built = build.build_all()
        cs.log(f"build: {time.time() - t:.2f} s")
        dev = torch.device("cuda")
        rng = np.random.default_rng(5)
        g, _, _ = make_genome(rng, 2_000_000, dup_len=50_000, dup_copies=2)
        fa = os.path.join(WORK, "g.fa")
        to_fasta(fa, g)
        canon, valid = codec.sliding_kmers_np(g, 30)
        ok = valid & (canon != 0)
        _, inv, cnt = np.unique(canon[ok], return_inverse=True,
                                return_counts=True)
        kmers = canon[ok][cnt[inv] == 1]          # genome order
        Dictionary.from_kmers_in_order(kmers, 1 << 22, 30).to_qm(fa + ".qm")
        cs.log(f"dictionary: {len(kmers)} k-mers of {len(g)} bases")

        stream, index, counter = cs.anchored_setup(fa, dev)
        rows = [cs.check_neighbor_bits(stream, index, 30, dev)]
        reads = cs.simulate_reads(rng, g, 200_000, 150, 0.003)
        B = counter.batch_reads
        rows.append(cs.check_anchored(index, counter,
                                      cs.rows_of(reads[:B]), 1, dev))
        tier2, exact, first = cs.spill_batches(index, counter, reads, dev)
        cs.log(f"tier-1 codes 0/1/2 of the first batch: {first.tolist()}")
        rows.append(cs.check_anchored(index, counter, tier2, 2, dev))
        rows.append(cs.check_count_mono_rows(counter, exact, dev))

        def compare(rr, kw, label):
            fmt, pk, aux, _ = cs.packed_on(rr, dev)
            tab = (index.rows, index.genome_tiles, index.dblock)
            d_k = torch.zeros(index.n_kmers + 2, dtype=torch.int32,
                              device=dev)
            d_p = torch.zeros_like(d_k)
            c_k = anchored_count(pk, aux, *tab, d_k, fmt=fmt, **kw)
            c_p = anchored_count_plain(pk, aux, *tab, d_p, fmt=fmt, **kw)
            torch.cuda.synchronize()
            err = max(cs.max_abs_err(d_k, d_p), cs.max_abs_err(c_k, c_p))
            cs.log(f"  {label} ({fmt}, rows of {rr.shape[1]}): codes 0/1/2 "
                   f"= {np.bincount(c_k.cpu().numpy(), minlength=3).tolist()}"
                   f", max |kernel - plain| = {err}")
            if err != 0:
                raise AssertionError(f"{label} disagrees with its plain "
                                     "version")

        # N bases (mask format) in every branch
        rr = cs.rows_of(reads[B:2 * B])
        rr[rng.random(rr.shape) < 0.002] = codec.SEP
        compare(rr, counter._tier_kw(1), "tier 1")
        compare(rr, counter._tier_kw(2), "tier 2")
        compare(rr, dict(counter._tier_kw(1), max_dirty=8,
                         neighbor_mode=False), "point probes")
        cs.check_count_mono_rows(counter, rr, dev)
        # 1024-wide rows: 10 kb reads cut into k-1-overlap segments
        long_reads = cs.simulate_reads(rng, g, 600, 10_000, 0.003)
        flat = np.concatenate(
            [long_reads, np.full((600, 1), codec.SEP, np.uint8)], 1)
        wide = rows_from_flat_codes(flat.reshape(-1), 1024, segment_k=30)
        wc = AnchoredDepthCounter(index, 30, 1024, prefetch_puts=False,
                                  device=dev)
        for tier in (1, 2):
            compare(wide, wc._tier_kw(tier), f"tier {tier}")
        del stream, index, counter
        torch.cuda.empty_cache()

        fq = os.path.join(WORK, "r.fq")
        cs.write_fastq(fq, reads[:120_000])
        bins = []
        for mode, device in (("flat", "cuda"), ("anchored", "cuda"),
                             ("anchored", "cpu")):
            t = time.time()
            out = os.path.join(WORK, f"{mode}_{device}")
            stats = run_count(fa + ".qm", fq, out, batch_bases=1 << 22,
                              verbose=False, mode=mode, device=device)
            with open(out + ".bin", "rb") as f:
                bins.append(f.read())
            cs.log(f"count {mode} on {device}: {time.time() - t:.2f} s "
                   f"{json.dumps(stats)}")
        if not bins[0] == bins[1] == bins[2]:
            raise AssertionError("flat/cuda, anchored/cuda and anchored/cpu "
                                 ".bin files differ")
        cs.log("flat and anchored .bin identical, card and CPU")
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "built": sorted(built)}))
        return 0
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
