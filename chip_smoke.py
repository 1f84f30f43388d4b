"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                # the full run (needs one card)
    python3 chip_smoke.py --check-only   # build, search, kernel checks

Phases:
  1. build    — nvcc builds every kernel of the paths (csrc/*.cu), one
                process per source, in parallel; one line per kernel of
                ptxas' registers, stack frame and spill bytes;
  2. kernels  — each kernel against its plain PyTorch version on the
                card, at the main paths' shapes; integer outputs, so the
                tolerance is exact equality; CUDA-event times of both.
                K2 (flat mono count) first: timed at k = 30 on a 2^22-
                bucket table (P = 16 slices), where the same batch also
                runs at P = 1, 4, 8, 32 and 64, each checked; untimed at
                k = 32 (P = 2), k = 15 (P = 2) and k = 31 (P = 1, the
                one-pass kernel), the last two on batches that are not a
                multiple of 64 bases. Then i′ (K1's layouts: a stable
                counting sort of each side and an expand, no slots)
                against its plain version and, bit for bit, against the
                layouts of the host's slots (`_slots_u8`), on the
                search's own layouts at pads 64/32 (timed, its five
                passes by torch.profiler, beside torch.sort of the keys
                and the host slots' seconds) and 128/64, each also on
                entries planted by entry order and spread over the
                chunk (a word crowd of cpad + 9 with dead words, a query
                crowd of cpad_q + 5, a one-entry last bucket, strided
                word views), and K1 (Hamming join) on those
                layouts (timed) and 128/64 (on every 4th
                distinct k-mer), each also on
                hand-planted buckets: > 1024 live pairs, 36 pairs, live
                words without a live query. K6 (per-neighbor sum) on the
                search's own slow set (timed), against the host slow path
                on 20,000 of those queries (timed), at k = 15 and 32 on a
                small dictionary (e = 1, 2), each with the key filter's
                pass rate and no hit dropped; K6 on one probe-filter
                batch of 2^20 queries (timed), the first 2^18 against the
                plain version; the hamming filter (K1, K6
                as its slow path) and the probe filter (K6 over every
                query) on the search's unique set, timed, their sums
                equal. The anchored path's kernels
                need the search's dictionary and run after the flat path
                (`check_anchored_kernels`): the key filter and K4
                (neighbor sweep) on the index's table, both again at
                k = 15 and k = 32 on a small dictionary; K5 (the join's
                neighbor bits) and its counting sort (bucket runs) on a
                2,000,000-window tile at pads 64/32 (timed: the word
                runs, the query runs and their kernels by
                torch.profiler, the kernel, and beside them the padded
                layouts of the previous design), on a planted
                call (a bucket of 245 words that the pad of 240 cuts,
                60 queries on both strands, a query one base from
                all-A) and on the tile's slow windows at pads 240/240,
                runs and planes each equal to the plain version's; the
                counting sort also on a word chunk keyed by 24 bits, a
                skewed set whose largest coarse bin outgrows the place
                pass's stage, caps 1 and 255, no entering entry and
                n = 0, and timed beside one torch.sort of the keys on
                both sides; K3 (anchored
                read pass) timed in tier 1 and tier 2 on the main path's
                160-wide batches, then untimed on the shapes its lane
                groups branch on: the mask format (N bases) in all three
                branches (tier 1, tier 2, point probes), rows of 64 (2
                lanes a read) and rows of 1024 from segmented 10 kb
                reads (32 lanes a read), and rows wider than 1,024 (a
                block a read, a warp a tile of 1,024): 2,048, 3,000 and
                16,384 from those reads, a few 20 kb reads and reads
                with substitutions planted across base 1,024, 16,384
                from reads with substitutions planted across every
                tile boundary, and 65,535 from 70 kb reads and reads
                planted in its last, partial tile, in all three
                branches, lens and mask, timed at 2,048 and 16,384,
                each width's block logged; K2r (exact row recount)
                timed on the main path's exact batch, with its
                wrapper's host time; then untimed at k = 15, 30, 31, 32 on rows of 64, 150 (a
                38-B pitch), 160 and 1024, lens and mask format, on a
                short batch of 1001 reads (R * W no multiple of 32).
                In phase 4 the small world's .qai built through
                AnchoredIndex.build with the join (its own path: K5
                must launch), identical to the bytes of the .qai that
                the small world's anchored count's K4 built, both
                index_s (with --check-only both are built on the
                smoke's own .qai here);
                The flat engines' kernels need the search's .qm and
                run after the flat path (`check_flat_engines`): K7
                (linear probe) on the smoke's .qm, K8 (packed count) on
                its PackedTable (host build timed) and K9 (the sort-join
                codec), each timed on one 2^24-base batch of the reads,
                K7 and K8 at their own slice count P (16 and 64 on the
                smoke's tables) and at P = 1, 2 and a sweep, their slot
                depth and trash counter exact at each, their slot ->
                rank translation (timed) equal to the rank-space step;
                untimed at k = 15, 31, 32 on batches no multiple of 64
                bases and on a 4096-slot table whose scans wrap past
                slot 0 and cross slices, each at P = 1, 2 and the
                smoke's; the linear and packed DepthCounters' snapshot,
                restore and resume on the card; then the sort-join
                crossover: one batch through K2 and through K9 +
                ops.sortjoin at n = 2^14 .. 2^20 keys, the join's depth
                checked against K8's. K10 (the device emit's membership
                scan) on K8's PackedTable of the .qm k-mers: the whole
                genome as the scanner chunks it, and at chunks of 2^22
                with an N run over a seam, an N inside a halo and a
                SEP-padded tail, and a 2^22 chunk with the table's keys
                at h2 and absent codes behind a full h1 planted, each
                chunk's bit-packed mask equal to the plain version's,
                to a probe of both rows with no gate and (but the
                planted chunk) to the host lookup's hit set; timed on
                one 2^24-window chunk (each pass by torch.profiler, at
                P = 64 too, checked, its h2 reads with the gate and
                without) beside torch.isin of its valid nonzero
                codes against the survivors. K11 (est's window sums)
                on 101 M k-mers in windows of 1,000: two launches
                bit for bit the same, equal to the plain version (the
                same summation order), within 1e-4 of a float64 truth,
                timed beside the best plain-PyTorch composition
                (products, then torch.segment_reduce). The multi-device
                layer's kernels, each against its plain version at
                (dp, ds) = (2, 2) on the main path's shapes: K8b (block
                flat count) on the 2^24-base batch split over two data
                shards against every bucket block of the PackedTable at
                ds = 1, 2 and 4 (at its own P, P = 1 and 2; the
                rank-space partials summing to K8's depth at each ds;
                timed at each ds, each pass by torch.profiler, and the
                batch's four launches at (2, 2) beside one K8 launch on
                it; shard 0 on block 0 also at P = 16 .. 256, each
                checked and timed), K12 (packed exact recount) on the
                exact batch and on it with 2,000 keys that sit at h2
                planted (lens and mask formats) through the whole table
                (timed, with its probe counts) and through each block
                (summing to the whole; block 0 timed), with and without
                the bitmap, K3a (anchor probes) with each block's
                bitmap on each block at ds = 2 and 4 of the tier-1 and
                tier-2 batches and of the tier-1 batch with 4,000 keys
                that sit at h2 planted at the anchors (lens and mask
                formats; at ds = 2 also cut to rows of 150, whose
                bases and invalid bits K3a loads byte by byte, and on rows
                of 2,048 with K3 on the blocks),
                against its plain version and both rows'
                ungated probe (block 0 of 2 timed, with its wrapper's
                host time and h2 reads) and K3 with the
                summed anchors on each block in tiers 1 and 2 (its codes
                the one-launch K3's, its diffs summing to that K3's;
                block 0 timed, beside its plain version and a bound
                from the block's own inputs), and K10's scan over two shards of the card
                (search --emit-devices 2) equal to the host lookup;
  3. main     — the flat path: search (k=30, e=2, d=100, w=1000, control
                bed) → count (flat, mono) → est on a 12 Mb realistic
                genome (tools/realistic_genome.py, S. cerevisiae scale)
                with ~20x simulated 150 bp reads; then count with each
                other flat engine (linear, packed, sortjoin; auto on the
                50 k reads of phase 4's small world), each .bin equal to the mono
                one and each layout's kernel
                launched on its own path; then the anchored path:
                count --mode anchored (its .qai built on the card) → est
                on the same reads. The launch counters are reset just
                before each path and read just after; each path's kernels
                must have launched (K1, the key filter and K6 in the
                search); the
                anchored .bin must equal the flat .bin byte for byte;
                CN is checked on the baseline windows
                (2 ± 0.1) and on a segment with 3x extra read depth
                (6 ± 0.5), for both paths; after the flat est, the
                search and the count again under --profile, each a
                `python -m quickmer2_tpu_torch` process of its own, one
                after the other (`check_profile`): their outputs the unprofiled runs'
                bytes, each trace one torch.profiler JSON file whose
                regions are the JAX package's five in order, none
                overlapping, K1, K6 and the key filter inside
                search.filter's device span, K2 inside count.stream's
                and as many K2 launches as the count fed batches; each
                process's wall beside the unprofiled run's, the trace's
                size, its kernels by name and each region's
                device-busy share; then est with
                device_sums (K11 launched; windows of the host est, CN
                within 1e-4), K11 on the count's .bin with the smoke's
                .qgc / .bed (checked as at 101 M, timed: its kernel row),
                search -e 0 with the host emit and with the device emit
                (K10 launched; .qm, .bed, .qgc identical), then sparse 1
                on a copy of the FASTA and .qm (the search's .bed and
                .qgc again, the .rqm chain the .qm's), sparse 50, index
                on a bed of 100 k dictionary k-mers (its chain the bed's
                k-mers), colortrack and colorkey on the flat CN bed;
  4. cpu      — on a small world (`make_small_world`: the genome's
                first 2 Mb searched as in phase 3, 50 k reads of it;
                these checks hold a path against another, and a count's
                set-up scales with the dictionary) the reads counted
                with device="cuda" and with device="cpu" give
                byte-identical .bin files, in flat and in anchored
                mode; then its .qai by the join against its anchored
                count's (above); then the subset's flat (mono, linear)
                and anchored counts interrupted by a reader that raises
                after four checkpoints and resumed from them, each .bin
                equal to the uninterrupted one; a two-sample cohort (the
                subset twice) in both modes, its .bin, .txt and .CN.bed
                equal to the single-sample run's; `count` and `cohort
                --mode anchored --read-len 2048` (the CLI's main) on
                300 10 kb reads of the subset's genome, each .bin the
                flat count's (K3 must launch on the wide rows); entry()
                once on the card, equal to the CPU; then the
                multi-device layer on one card (`check_multi_device`):
                the subset counted by the flat ShardedDepthCounter at
                (dp, ds) = (2, 2) and the ShardedAnchoredCounter at
                (2, 1) and (2, 2) on [cuda:0] x 4, each .bin equal to the
                one-card count's and timed beside a one-device count
                (K8b, K12, K3a and K3 on blocks must launch), a
                two-process run_count_distributed (two subprocesses on
                cuda:0, backend gloo) equal to it too, and
                dryrun_multichip(4) on [cuda:0] x 4;
  5. card     — name and power limit from nvidia-smi.
`--check-only` stops after the kernel checks (it still runs the search,
whose dictionary the anchored checks need). Prints the kernel table as
one JSON line, the nvidia-smi line, and last {"ok": true, "device":
{...}}. Any failure raises (non-zero exit). With no CUDA card it exits
non-zero before doing anything.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
T0 = time.time()                 # the log's clock

HBM_BYTES_S = 3.35e12            # H100 SXM HBM3
# int32 ALU: 132 SMs x 64 lanes x 1.98 GHz (the data sheet's 67 TFLOP/s
# float32 is 128 lanes x 2 flops per FMA at the same clock)
INT32_OPS_S = 132 * 64 * 1.98e9

# K2's untimed branch shapes beside the timed k = 30 (P = 16) and k = 32
# (P = 2) cases: (k, keys, batch bases) giving P = 2 at k = 15 and P = 1
# at k = 31, both batches not a multiple of 64 bases
K2_EDGES = ((15, 2_000_000, (1 << 22) + 13), (31, 600_000, 3_000_001))

GENOME_BASES = 12_000_000
READ_LEN = 150
COVERAGE = 20
ERR = 0.003
# phase 4 (cpu against card, resume, cohort, multi-device) runs on a
# slice of the genome: set-ups that build the dictionary's tables
# dominate its counts at the full dictionary
SMALL_BASES = 2_000_000
SMALL_READS = 50_000


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f} s] {msg}", flush=True)


def cuda_ms(fn, reps: int, warm: int = 1, queued: bool = False) -> float:
    """Mean milliseconds per call of fn() over `reps` calls, by CUDA
    events after `warm` untimed calls, the calls back to back as they
    are issued. queued: the events and calls are first queued behind a
    sleeping kernel, so that a kernel that takes less time than its
    wrapper's host code (K3's) is timed on the card and not on the
    host."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(60_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, reps: int) -> tuple[float, float]:
    """A kernel's time by cuda_ms, back to back (the kernel table's
    `ms`) and queued (its `queued_ms`)."""
    return cuda_ms(fn, reps), cuda_ms(fn, reps, queued=True)


def profile_kernels(fn, reps: int, label: str) -> dict | None:
    """{kernel: device ms a call of fn()} by torch.profiler (CUPTI) over
    `reps` calls after a warm-up, the kernel named without namespace,
    template or arguments. The calls sit between two idle spans inside
    the profiled window, as a guard against device timestamps that land
    just outside it (the profiler drops those events), and the profile
    is taken again with longer idle spans where it saw no device time.
    If it still sees none, the failure is logged with the profiler's
    event counts and None is returned: label's passes are then not
    measured in this run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for pad_s in (0.25, 2.0):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            if t > 0:
                m = re.search(r"(\w+)(<|\()", e.key)
                name = m.group(1) if m else e.key
                out[name] = round(out.get(name, 0.0) + t / 1e3 / reps, 4)
        if out:
            return out
        events = prof.events()
        log(f"  torch.profiler saw no device time for {label} with "
            f"{pad_s} s idle either side: {len(events)} events, "
            f"{sum(e.device_type.name == 'CUDA' for e in events)} on the "
            f"device")
    log(f"  FAILED to profile {label}: its passes are not measured in this "
        f"run")
    return None


def ptxas_summary(nvcc_log: str) -> list[str]:
    """One line per kernel of nvcc's -Xptxas -v report: registers,
    stack frame and spill bytes, and static shared memory where the
    kernel has any; warnings as they are."""
    out, name = [], None
    for line in nvcc_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif "stack frame" in line and name:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, {frame}"
                       + (f", {smem.group(1)} bytes smem" if smem else ""))
            name = None
        elif "warning" in line:
            out.append(line.strip())
    return out


def ptxas_of(nvcc_log: str, match: str) -> dict:
    """Registers (least and most), stack frame, spill bytes and static
    shared memory (most) over the kernels of an nvcc -Xptxas -v report
    whose mangled name the regular expression `match` finds."""
    regs, stack, spill, smem = [], 0, 0, 0
    for line in ptxas_summary(nvcc_log):
        name, _, rest = line.partition(": ")
        m = re.match(r"(\d+) registers, (\d+) bytes stack frame, (\d+) "
                     r"bytes spill stores, (\d+) bytes spill loads"
                     r"(?:, (\d+) bytes smem)?", rest)
        if m and re.search(match, name):
            regs.append(int(m.group(1)))
            stack = max(stack, int(m.group(2)))
            spill = max(spill, int(m.group(3)), int(m.group(4)))
            smem = max(smem, int(m.group(5) or 0))
    if not regs:
        raise AssertionError(f"no ptxas report for {match}")
    return {"registers": [min(regs), max(regs)], "stack_bytes": stack,
            "spill_bytes": spill, "smem_bytes": smem}


# the kernels whose rows carry their ptxas report: (source, name match)
PTXAS_ROWS = {"hamming_join": ("hamming_join", "hamming_join_kernel"),
              "join_bits": ("hamming_join", "join_runs_kernel"),
              "bucket_runs": ("hamming_join", "run_(hist|part|place)"),
              "neighbor_sum": ("neighbor_sum", "neighbor_sum_kernel"),
              "count_mono": ("count_mono", "count_mono_"),
              "count_linear": ("count_flat", "CountLinear"),
              "count_packed": ("count_flat", "11CountPacked"),
              "count_packed_block": ("count_flat",
                                     "bin_kernelIy|block_probe_kernel"),
              "count_packed_rows": ("count_mono", "exact_packed_kernel"),
              "anchor_probes": ("anchored", "anchor_probe_kernel"),
              "anchored_wide": ("anchored", "anchored_wide_kernel"),
              "bucket_layouts": ("hamming_join",
                                 "lay_(hist|scan|part|place|expand)"),
              "kmerize": ("count_flat", "kmerize_kernel"),
              "member_scan": ("emit_member", "bin_kernelIt|member_probe"),
              "window_sums": ("est_windows", "window_sums_kernel")}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / INT32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct(a: np.ndarray) -> np.ndarray:
    """np.unique(a) by a sort: numpy >= 2.3's np.unique hashes first,
    and on ~16 M random u64 keys that took ~35 s on the card's host."""
    a = np.sort(a)
    return a[np.concatenate(([True], a[1:] != a[:-1]))[:len(a)]]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over u32 word tensors."""
    from quickmer2_tpu_torch.device import u32
    if a.numel() == 0:
        return 0
    return int((u32(a) - u32(b)).abs().max().item())


def touched(chi, clo, depth, n_buckets) -> tuple[int, int]:
    """Mono-table rows named by the valid windows' codes (chi, clo), and
    buckets with a hit (a nonzero depth word among their 8)."""
    from quickmer2_tpu_torch.ops import monotable
    from quickmer2_tpu_torch.ops.hash import djb_pair
    bucket = djb_pair(chi, clo) & (n_buckets - 1)
    hit = torch.nonzero(depth[:-1]).flatten() // monotable.ENTRIES
    return (int(torch.unique(bucket).numel()),
            int(torch.unique(hit).numel()))


# -- inputs ---------------------------------------------------------------

def make_world(rng):
    """12 Mb realistic genome with a 200 kb segmental duplication (two
    extra copies), its FASTA, and a control bed that excludes the dup,
    its copies and the CNV segment and ends off-chromosome."""
    from tools.realistic_genome import make_genome, to_fasta
    g, dup_start, dup_len = make_genome(rng, GENOME_BASES, dup_len=200_000,
                                        dup_copies=2)
    fa = os.path.join(WORK, "g.fa")
    to_fasta(fa, g)
    seg_start = 4 * len(g) // 5
    seg_len = 100_000
    copies = (2 * GENOME_BASES // 3, 2 * GENOME_BASES // 3 + 2 * dup_len)
    excl = sorted([(dup_start - 500, dup_start + dup_len + 500),
                   (copies[0] - 500, copies[1] + 500),
                   (seg_start - 500, seg_start + seg_len + 500)])
    ctrl = os.path.join(WORK, "ctrl.bed")
    with open(ctrl, "w") as f:
        prev = 0
        for a, b in excl:
            f.write(f"chr1\t{prev}\t{a}\n")
            prev = b
        f.write(f"chr1\t{prev}\t{len(g)}\n")
        f.write("chrZ\t0\t100\n")
    return {"g": g, "fa": fa, "ctrl": ctrl, "excl": excl,
            "seg": (seg_start, seg_start + seg_len)}


def make_small_world(world, rng):
    """The genome's first SMALL_BASES as a FASTA of its own, its control
    bed the main one's cut to it, searched as the main path searches (its
    .qm, .qgc, .bed), and SMALL_READS reads of it: the input of phase 4,
    whose checks hold one path against another and whose count set-ups
    scale with the dictionary. Returns (FASTA, FASTQ)."""
    from tools.realistic_genome import to_fasta
    from quickmer2_tpu_torch.config import SearchConfig
    from quickmer2_tpu_torch.pipelines.search import run_search
    t = time.time()
    g = world["g"][:SMALL_BASES]
    fa = os.path.join(WORK, "m.fa")
    to_fasta(fa, g)
    ctrl = os.path.join(WORK, "m_ctrl.bed")
    with open(ctrl, "w") as f:
        prev = 0
        for a, b in world["excl"]:
            if a >= len(g):
                break
            f.write(f"chr1\t{prev}\t{a}\n")
            prev = b
        if prev < len(g):
            f.write(f"chr1\t{prev}\t{len(g)}\n")
    stats = {}
    run_search(fa, SearchConfig(
        kmer_size=30, edit_distance=2, edit_depth_threshold=100,
        window_size=1000, control_bed=ctrl), verbose=False, stats=stats,
        device="cuda")
    sub = os.path.join(WORK, "sub.fq")
    write_fastq(sub, simulate_reads(rng, g, SMALL_READS, READ_LEN, ERR))
    log(f"phase small world: the first {len(g)} bases searched "
        f"({stats['n_kmers']} k-mers) and {SMALL_READS} reads of them in "
        f"{time.time() - t:.1f} s")
    return fa, sub


def simulate_reads(rng, g, n_reads, read_len, err):
    """Reads as codes: uniform starts, substitutions at `err` per base,
    half reverse complemented."""
    starts = rng.integers(0, len(g) - read_len, size=n_reads)
    reads = g[starts[:, None] + np.arange(read_len)[None, :]]
    n_err = rng.binomial(n_reads * read_len, err)
    er = rng.integers(0, n_reads, size=n_err)
    ec = rng.integers(0, read_len, size=n_err)
    reads[er, ec] = (reads[er, ec] + rng.integers(1, 4, size=n_err)) % 4
    flip = rng.random(n_reads) < 0.5
    reads[flip] = ((reads[flip, ::-1] + 2) % 4).astype(np.uint8)
    return reads


def write_fastq(path, reads):
    lut = np.frombuffer(b"ACTG", np.uint8)
    R, L = reads.shape
    blob = np.empty((R, 7 + 2 * L), np.uint8)
    blob[:, 0:3] = np.frombuffer(b"@r\n", np.uint8)
    blob[:, 3:3 + L] = lut[reads]
    blob[:, 3 + L:6 + L] = np.frombuffer(b"\n+\n", np.uint8)
    blob[:, 6 + L:6 + 2 * L] = ord("I")
    blob[:, 6 + 2 * L] = ord("\n")
    with open(path, "wb") as f:
        f.write(blob.tobytes())


# -- phase 2: kernels against their plain versions ------------------------

def check_count_mono(rng, k, n_keys, n_bases, dev, timed):
    """K2 on a random dictionary with a side table and a batch with read
    separators and N bases; returns a kernel-table row when timed. A
    timed case also runs the kernel at other slice counts P, each
    checked against the plain version, and logs their times."""
    from quickmer2_tpu_torch.device import words
    from quickmer2_tpu_torch.kernels import count_mono as cm
    from quickmer2_tpu_torch.kernels.count_mono import (
        count_mono_step, count_mono_step_plain, partitions_for)
    from quickmer2_tpu_torch.ops import codec, rowpack
    from quickmer2_tpu_torch.ops.monotable import MonoTable
    from quickmer2_tpu_torch.utils import native

    g = rng.integers(0, 4, n_bases).astype(np.uint8)
    canon, valid, _ = native.sliding_canon(g, k)
    hits = canon[valid & (canon != 0) & (rng.random(len(canon)) < 0.3)]
    top = (1 << (2 * k)) - 1
    rand = rng.integers(1, 1 << 62, n_keys, dtype=np.int64).astype(np.uint64)
    keys = distinct(np.concatenate([hits, rand & np.uint64(top)]))
    keys = keys[rng.permutation(len(keys))[:n_keys]]
    hi, lo = codec.split_u64(keys)
    table = MonoTable.build(hi, lo)
    if table.side is None:
        raise AssertionError("the check needs a dictionary with a side table")
    batch = g.copy()
    batch[READ_LEN::READ_LEN + 1] = codec.SEP
    batch[rng.random(n_bases) < 0.01] = codec.SEP
    pk, bits = rowpack.pack_rows(batch[None, :])
    pk_d = torch.from_numpy(pk[0]).to(dev)
    bits_d = torch.from_numpy(bits[0]).to(dev)
    rows = words(table.rows, dev)
    kw = dict(k=k, n_buckets=table.n_buckets, n_bases=n_bases)
    n_parts = partitions_for(table.n_buckets)

    def zero():
        return torch.zeros(table.n_slots + 1, dtype=torch.int32, device=dev)
    d_kernel, d_plain = zero(), zero()
    m_kernel = count_mono_step(pk_d, bits_d, rows, d_kernel, **kw)
    m_plain = count_mono_step_plain(pk_d, bits_d, rows, d_plain, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(d_kernel[:-1], d_plain[:-1]),
              max_abs_err(m_kernel, m_plain))
    n_unres = int(np.unpackbits(m_kernel.cpu().numpy().view(np.uint8)).sum())
    log(f"  count_mono k={k}: {len(keys)} keys, {table.n_buckets} buckets "
        f"(P = {n_parts}), side {table.side.n_kmers} keys, batch {n_bases} "
        f"bases: {int(d_kernel[:-1].sum())} hits, {n_unres} unresolved "
        f"lanes, max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(f"count_mono k={k} disagrees with its plain version")
    if not timed:
        return None
    d_ref = d_plain.clone()
    ms, queued_ms = kernel_ms(
        lambda: count_mono_step(pk_d, bits_d, rows, d_kernel, **kw), 10)
    plain_ms = cuda_ms(
        lambda: count_mono_step_plain(pk_d, bits_d, rows, d_plain, **kw), 2)
    # the same batch at other slice counts (1 = the one-pass kernel),
    # each against the plain version's depth and mask
    sweep = {}
    for p in sorted({1, 4, 8, 16, 32, 64} - {n_parts}):
        d_p = zero()
        m_p = cm.count_mono_launch(pk_d, bits_d, rows, d_p, n_parts=p, **kw)
        torch.cuda.synchronize()
        e_p = max(max_abs_err(d_p[:-1], d_ref[:-1]),
                  max_abs_err(m_p, m_plain))
        if e_p != 0:
            raise AssertionError(f"count_mono at P = {p} disagrees with its "
                                 "plain version")
        sweep[p] = round(cuda_ms(lambda: cm.count_mono_launch(
            pk_d, bits_d, rows, d_p, n_parts=p, **kw), 10), 4)
    # least traffic: packed batch in, each touched row read once, the
    # 32-B sector of each bucket's depth words with a hit read and
    # written once (an atomic moves the whole sector), mask words out;
    # least work: the word-parallel codec and canonical min (~20 int
    # ops), DJB over 8 bytes (~16), 8 entry compares (~16) per window
    n_win = n_bases - k + 1
    codes = rowpack.unpack_rows(pk_d[None], bits_d[None], read_len=n_bases)[0]
    chi, clo, ok = codec.sliding_kmers(codes, k)
    rows_touched, buckets_hit = touched(chi[ok], clo[ok], d_plain,
                                        table.n_buckets)
    n_bytes = (pk.nbytes + bits.nbytes + 64 * rows_touched
               + 64 * buckets_hit + 4 * m_kernel.numel())
    b_ms, b_by = bound_ms(n_bytes, 52 * n_win)
    log(f"  count_mono time {ms:.4f} ms (queued {queued_ms:.4f} ms) at P = "
        f"{n_parts}, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
        f"{rows_touched} rows touched, {buckets_hit} with a hit); ms at "
        f"other P: {sweep}")
    return {"name": "count_mono", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/count_mono.cu",
            "replaces": "quickmer2_tpu/pipelines/count.py:139",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "plain_ms": plain_ms, "partitions": n_parts,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def join_layouts(uniq, occ, k, cpad, cpad_q, dev):
    """Part 0, word chunk 0 and query chunk 0 of the search's own join
    plan at these pads: its queries (the singletons), its interleaved
    chunks and its slow-path routing, built by i'. Returns the layouts,
    the query count, the bucket count and i''s arguments for them
    (positional: the word chunk's codes, occ and live flags as strided
    views, the query chunk's codes; keyword)."""
    from quickmer2_tpu_torch.ops import hamming_join as hj
    plan = hj._JoinPlan(uniq[occ == 1], uniq, occ, k, cpad=cpad,
                        cpad_q=cpad_q, device=dev)
    qsel = plan.query_chunk(0)
    q = plan.queries(qsel)
    lay = plan.layouts(0, 0, q)
    whi_d, wlo_d, wocc_d, wlive_d = plan._words()
    c = plan.chunks[0]
    s, t = plan.ranges[0]
    args = (whi_d[c], wlo_d[c], wocc_d[c], wlive_d[c], q["hi"], q["lo"])
    kw = dict(lo_bit=2 * s, width=2 * (t - s), n_buckets=plan.n_bkts[0],
              cpad=plan.cpad, cpad_q=plan.cpad_q)
    return lay, len(qsel), plan.n_bkts[0], (args, kw)


def host_slots(args, kw):
    """The in-bucket slots the host computed for the sums join before
    i' ranked entries itself: _slots_u8 (np.argsort) of each side's part
    keys, 255 for a dead word. Returns (word slots, query slots) as u8
    tensors on the card and the host seconds they took."""
    from quickmer2_tpu_torch.kernels.hamming_join import part_keys
    from quickmer2_tpu_torch.ops.hamming_join import _slots_u8
    whi, wlo, _, wlive, qhi, qlo = args
    bits = dict(lo_bit=kw["lo_bit"], width=kw["width"])
    wkeys = part_keys(whi, wlo, **bits).cpu().numpy()
    qkeys = part_keys(qhi, qlo, **bits).cpu().numpy()
    live = wlive.cpu().numpy()
    t = time.perf_counter()
    wslot = np.full(len(wkeys), 255, np.uint8)
    wslot[live] = _slots_u8(wkeys[live])
    qslot = _slots_u8(qkeys)
    host_s = time.perf_counter() - t
    dev = whi.device
    return (torch.from_numpy(wslot).to(dev), torch.from_numpy(qslot).to(dev),
            host_s)


def plant_entries(args, kw, rng):
    """i''s inputs with buckets planted by entry order (their keys' other
    entries taken out), each spread over the whole chunk, so that the
    sort's tiles and bins must keep entry order for the layouts to be
    right: key 0 with cpad + 9 live words and 3 dead ones among them (a
    palindrome's rc word), key 1 with cpad_q + 5 queries and 3 words,
    the last key with one word and one query. The word side comes back
    as strided views (every other entry of a buffer), as the join plan's
    interleaved chunks are."""
    from quickmer2_tpu_torch.device import words as as_words
    from quickmer2_tpu_torch.kernels.hamming_join import part_keys
    whi, wlo, wocc, wlive, qhi, qlo = args
    lo_bit, width, B = kw["lo_bit"], kw["width"], kw["n_buckets"]
    cpad, cpad_q = kw["cpad"], kw["cpad_q"]
    keys = (0, 1, B - 1)
    dev = whi.device

    def keep(hi, lo):
        key = part_keys(hi, lo, lo_bit, width)
        return ~torch.isin(key, torch.tensor(keys, device=dev))

    def codes(key_list):
        key = np.asarray(key_list, np.uint64)
        c = rng.integers(0, 1 << 60, len(key)).astype(np.uint64)
        m = np.uint64(((1 << width) - 1) << lo_bit)
        c = (c & ~m) | (key << np.uint64(lo_bit))
        return (as_words((c >> np.uint64(32)).astype(np.uint32), dev),
                as_words((c & np.uint64(0xFFFFFFFF)).astype(np.uint32), dev))

    def spread(kept, planted, stride):
        """kept and planted entries interleaved, the planted ones at
        random places over the whole side; every stride-th entry of a
        buffer."""
        n = kept[0].shape[0] + planted[0].shape[0]
        at = torch.zeros(n, dtype=torch.bool, device=dev)
        at[torch.from_numpy(np.sort(rng.choice(
            n, planted[0].shape[0], replace=False))).to(dev)] = True
        out = []
        for k_, p_ in zip(kept, planted):
            buf = torch.zeros((n, stride), dtype=k_.dtype, device=dev)
            buf[~at, 0] = k_
            buf[at, 0] = p_
            out.append(buf[:, 0])
        return out

    w_keys = [keys[0]] * (cpad + 12) + [keys[1]] * 3 + [keys[2]]
    w_live = np.ones(len(w_keys), bool)
    w_live[rng.choice(cpad + 12, 3, replace=False)] = False
    wk = keep(whi, wlo)
    wh, wl = codes(w_keys)
    words_ = spread([whi[wk], wlo[wk], wocc[wk], wlive[wk]],
                    [wh, wl, torch.from_numpy(rng.integers(
                        1, 256, len(w_keys)).astype(np.uint8)).to(dev),
                     torch.from_numpy(w_live).to(dev)], 2)
    qk = keep(qhi, qlo)
    qh, ql = codes([keys[1]] * (cpad_q + 5) + [keys[2]])
    queries = spread([qhi[qk], qlo[qk]], [qh, ql], 1)
    return tuple(words_) + tuple(queries)


def check_bucket_layouts(args, kw, label):
    """i' against its plain version (bucket_layouts_plain: torch's stable
    sort for the ranks) and, bit for bit, against _bucket_layouts fed the
    host's slots (host_slots) on one call's inputs; returns the largest
    difference (0, else it raises)."""
    from quickmer2_tpu_torch.kernels.hamming_join import (
        bucket_layouts, bucket_layouts_plain)
    from quickmer2_tpu_torch.ops.hamming_join import _bucket_layouts
    got = bucket_layouts(*args, **kw)
    want = bucket_layouts_plain(*args, **kw)
    wslot, qslot, _ = host_slots(args, kw)
    whi, wlo, wocc, _, qhi, qlo = args
    host = _bucket_layouts(whi, wlo, wocc, wslot, qhi, qlo, qslot, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    err_host = max(max_abs_err(g, h) for g, h in zip(got, host))
    live_w = int((got[5] != args[4].shape[0]).sum())
    log(f"  bucket_layouts{label}: {args[0].shape[0]} words (stride "
        f"{args[0].stride(0)}, {int((~args[3]).sum())} dead), "
        f"{args[4].shape[0]} queries, {int((got[2] != 0).sum())} word and "
        f"{live_w} query lanes live, max |kernel - plain| = {err}, max "
        f"|kernel - host slots' layouts| = {err_host}")
    if err != 0 or err_host != 0:
        raise AssertionError(f"bucket_layouts{label} disagrees with its "
                             "plain version or the host slots' layouts")
    return err


def plant_buckets(lay, nq, cpad, cpad_q, rng):
    """Hand-planted buckets on a copy of the layouts, at the shapes K1
    branches on: bucket 0 with words in two lanes of three and queries in
    six of seven (> 1024 pairs at pads 64/32), bucket 1 with 3
    words and 12 queries (36 > 32 pairs), bucket 2 with live words and no
    live query. The planted queries take fresh indices nq.. and are
    near some of the bucket's words (one base apart), so their terms are
    nonzero. Returns the layouts and the new query count."""
    from quickmer2_tpu_torch.device import words as as_words
    dh, dl, docc, qh, ql, qidx = (t.clone() for t in lay)
    extra = 2 * cpad_q
    qidx[qidx == nq] = nq + extra

    def words(b, lanes):
        o = torch.tensor(lanes, device=dh.device) + b * cpad
        dh[b * cpad:(b + 1) * cpad] = 0
        dl[b * cpad:(b + 1) * cpad] = 0
        docc[b * cpad:(b + 1) * cpad] = 0
        for t, hi in ((dh, 1 << 20), (dl, 1 << 32), (docc, 256)):
            t[o] = as_words(rng.integers(1, hi, len(o)), dh.device)
        return o

    def queries(b, lanes, first, wo):
        qidx[b * cpad_q:(b + 1) * cpad_q] = nq + extra
        for n, j in enumerate(lanes):
            o = b * cpad_q + j
            w = wo[n % len(wo)]
            qidx[o] = first + n
            qh[o] = dh[w]
            ql[o] = dl[w] ^ (1 << int(rng.integers(0, 31)))
        return first + len(lanes)

    wo = words(0, [j for j in range(cpad) if j % 3 != 1])
    nxt = queries(0, [j for j in range(cpad_q) if j % 7 != 3], nq, wo)
    wo = words(1, [0, 5, 9])
    queries(1, list(range(5, 17)), nxt, wo)
    words(2, list(range(10)))
    qidx[2 * cpad_q:3 * cpad_q] = nq + extra
    return (dh, dl, docc, qh, ql, qidx), nq + extra


def time_bucket_layouts(args, kw, err):
    """i''s kernel-table row, timed on the search's own layouts (its
    passes by torch.profiler, each summed over both sides) beside its
    plain version, one torch.sort of each side's part keys (stable: the
    order only, no layouts) and the host slots that the sums join no
    longer computes (host seconds for this call's two sides). Least
    traffic: each output lane written once (12 B a word lane and a query
    lane) and each entry's code (8 B) and, for a word, occ and live flag
    (1 B each) read once; ~10 int ops an entry. The count of the slot
    design (a slot byte read for every entry) beside it."""
    from quickmer2_tpu_torch.kernels.hamming_join import (
        bucket_layouts, bucket_layouts_plain, part_keys)
    ms, queued_ms = kernel_ms(lambda: bucket_layouts(*args, **kw), 10)
    passes = profile_kernels(lambda: bucket_layouts(*args, **kw), 3,
                             "bucket_layouts")
    plain_ms = cuda_ms(lambda: bucket_layouts_plain(*args, **kw), 3)
    bits = dict(lo_bit=kw["lo_bit"], width=kw["width"])
    keys = [part_keys(args[0], args[1], **bits),
            part_keys(args[4], args[5], **bits)]
    lib_ms = cuda_ms(lambda: [torch.sort(x, stable=True) for x in keys], 3)
    host_s = host_slots(args, kw)[2]
    n_w, nq = args[0].shape[0], args[4].shape[0]
    lanes = kw["n_buckets"] * (kw["cpad"] + kw["cpad_q"]) + 2
    n_bytes = 12 * lanes + 10 * n_w + 8 * nq
    b_ms, b_by = bound_ms(n_bytes, 10 * (n_w + nq))
    old_bytes = 12 * lanes + 10 * n_w + 9 * nq
    old_ms, _ = bound_ms(old_bytes, 10 * (n_w + nq))
    log(f"  bucket_layouts time {ms:.4f} ms (queued {queued_ms:.4f} ms; "
        f"by torch.profiler {passes}), "
        f"plain {plain_ms:.4f} ms, torch.sort of both sides' keys "
        f"{lib_ms:.4f} ms, the host slots of this call {host_s:.3f} s; "
        f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB; {lanes} "
        f"lanes, {n_w} words, {nq} queries; with a slot byte an entry "
        f"{old_bytes / 1e6:.1f} MB, {old_ms:.4f} ms)")
    return {"name": "bucket_layouts", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/hamming_join.cu",
            "replaces": "quickmer2_tpu/ops/hamming_join.py:114",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "passes_ms": passes, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "slot_design_bound_ms": old_ms,
            "host_slots_s": host_s, "library_ms": lib_ms}


def check_hamming_join(uniq, occ, k, cpad, cpad_q, dev, timed):
    """i' (K1's layouts) and K1 on the search's own layouts, then on
    hand-planted buckets. Timed: returns K1's and i''s kernel-table
    rows."""
    from quickmer2_tpu_torch.kernels.hamming_join import (
        join_compare, join_compare_plain)
    from quickmer2_tpu_torch.ops.hamming_join import _part_masks
    lay, nq, n_buckets, (l_args, l_kw) = join_layouts(uniq, occ, k, cpad,
                                                     cpad_q, dev)
    l_err = max(check_bucket_layouts(l_args, l_kw, f" {cpad}/{cpad_q}"),
                check_bucket_layouts(
                    plant_entries(l_args, l_kw, np.random.default_rng(cpad)),
                    l_kw, f" {cpad}/{cpad_q}, planted buckets"))
    kw = dict(e=2, masks=_part_masks(k), n_buckets=n_buckets, cpad=cpad,
              cpad_q=cpad_q)

    def compare(lay, nq, label):
        s_kernel = torch.zeros(nq + 1, dtype=torch.int32, device=dev)
        s_plain = torch.zeros_like(s_kernel)
        join_compare(*lay, s_kernel, **kw)
        join_compare_plain(*lay, s_plain, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(s_kernel[:-1], s_plain[:-1])
        live_w = (lay[2][:-1].view(n_buckets, cpad) != 0).sum(1)
        live_q = (lay[5][:-1].view(n_buckets, cpad_q) != nq).sum(1)
        pairs = (live_w * live_q).to(torch.int64)
        log(f"  hamming_join cpad {cpad}/{cpad_q}{label}: {n_buckets} "
            f"buckets, {nq} queries, {int(pairs.sum())} live pairs (most "
            f"in a bucket {int(pairs.max())}), "
            f"{int((s_kernel[:-1] != 0).sum())} nonzero sums, "
            f"max |kernel - plain| = {err}")
        if err != 0:
            raise AssertionError(f"hamming_join {cpad}/{cpad_q}{label} "
                                 "disagrees with its plain version")
        return err, live_w.to(torch.int64), live_q.to(torch.int64), s_kernel

    err, live_w, live_q, s_kernel = compare(lay, nq, "")
    planted, nq_p = plant_buckets(lay, nq, cpad, cpad_q,
                                  np.random.default_rng(cpad))
    compare(planted, nq_p, ", planted buckets")
    del planted
    if not timed:
        return None
    ms, queued_ms = kernel_ms(lambda: join_compare(*lay, s_kernel, **kw), 10)
    s_plain = torch.zeros_like(s_kernel)
    plain_ms = cuda_ms(lambda: join_compare_plain(*lay, s_plain, **kw), 1)
    del lay
    torch.cuda.empty_cache()
    layout = time_bucket_layouts(l_args, l_kw, l_err)
    # least traffic: qidx of every query lane and occ of every word lane
    # of a bucket with a live query (they tell which lanes are live), the
    # (hi, lo) codes of the live words there and of the live queries,
    # each live query's sum read and written once; least work: ~20 int
    # ops per live pair. The all-lanes count beside it reads occ of
    # every bucket and the codes of every live word.
    has_q = live_q > 0
    n_live_w, n_live_q = int(live_w[has_q].sum()), int(live_q.sum())
    pairs = int((live_w * live_q).sum())
    n_bytes = (4 * (n_buckets * cpad_q + cpad * int(has_q.sum()))
               + 8 * (n_live_w + n_live_q) + 8 * n_live_q)
    b_ms, b_by = bound_ms(n_bytes, 20 * pairs)
    all_bytes = (4 * n_buckets * (cpad + cpad_q) + 8 * int(live_w.sum())
                 + 16 * n_live_q)
    all_ms, _ = bound_ms(all_bytes, 20 * pairs)
    log(f"  hamming_join time {ms:.4f} ms (queued {queued_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
        f"{20 * pairs / 1e9:.2f} G ops; {n_live_w} live words in "
        f"{int(has_q.sum())} buckets with a live query, {n_live_q} live "
        f"queries; counting occ of every bucket {all_bytes / 1e6:.1f} MB, "
        f"{all_ms:.4f} ms); layouts (i') {layout['ms']:.4f} ms")
    return {"name": "hamming_join", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/hamming_join.cu",
            "replaces": "tools/proto_join2d.py:55",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "plain_ms": plain_ms, "layout_ms": layout["ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}, layout


HOST_SLOW_QUERIES = 5_000      # slow queries the host slow path is timed on


def slow_queries(uniq, occ, k, dev):
    """The queries that the search's own join plan (pads 64/32) sends to
    its slow path, as the search routes them."""
    from quickmer2_tpu_torch.ops import hamming_join as hj
    queries = uniq[occ == 1]
    plan = hj._JoinPlan(queries, uniq, occ, k, cpad=64, cpad_q=32,
                        device=dev)
    for qc in range(plan.n_qchunks):
        plan.query_chunk(qc)
    return queries[plan.slow]


def compare_neighbor_sum(queries, table, k, e, label, dev, trace=None,
                         plain_queries=None):
    """K6 against its plain version on one query set (the plain version
    on its first plain_queries only, where given); table: (rows,
    n_buckets, key filter) from _occ_table. Returns (max |kernel -
    plain|, the kernel's arguments, its sums). With a `trace`, the
    filter must drop no hit."""
    from quickmer2_tpu_torch.device import words
    from quickmer2_tpu_torch.kernels.neighbor_sum import (
        neighbor_sum, neighbor_sum_plain)
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops.hamming_join import _rc_np
    rows, n_buckets, filt = table
    halves = codec.split_u64(queries) + codec.split_u64(_rc_np(queries, k))
    args = [words(a, dev) for a in halves] + [rows, filt]
    kw = dict(k=k, e=e, n_buckets=n_buckets)
    n_plain = plain_queries or len(queries)
    out_k = neighbor_sum(*args, **kw)
    out_p = neighbor_sum_plain(*(a[:n_plain] for a in args[:4]), rows, filt,
                               slab_pairs=1 << 24, trace=trace, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(out_k[:n_plain], out_p)
    log(f"  neighbor_sum {label} k={k} e={e}: {len(queries)} queries "
        f"({n_plain} against the plain version), {n_buckets} buckets, "
        f"{int((out_k != 0).sum())} nonzero sums, "
        f"max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(f"neighbor_sum {label} k={k} e={e} disagrees "
                             "with its plain version")
    if trace is not None:
        log(f"  key filter ({filt.numel()} words): {trace['passed']} of "
            f"{trace['probes']} probes pass "
            f"({trace['passed'] / trace['probes']:.4%}), hits it drops: "
            f"{trace['missed']}, {trace['rows_touched']} table rows named "
            f"by passing probes, {trace['filter_sectors']} filter sectors "
            f"named")
        if trace["missed"] != 0:
            raise AssertionError("the key filter dropped a hit")
    return err, (args, kw), out_k


# least integer operations of K6 a probe: two substituted bases (4), put
# into both strands' codes (12), the canonical min of two 64-bit codes
# (5), the chosen strand's hash by two deltas (8), the filter word's
# index and load (4), its three bit positions (7), the test (2); and a
# probe that passes the filter: two bucket indices, four entry compares
# (16). Without the filter every probe reads the table and hashes 8
# bytes: ~70 ops a probe, the count printed beside the bound.
K6_OPS, K6_PASS_OPS, K6_OPS_UNFILTERED = 42, 16, 70
PROBE_BATCH = 1 << 20          # _device_filter's queries a launch
PROBE_PLAIN = 1 << 18          # of those, held against the plain version


def check_neighbor_sum(uniq, occ, k, dev):
    """K6 on the search's own slow set against its plain version (timed;
    the key filter's pass rate and dropped hits from the plain version's
    trace) and, on HOST_SLOW_QUERIES of those queries, against the host
    slow path (timed); then on one probe-filter batch of PROBE_BATCH
    queries (timed), against the plain version on its first
    PROBE_PLAIN. Returns the kernel-table row and the table (rows,
    n_buckets, key filter)."""
    from quickmer2_tpu_torch.device import to_numpy_u32
    from quickmer2_tpu_torch.kernels.neighbor_sum import (
        neighbor_sum, neighbor_sum_plain)
    from quickmer2_tpu_torch.ops.hamming_join import _slow_sums_sorted_np
    from quickmer2_tpu_torch.pipelines.search import _occ_table
    t = time.time()
    table = _occ_table(uniq, occ, dev)
    torch.cuda.synchronize()
    table_s = time.time() - t
    slow = slow_queries(uniq, occ, k, dev)
    trace = {}
    err, (args, kw), out_k = compare_neighbor_sum(
        slow, table, k, 2, "slow set", dev, trace)
    ms, queued_ms = kernel_ms(lambda: neighbor_sum(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: neighbor_sum_plain(*args, slab_pairs=1 << 24,
                                                  **kw), 1, warm=0)
    n_host = min(HOST_SLOW_QUERIES, len(slow))
    t = time.perf_counter()
    host = _slow_sums_sorted_np(slow[:n_host], uniq, occ, k, 2)
    host_s = time.perf_counter() - t
    if not np.array_equal(host, to_numpy_u32(out_k)[:n_host]):
        raise AssertionError("neighbor_sum disagrees with the host slow path")
    host_all_s = host_s * len(slow) / n_host
    log(f"  host slow path: {n_host} of the {len(slow)} slow queries in "
        f"{host_s:.2f} s, equal to the kernel; the whole slow set at that "
        f"rate {host_all_s:.1f} s, against the packed table's and its "
        f"filter's build {table_s:.2f} s + K6 {ms:.4f} ms")
    # least traffic: each 32-B table row that a passing probe names and
    # each 32-B filter sector that a probe names, read once; the
    # queries' four words in, one sum out; the edit words
    m = trace["probes"] // max(len(slow), 1)
    n_bytes = (32 * trace["rows_touched"] + 32 * trace["filter_sectors"]
               + 20 * len(slow) + 4 * m)
    n_ops = K6_OPS * trace["probes"] + K6_PASS_OPS * trace["passed"]
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    old_ms, old_by = bound_ms(0, K6_OPS_UNFILTERED * trace["probes"])
    log(f"  neighbor_sum time {ms:.4f} ms (queued {queued_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.1f} G ops at {K6_OPS} a "
        f"probe + {K6_PASS_OPS} a passing probe; unfiltered count "
        f"{K6_OPS_UNFILTERED} a probe: {old_ms:.4f} ms, {old_by})")

    queries = uniq[occ == 1][:PROBE_BATCH]
    ptrace = {}
    _, (pargs, pkw), _ = compare_neighbor_sum(
        queries, table, k, 2, "probe-filter batch", dev, ptrace,
        plain_queries=PROBE_PLAIN)
    p_ms, p_queued_ms = kernel_ms(lambda: neighbor_sum(*pargs, **pkw), 10)
    log(f"  neighbor_sum probe-filter batch: {len(queries)} queries in "
        f"{p_ms:.4f} ms (queued {p_queued_ms:.4f} ms), "
        f"{len(queries) * m / p_queued_ms / 1e6:.2f} G probes/s; slow set "
        f"{len(slow) * m / queued_ms / 1e6:.2f} G probes/s")
    row = {"name": "neighbor_sum", "route": "cuda",
           "source": "quickmer2_tpu_torch/csrc/neighbor_sum.cu",
           "replaces": "quickmer2_tpu/ops/editdist.py:152",
           "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
           "plain_ms": plain_ms, "slow_queries": len(slow),
           "filter_pass": trace["passed"] / trace["probes"],
           "filter_missed": trace["missed"],
           "probe_batch_queries": len(queries), "probe_batch_ms": p_ms,
           "probe_batch_queued_ms": p_queued_ms,
           "probe_batch_filter_pass": ptrace["passed"] / ptrace["probes"],
           "host_ms_per_query": host_s / n_host * 1e3,
           "table_s": table_s,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return row, table


def check_neighbor_sum_small(k, dev):
    """K6 at k on a random genome with planted one- and two-substitution
    copies, its distinct k-mers in a packed table with its key filter,
    e = 1 and 2. 1 Mb, but 32 kb at k < 17 (see
    check_neighbor_bits_small)."""
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.pipelines.search import _occ_table
    rng = np.random.default_rng(100 + k)
    g = rng.integers(0, 4, 1 << (15 if k < 17 else 20)).astype(np.uint8)
    for p in rng.integers(0, len(g) - 4 * k, len(g) >> 10):
        q = (p + 2 * k + 5000) % (len(g) - 2 * k)
        g[q:q + 2 * k] = g[p:p + 2 * k]
        for d in rng.integers(0, k, int(rng.integers(1, 3))):
            g[q + k // 2 + d] = (g[q + k // 2 + d] + 1) % 4
    canon, valid = codec.sliding_kmers_np(g, k)
    uniq, cnt = np.unique(canon[valid & (canon != 0)], return_counts=True)
    occ = np.minimum(cnt, 255).astype(np.uint8)
    table = _occ_table(uniq, occ, dev)
    for e in (1, 2):
        compare_neighbor_sum(uniq[:50_000], table, k, e, "small", dev, {})


FILTER_STRIDE = 4    # check_filters takes every 4th unique query


def check_filters(uniq, occ, table, k, dev):
    """The two device filters on every FILTER_STRIDE-th query of the
    search's unique set (against all of it): the hamming join with K6 as
    its slow path and the probe filter (K6 over every query), timed;
    their sums must be equal."""
    from quickmer2_tpu_torch.ops.hamming_join import hamming_neighbor_sums
    from quickmer2_tpu_torch.pipelines.search import _device_filter
    queries = uniq[occ == 1][::FILTER_STRIDE]
    st = {}
    t = time.time()
    sums_h = hamming_neighbor_sums(queries, uniq, occ, k, 2,
                                   packed_rows=table[0],
                                   n_buckets_packed=table[1],
                                   packed_filter=table[2], device=dev,
                                   stats=st)
    hamming_s = time.time() - t
    t = time.time()
    sums_p = _device_filter(queries, table, k, 2, PROBE_BATCH)
    probe_s = time.time() - t
    log(f"  filters on {len(queries)} queries: hamming {hamming_s:.2f} s "
        f"(join {st['join_s']:.2f} s, slow path {st['slow_s']:.2f} s for "
        f"{st['n_slow']} queries), probe {probe_s:.2f} s; sums equal: "
        f"{np.array_equal(sums_h, sums_p)}")
    if not np.array_equal(sums_h, sums_p):
        raise AssertionError("the hamming and the probe filter disagree")
    return {"hamming_s": hamming_s, "probe_s": probe_s}


# -- phase 2, anchored path: K4, K3 (tier 1, tier 2), K2r -------------------

ANCHOR_READ_LEN = 160          # the row width the count autodetects at 150 bp
K4_CHUNK = 1 << 23             # build_neighbor_bits_device's chunk


def anchored_setup(fa, dev):
    """The smoke genome's anchored index from its search's dictionary,
    built on the card without a .qai (K4 sweeps its neighbor bits), and
    a counter with the main path's options (row width, batch, tiers)."""
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.ops import anchored
    dic = Dictionary.from_qm(fa + ".qm")
    stream, pos = anchored._genome_stream_and_positions(dic, fa)
    index = anchored.AnchoredIndex.build(stream, pos, dic.kmers_in_order,
                                         dic.kmer_size, device=dev)
    counter = anchored.AnchoredDepthCounter(index, dic.kmer_size,
                                            ANCHOR_READ_LEN,
                                            prefetch_puts=False, device=dev)
    return stream, dic.kmers_in_order, index, counter


def rows_of(reads):
    """Read codes u8[R, 150] → the count's SEP-padded rows u8[R, 160]."""
    from quickmer2_tpu_torch.ops import codec
    rows = np.full((len(reads), ANCHOR_READ_LEN), codec.SEP, np.uint8)
    rows[:, :reads.shape[1]] = reads
    return rows


def packed_on(rows, dev):
    from quickmer2_tpu_torch.ops import rowpack
    fmt, pk, aux = rowpack.pack_batch(rows)
    return (fmt, torch.from_numpy(pk).to(dev),
            rowpack.aux_tensor(fmt, aux).to(dev), pk.nbytes + aux.nbytes)


def check_key_filter(index, dev):
    """The key filter of the smoke's table (K4's first launch)."""
    from quickmer2_tpu_torch.kernels.neighbor_bits import (
        filter_words_for, key_filter, key_filter_plain)
    n_words = filter_words_for(index.n_kmers)
    kw = dict(n_buckets=index.n_buckets, n_words=n_words)
    f_kernel = key_filter(index.rows, **kw)
    f_plain = key_filter_plain(index.rows, n_words=n_words)
    torch.cuda.synchronize()
    err = max_abs_err(f_kernel, f_plain)
    log(f"  key_filter: {index.n_kmers} keys, {n_words} words "
        f"({4 * n_words / 2**20:.0f} MiB, "
        f"{32 * n_words / index.n_kmers:.2f} bits a key), "
        f"max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError("key_filter disagrees with its plain version")
    ms, queued_ms = kernel_ms(lambda: key_filter(index.rows, **kw), 10)
    plain_ms = cuda_ms(lambda: key_filter_plain(index.rows, n_words=n_words),
                       1, warm=0)
    # least traffic: every table row's 32-B sector in (both entries'
    # keys lie in it), the filter out; least work: ~30 int ops per key
    # (DJB, word, three bits) and a test per entry
    n_bytes = 32 * index.n_buckets + 4 * n_words
    n_ops = 30 * index.n_kmers + 2 * 2 * index.n_buckets
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    log(f"  key_filter time {ms:.4f} ms (queued {queued_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB)")
    return f_kernel, {
        "name": "key_filter", "route": "cuda",
        "source": "quickmer2_tpu_torch/csrc/neighbor_bits.cu",
        "replaces": "quickmer2_tpu/ops/anchored.py:388",
        "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_neighbor_bits(stream, index, filt, k, dev):
    """K4 on the first K4_CHUNK windows of the genome stream."""
    from quickmer2_tpu_torch.kernels.neighbor_bits import (
        neighbor_bits, neighbor_bits_plain)
    seg = torch.from_numpy(np.ascontiguousarray(
        stream[:K4_CHUNK + k - 1])).to(dev)
    kw = dict(n_buckets=index.n_buckets, k=k)
    out_k = neighbor_bits(seg, index.rows, filt, **kw)
    trace = {}
    out_p = neighbor_bits_plain(seg, index.rows, filt, trace=trace, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(out_k, out_p)
    log(f"  neighbor_bits k={k}: {seg.numel()} bases, {trace['probes']} "
        f"probes, {trace['passed']} pass the filter "
        f"({trace['passed'] / trace['probes']:.4%}; hits it drops: "
        f"{trace['missed']}), {trace['rows_touched']} of {index.n_buckets} "
        f"table rows named by them, {int((out_k != 0).sum())} flagged "
        f"bases, max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError("neighbor_bits disagrees with its plain version")
    ms, queued_ms = kernel_ms(
        lambda: neighbor_bits(seg, index.rows, filt, **kw), 3)
    plain_ms = cuda_ms(lambda: neighbor_bits_plain(seg, index.rows, filt,
                                                   **kw), 1, warm=0)
    # least traffic: the chunk in, one byte out per base, the filter
    # once, each 32-B table row named by a probe that passes the filter
    # once. Least work, ~30 int ops per probe: the substituted base (2),
    # put into both strands' codes (6), canonical min of two 64-bit
    # codes (5), the chosen strand's hash by its delta (4), the filter
    # word's index and load (4), its three bit positions (7), the test
    # (2); ~16 more per passing probe (two bucket indices, four entry
    # compares) and ~4 per window offset. An unfiltered sweep reads two
    # random 32-B sectors per probe.
    n_bytes = (2 * seg.numel() + 4 * filt.numel()
               + 32 * trace["rows_touched"])
    n_ops = (30 * trace["probes"] + 16 * trace["passed"]
             + 4 * k * seg.numel())
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    log(f"  neighbor_bits time {ms:.4f} ms (queued {queued_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
        f"{n_ops / 1e9:.2f} G ops); unfiltered probes' random sectors "
        f"{64 * trace['probes'] / 1e9:.1f} GB, filter sectors "
        f"{32 * trace['probes'] / 1e9:.1f} GB + {64 * trace['passed'] / 1e9:.2f}"
        f" GB of table rows")
    return {"name": "neighbor_bits", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/neighbor_bits.cu",
            "replaces": "quickmer2_tpu/ops/anchored.py:388",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_neighbor_bits_small(k, dev):
    """K4 and its filter at k on a random genome whose unique k-mers are
    the dictionary, with planted one-substitution copies (so that the
    bitmap has hits at every k), in one chunk. 1 Mb, but 32 kb at k < 17:
    there the code's high word is 0 and DJB takes ~9.4 M values only, so
    a larger dictionary overfills the two-choice table's buckets."""
    from quickmer2_tpu_torch.kernels.neighbor_bits import (
        filter_words_for, key_filter, key_filter_plain, neighbor_bits,
        neighbor_bits_plain)
    from quickmer2_tpu_torch.device import words
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops.packed_table import PackedTable
    rng = np.random.default_rng(k)
    g = rng.integers(0, 4, 1 << (15 if k < 17 else 20)).astype(np.uint8)
    for p in rng.integers(0, len(g) - 4 * k, len(g) >> 12):
        q = (p + 2 * k + 5000) % (len(g) - 2 * k)
        g[q:q + 2 * k] = g[p:p + 2 * k]
        g[q + k] = (g[q + k] + 1) % 4
    g[rng.random(len(g)) < 1e-4] = codec.SEP
    canon, valid = codec.sliding_kmers_np(g, k)
    ok = valid & (canon != 0)
    uniq, cnt = np.unique(canon[ok], return_counts=True)
    hi, lo = codec.split_u64(uniq[cnt == 1])
    table = PackedTable.build(hi, lo, np.arange(len(hi), dtype=np.uint32))
    rows = words(table.rows, dev)
    n_words = filter_words_for(len(hi))
    filt = key_filter(rows, n_buckets=table.n_buckets, n_words=n_words)
    err = max_abs_err(filt, key_filter_plain(rows, n_words=n_words))
    seg = torch.from_numpy(g).to(dev)
    kw = dict(n_buckets=table.n_buckets, k=k)
    out_k = neighbor_bits(seg, rows, filt, **kw)
    out_p = neighbor_bits_plain(seg, rows, filt, **kw)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(out_k, out_p))
    log(f"  neighbor_bits + key_filter k={k}: {len(g)} bases, {len(hi)} "
        f"keys, {n_words} words, {int((out_k != 0).sum())} flagged bases, "
        f"max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(f"neighbor_bits k={k} disagrees with its plain "
                             "version")


BITS_TILE = 2_000_000     # hamming_neighbor_bits' tile of genome windows


def compare_runs(got, want, label):
    """bucket_runs (K5's counting sort) against its plain version: the
    offsets, and the runs' rows up to their end; returns their length."""
    n = int(want[-1][-1])
    if not torch.equal(got[-1], want[-1]) or any(
            max_abs_err(a[:n], b[:n]) != 0 for a, b in zip(got[:-1], want)):
        raise AssertionError(f"bucket_runs{label} disagrees with its plain "
                             "version")
    return n


def compare_join_bits(runs_w, runs_q, nq, k, part, label):
    """K5 against its plain version on one call's runs; returns (max
    |kernel - plain|, the kernel's planes, the call's live pairs, the
    buckets holding a live query, the live words in them)."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.kernels.hamming_join import (
        join_bits, join_bits_plain, part_keys)
    dev = runs_w[0].device
    p_k = torch.zeros((nq + 1, 4), dtype=torch.int32, device=dev)
    p_p = torch.zeros_like(p_k)
    join_bits(*runs_w, *runs_q, p_k, k=k, **part)
    join_bits_plain(*runs_w, *runs_q, p_p, k=k, **part)
    torch.cuda.synchronize()
    err = max_abs_err(p_k[:-1], p_p[:-1])
    n = int(u32(runs_q[2][-1]))
    key = part_keys(runs_q[0][:n, 0], runs_q[0][:n, 1], **part)
    woff = u32(runs_w[1])
    per_q = woff[key + 1] - woff[key]
    buckets = torch.unique(key)
    pairs = int(per_q.sum())
    live_w = int((woff[buckets + 1] - woff[buckets]).sum())
    log(f"  join_bits{label}: {n} live queries in {buckets.numel()} "
        f"buckets, {live_w} live words there, {pairs} live pairs (most for "
        f"a query {int(per_q.max()) if n else 0}), "
        f"{int((p_k[:-1] != 0).any(1).sum())} rows with a bit, max |kernel "
        f"- plain| = {err}")
    if err != 0:
        raise AssertionError(f"join_bits{label} disagrees with its plain "
                             "version")
    return err, p_k, pairs, int(buckets.numel()), live_w


def planted_join(w, dict_kmers, k, dev):
    """K5 and its counting sort on a planted call, part 0 at pads 240/240:
    a query's bucket holds 245 words, 185 two substitutions from it and
    then 60 one substitution from it (every offset outside the part, all
    three other bases), so the pad cuts five of those; 60 queries share
    that bucket, the query itself on alternating strands, each of which
    must carry 55 bits; and a query one base from all-A beside a word one
    substitution from it (no bucket holds a hole now, so the code (0, 0)
    is no word)."""
    from quickmer2_tpu_torch.device import words
    from quickmer2_tpu_torch.kernels.hamming_join import (
        bucket_runs, bucket_runs_plain)
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops import hamming_join as hj
    s, t = w.ranges[0]
    q0 = int(dict_kmers[12345])
    outside = [p for p in range(k) if not s <= p < t]
    near = [q0 ^ (d << (2 * p)) for p in outside for d in (1, 2, 3)]
    far = [q0 ^ (1 << (2 * a)) ^ (2 << (2 * b)) for a in outside
           for b in outside if a < b]
    planted = np.array(far[:185] + near[:60], np.uint64)
    wk = np.concatenate([planted, np.array([(1 << 4) | (2 << 2 * t)],
                                           np.uint64)])
    qk = np.concatenate([np.full(60, q0, np.uint64),
                         np.array([1 << 4], np.uint64)])
    qfwd = np.arange(len(qk)) % 2 == 0
    part = w._part_bits(0)
    whi, wlo = codec.split_u64(wk)
    qhi, qlo = codec.split_u64(qk)
    wslot = hj._slots_u8(hj._extract_part_np(whi, wlo, s, t))
    qslot = hj._slots_u8(hj._extract_part_np(qhi, qlo, s, t))
    args_w = (words(whi, dev), words(wlo, dev),
              torch.from_numpy(wslot).to(dev))
    args_q = (words(qhi, dev), words(qlo, dev),
              torch.from_numpy(qslot).to(dev))
    fwd_d = torch.from_numpy(qfwd).to(dev)
    runs_w = bucket_runs(*args_w, cap=240, **part)
    runs_q = bucket_runs(*args_q, cap=240, fwd=fwd_d, **part)
    compare_runs(runs_w, bucket_runs_plain(*args_w, cap=240, **part),
                 ", planted words")
    compare_runs(runs_q, bucket_runs_plain(*args_q, cap=240, fwd=fwd_d,
                                           **part), ", planted queries")
    _, planes, _, _, _ = compare_join_bits(runs_w, runs_q, len(qk), k, part,
                                           ", planted call at 240/240")
    from quickmer2_tpu_torch.device import popcount32, u32
    bits = popcount32(u32(planes[:len(qk)])).sum(1).tolist()
    if len(near) < 60 or bits[:60] != [55] * 60 or bits[60] != 1:
        raise AssertionError(f"planted call: bits {bits}")


def sort_library_ms(hi, lo, slot, cap, part) -> float:
    """The one library call beside bucket_runs: torch.sort of key * 256 +
    slot over the entering entries (it yields their order, not the
    offsets)."""
    from quickmer2_tpu_torch.kernels.hamming_join import part_keys
    s = slot.to(torch.int64)
    v = (part_keys(hi, lo, **part) * 256 + s)[s < cap]
    return cuda_ms(lambda: torch.sort(v), 5)


def largest_bin(off, n, width, tags) -> tuple[int, int, int]:
    """(bins, entries of the largest coarse bin, stage entries) of one
    bucket_runs call's offsets under runs_plan."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.kernels.hamming_join import runs_plan
    shift, stage = runs_plan(n, width, tags)
    o = u32(off)[::1 << shift]
    return (1 << (width - shift), int((o[1:] - o[:-1]).max()), stage)


def check_bucket_runs_edges(w, dev):
    """bucket_runs against its plain version on edge inputs: the smoke's
    word chunk keyed by a 24-bit part (2^24 keys, the widest); a skewed
    query set whose first coarse bin holds more entries than the place
    pass stages (so they are stored straight); caps 1 and 255; every slot
    at or over the cap; n = 0."""
    from quickmer2_tpu_torch.device import to_numpy_u32, words
    from quickmer2_tpu_torch.kernels.hamming_join import (
        bucket_runs, bucket_runs_plain)
    from quickmer2_tpu_torch.ops import hamming_join as hj

    def both(hi, lo, slot, label, fwd=None, **part):
        got = bucket_runs(hi, lo, slot, fwd=fwd, **part)
        n = compare_runs(got, bucket_runs_plain(hi, lo, slot, fwd=fwd,
                                                **part), label)
        bins, most, stage = largest_bin(got[-1], hi.shape[0], part["width"],
                                        fwd is not None)
        log(f"  bucket_runs{label}: {hi.shape[0]} entries, {n} in the runs, "
            f"{bins} coarse bins, the largest {most} entries (stage "
            f"{stage}), equal to the plain version")
        return most, stage

    c = w.chunks[0]
    live = w.live[c]
    key24 = hj._extract_part_np(to_numpy_u32(w.whi_d[c]),
                                to_numpy_u32(w.wlo_d[c]), 0, 12)
    s24 = np.full(len(live), 255, np.uint8)
    s24[live] = hj._slots_u8(key24[live])
    both(w.whi_d[c], w.wlo_d[c], torch.from_numpy(s24).to(dev),
         ", words at width 24", cap=64, lo_bit=0, width=24)
    rng = np.random.default_rng(13)
    n = 2_000_000
    key = rng.integers(0, 1 << 20, n, dtype=np.int64).astype(np.uint32)
    key[:600_000] = rng.integers(0, 2048, 600_000)
    lo = (rng.integers(0, 1 << 32, n, dtype=np.int64).astype(np.uint32)
          & np.uint32(0xFFF00000)) | key
    hi = rng.integers(0, 1 << 28, n, dtype=np.int64).astype(np.uint32)
    slot = hj._slots_u8(key)
    fwd = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    args = (words(hi, dev), words(lo, dev))
    most, stage = both(*args, torch.from_numpy(slot).to(dev),
                       ", a skewed query set", fwd=fwd, cap=255, lo_bit=0,
                       width=20)
    if most <= stage:
        raise AssertionError("bucket_runs: the skewed set's largest bin "
                             "fits the stage")
    both(*args, torch.from_numpy(slot).to(dev), ", cap 1", fwd=fwd, cap=1,
         lo_bit=0, width=20)
    both(*args, torch.full((n,), 255, dtype=torch.uint8, device=dev),
         ", every slot over the cap", fwd=fwd, cap=255, lo_bit=0, width=20)
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    both(e, e, e.to(torch.uint8), ", n = 0", fwd=e.to(torch.bool), cap=32,
         lo_bit=0, width=20)


def check_join_bits(stream, dict_kmers, k, dev):
    """K5 and its counting sort (bucket_runs) on the first BITS_TILE
    windows of the genome stream as hamming_neighbor_bits joins them:
    part 0, word chunk 0 at pads 64/32 (timed: the word runs' build, the
    query runs' build, which is a call's layout time now that the word
    runs are cached, the kernel, and the padded layouts that the
    previous design built per call); a planted call; the tile's slow
    windows gathered and joined at pads 240/240 as the escalation does;
    the counting sort's edge inputs (check_bucket_runs_edges). The
    counting sort's row: the query side timed with each pass (torch.
    profiler) beside one torch.sort of its keys, and the same for the
    word side under "word_side", each with its bound. Returns the
    kernel-table rows of K5 and of its counting sort."""
    from quickmer2_tpu_torch.device import words
    from quickmer2_tpu_torch.kernels.hamming_join import (
        bucket_runs, bucket_runs_plain, join_bits_plain)
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops import hamming_join as hj
    w = hj._BitsWords(dict_kmers, k, hj.CHUNK_W, dev)
    seg = np.ascontiguousarray(stream[:BITS_TILE + k - 1])
    canon, valid, is_fwd, keys_q, active, slow = w.route_tile(seg, 64, 32)
    chi, clo, fwd = hj._device_kmerize(torch.from_numpy(seg).to(dev), k)
    qslot = w.query_slots(0, keys_q, active)
    part = w._part_bits(0)
    n_buckets = w.n_bkts[0]
    c = w.chunks[0]
    nq = len(canon)

    def word_runs():                    # built anew, not cached
        return bucket_runs(w.whi_d[c], w.wlo_d[c], w._w_slots(0, 0), cap=64,
                           **part)

    def query_runs():
        return w.query_runs(0, chi, clo, fwd, qslot, 32)
    runs_w, runs_q = word_runs(), query_runs()
    n_w = compare_runs(runs_w, bucket_runs_plain(
        w.whi_d[c], w.wlo_d[c], w._w_slots(0, 0), cap=64, **part), ", words")
    n_q = compare_runs(runs_q, bucket_runs_plain(
        chi, clo, qslot, cap=32, fwd=fwd, **part), ", queries")
    err, p_k, pairs, q_buckets, live_w = compare_join_bits(
        runs_w, runs_q, nq, k, part, "")
    planted_join(w, dict_kmers, k, dev)
    left = np.flatnonzero(valid & slow)
    g_keys = w.part_keys_of(canon[left])
    g_act = ~(w.over(240, 0)[g_keys[0]] | w.over(240, 1)[g_keys[1]]
              | w.over(240, 2)[g_keys[2]])
    hq = np.bincount(g_keys[0][g_act], minlength=n_buckets)
    g_act &= hq[g_keys[0]] <= 240
    g_hi, g_lo = codec.split_u64(canon[left])
    g_args = (words(g_hi, dev), words(g_lo, dev),
              torch.from_numpy(is_fwd[left]).to(dev),
              w.query_slots(0, g_keys, g_act))
    runs_g = w.query_runs(0, *g_args, 240)
    compare_runs(runs_g, bucket_runs_plain(
        g_args[0], g_args[1], g_args[3], cap=240, fwd=g_args[2], **part),
        ", the gathered slow windows")
    compare_join_bits(w.word_runs(0, 0, 240), runs_g, len(left), k, part,
                      f" 240/240, the tile's {len(left)} slow windows "
                      "gathered")
    del runs_g
    check_bucket_runs_edges(w, dev)
    ms, queued_ms = kernel_ms(lambda: w.join_runs(0, runs_w, runs_q, p_k), 10)
    p_p = torch.zeros_like(p_k)
    plain_ms = cuda_ms(lambda: join_bits_plain(*runs_w, *runs_q, p_p, k=k,
                                               **part), 1)
    word_ms, word_queued_ms = kernel_ms(word_runs, 3)
    word_passes = profile_kernels(word_runs, 3, "bucket_runs' word side")
    query_ms, query_queued_ms = kernel_ms(query_runs, 3)
    query_passes = profile_kernels(query_runs, 3,
                                   "bucket_runs' query side")
    sort_plain_ms = cuda_ms(lambda: bucket_runs_plain(
        chi, clo, qslot, cap=32, fwd=fwd, **part), 1)
    query_lib_ms = sort_library_ms(chi, clo, qslot, 32, part)
    word_lib_ms = sort_library_ms(w.whi_d[c], w.wlo_d[c], w._w_slots(0, 0),
                                  64, part)
    q_bins = largest_bin(runs_q[-1], nq, part["width"], True)
    w_bins = largest_bin(runs_w[-1], len(w.whi_d[c]), part["width"], False)
    wslots = w._w_slots(0, 0)
    padded_ms = cuda_ms(lambda: hj._bucket_layouts(
        w.whi_d[c], w.wlo_d[c], torch.ones_like(wslots, dtype=torch.int32),
        wslots, chi, clo, qslot, n_buckets=n_buckets, cpad=64, cpad_q=32,
        **part), 3)
    # K5's least traffic: 12 B of code and tag a live query, 4 B of
    # offsets a bucket holding one (and one more), 8 B a live word there,
    # and the 16-B planes row of each query that gets a bit, read and
    # written (no other row is touched; the counting sort's keys are
    # bucket_runs' own traffic); ~16 int ops a live pair. The padded
    # design's count beside it: qidx of every query lane, the flag of
    # every word lane of a bucket with a live query, 8 B of codes a live
    # word there and a live query, the strand flag and the planes
    bit_rows = int((p_k[:-1] != 0).any(1).sum())
    n_bytes = 12 * n_q + 4 * (q_buckets + 1) + 8 * live_w + 32 * bit_rows
    b_ms, b_by = bound_ms(n_bytes, 16 * pairs)
    padded_bytes = (4 * (n_buckets * 32 + 64 * q_buckets)
                    + 8 * (live_w + n_q) + 4 * n_q + 32 * n_q)
    padded_b_ms, _ = bound_ms(padded_bytes, 16 * pairs)
    # the counting sort's least traffic: each entry's code, slot and flag
    # read once, the runs (12 B an entering query, 8 B a word) and offsets
    # written
    sort_bytes = 10 * nq + 12 * n_q + 4 * (n_buckets + 1)
    s_ms, s_by = bound_ms(sort_bytes, 0)
    n_words = len(w.whi_d[c])
    word_bytes = 9 * n_words + 8 * n_w + 4 * (n_buckets + 1)
    ws_ms, ws_by = bound_ms(word_bytes, 0)
    log(f"  join_bits time {ms:.4f} ms (queued {queued_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB, {bit_rows} planes rows with a bit, "
        f"{16 * pairs / 1e9:.2f} G ops); the padded "
        f"design's count {padded_b_ms:.4f} ms; a call: query runs "
        f"{query_ms:.4f} ms (queued {query_queued_ms:.4f}) + kernel "
        f"{queued_ms:.4f} = {query_queued_ms + queued_ms:.4f} ms (word runs, "
        f"built once a pad, part and chunk: {word_ms:.4f} ms, {n_w} words); "
        f"the padded layouts of the same call {padded_ms:.4f} ms; "
        f"the query runs' kernels (torch.profiler, ms a call) "
        f"{query_passes}; bucket_runs bound {s_ms:.4f} ms ({s_by}), plain "
        f"{sort_plain_ms:.4f} ms, torch.sort of the keys {query_lib_ms:.4f} "
        f"ms, (bins, largest, stage) {q_bins}; tile: {int(valid.sum())} "
        f"valid windows, {len(left)} slow")
    log(f"  bucket_runs word side: {n_words} words, {n_w} in the runs; time "
        f"{word_ms:.4f} ms (queued {word_queued_ms:.4f} ms), bound "
        f"{ws_ms:.4f} ms ({ws_by}: {word_bytes / 1e6:.1f} MB), torch.sort "
        f"of the keys {word_lib_ms:.4f} ms, (bins, largest, stage) "
        f"{w_bins}; kernels (torch.profiler, ms a call) {word_passes}")
    src = "quickmer2_tpu_torch/csrc/hamming_join.cu"
    return [{"name": "join_bits", "route": "cuda", "source": src,
             "replaces": "quickmer2_tpu/ops/hamming_join.py:190",
             "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
             "plain_ms": plain_ms, "layout_ms": query_queued_ms,
             "call_ms": query_queued_ms + queued_ms,
             "padded_layout_ms": padded_ms, "bound_ms": b_ms,
             "bound_by": b_by, "bound_padded_ms": padded_b_ms,
             "library_ms": None},
            {"name": "bucket_runs", "route": "cuda", "source": src,
             "replaces": "quickmer2_tpu/ops/hamming_join.py:210",
             "max_abs_err": 0, "ms": query_ms, "queued_ms": query_queued_ms,
             "passes": query_passes, "plain_ms": sort_plain_ms,
             "bound_ms": s_ms, "bound_by": s_by, "library_ms": query_lib_ms,
             "word_side": {"ms": word_ms, "queued_ms": word_queued_ms,
                           "passes": word_passes, "bound_ms": ws_ms,
                           "bound_by": ws_by, "library_ms": word_lib_ms}}]


def compare_qai_builders(fa, dev, reset_counts, read_counts, sweep=None):
    """The smoke's .qai built with K4 (the sweep) and with the Hamming
    join (K5), each through AnchoredIndex.build: identical bytes, each
    build's seconds (index_s, its packed table included). `sweep`:
    (K4's .qai, its index_s), the anchored count's; built here when
    None. The join's build is its own path (JOIN_BITS_DEVICES on the
    card, rows left on the host): the counts are reset just before it
    and read just after. Returns the launches of K5 and its counting
    sort."""
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.ops import anchored
    dic = Dictionary.from_qm(fa + ".qm")
    stream, pos = anchored._genome_stream_and_positions(dic, fa)

    def build(name, join_on):
        path = os.path.join(WORK, f"{name}.qai")
        anchored.JOIN_BITS_DEVICES = join_on
        t = time.time()
        try:
            anchored.AnchoredIndex.build(stream, pos, dic.kmers_in_order,
                                         dic.kmer_size, cache_path=path,
                                         place_rows=False, device=dev)
            torch.cuda.synchronize()
        finally:
            anchored.JOIN_BITS_DEVICES = ()
        return path, time.time() - t

    if sweep is None:
        sweep = build("sweep", ())
    reset_counts()
    join = build("join", ("cuda",))
    counts = read_counts()
    join_launches = {n: counts[n] for n in ("join_bits", "bucket_runs")}
    if not all(join_launches.values()):
        raise AssertionError(f"the join-built .qai did not launch K5 and "
                             f"its counting sort: {join_launches}")
    with open(sweep[0], "rb") as f, open(join[0], "rb") as h:
        blob = f.read()
        if blob != h.read():
            raise AssertionError("the .qai by the join differs from K4's")
    os.remove(join[0])
    log(f"  .qai by the join identical to K4's ({len(blob)} bytes): "
        f"index_s by K4 {sweep[1]:.2f} s, by the join {join[1]:.2f} s, "
        f"launches {counts}")
    return join_launches


def spill_batches(index, counter, reads, dev):
    """Tier-1 spill codes of the main path's reads, batch by batch,
    until a full tier-2 batch (code 1 rows) and a full exact batch (code
    2 rows) are in hand: the batches the main path sends to K3 tier 2
    and to K2r (padded with SEP rows to a full batch if the reads run
    out first). Returns them with the first batch's code counts."""
    from quickmer2_tpu_torch.kernels.anchored import anchored_count
    from quickmer2_tpu_torch.ops import codec
    B = counter.batch_reads
    diff = torch.zeros(index.n_kmers + 2, dtype=torch.int32, device=dev)
    got = {1: [], 2: []}
    first = None
    for off in range(0, len(reads), B):
        rows = rows_of(reads[off:off + B])
        fmt, pk, aux, _ = packed_on(rows, dev)
        code = anchored_count(pk, aux, index.rows, index.genome_tiles,
                              index.dblock, diff, fmt=fmt,
                              **counter._tier_kw(1)).cpu().numpy()
        if first is None:
            first = np.bincount(code, minlength=3)
        for c in (1, 2):
            got[c].append(rows[code == c])
        if min(sum(map(len, got[c])) for c in (1, 2)) >= B:
            break
    out = []
    for c in (1, 2):
        rows = np.concatenate(got[c])[:B]
        pad = np.full((B - len(rows), ANCHOR_READ_LEN), codec.SEP, np.uint8)
        out.append(np.concatenate([rows, pad]))
    return out[0], out[1], first


def anchored_bound(trace, in_bytes, rows, anchor_bytes=0):
    """K3's bound on one batch from its plain version's trace. Least
    traffic: the packed rows in and a code out per row; each touched
    32-B table row (the block's, on a bucket block), 64-B genome tile
    and 16-B dblock row read once; each changed diff word read and
    written once; given anchors (`anchor_bytes`) read once. Least work:
    ~16 int ops per valid base of the rows (unpack, two strand compares,
    window bits; no padding past a read's end, no N base) and ~60 per
    probe. Returns (ms, bound by, bytes, ops, unique counts)."""
    from quickmer2_tpu_torch.ops import codec
    uniq = {name: int(torch.unique(trace[name]).numel())
            for name in ("probe_rows", "tiles", "dblock_rows")}
    n_bytes = (in_bytes + len(rows) + anchor_bytes
               + 32 * uniq["probe_rows"] + 64 * uniq["tiles"]
               + 16 * uniq["dblock_rows"] + 8 * trace["diff_words"].numel())
    uniq["bases"] = int(np.count_nonzero(rows < codec.SEP))
    n_ops = 16 * uniq["bases"] + 60 * trace["probes"]
    return (*bound_ms(n_bytes, n_ops), n_bytes, n_ops, uniq)


def check_anchored(index, counter, rows, tier, dev):
    """K3 in tier `tier` (the counter's own options) on one batch."""
    from quickmer2_tpu_torch.kernels.anchored import (
        anchored_count, anchored_count_plain, branch_of)
    fmt, pk, aux, in_bytes = packed_on(rows, dev)
    kw = dict(fmt=fmt, **counter._tier_kw(tier))
    tab = (index.rows, index.genome_tiles, index.dblock)

    def zero():
        return torch.zeros(index.n_kmers + 2, dtype=torch.int32, device=dev)
    d_kernel, d_plain = zero(), zero()
    c_kernel = anchored_count(pk, aux, *tab, d_kernel, **kw)
    trace = {}
    c_plain = anchored_count_plain(pk, aux, *tab, d_plain, trace=trace, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(d_kernel, d_plain), max_abs_err(c_kernel, c_plain))
    branch = branch_of(kw["max_dirty"], kw.get("dirty_run_width", 0),
                       kw.get("neighbor_mode", False))
    codes = np.bincount(c_kernel.cpu().numpy(), minlength=3)
    log(f"  anchored tier {tier} ({branch}, {fmt}): {len(rows)} rows of "
        f"{rows.shape[1]}, codes 0/1/2 = {codes.tolist()}, "
        f"{trace['probes']} probes, {int((d_kernel != 0).sum())} diff words "
        f"set, max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(
            f"anchored tier {tier} disagrees with its plain version")
    ms, queued_ms = kernel_ms(
        lambda: anchored_count(pk, aux, *tab, d_kernel, **kw), 10)
    plain_ms = cuda_ms(
        lambda: anchored_count_plain(pk, aux, *tab, d_plain, **kw), 1, warm=0)
    b_ms, b_by, n_bytes, n_ops, uniq = anchored_bound(trace, in_bytes, rows)
    log(f"  anchored tier {tier} time {ms:.4f} ms (queued "
        f"{queued_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
        f"{n_ops / 1e9:.3f} G ops; {uniq})")
    return {"name": f"anchored_tier{tier}", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/anchored.cu",
            "replaces": "quickmer2_tpu/ops/anchored.py:512",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def host_ms(fn, reps: int) -> float:
    """Host-clock milliseconds per call of fn() while its launches queue
    behind a sleeping kernel (so no call waits for the card): the
    wrapper's own host time."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(60_000_000)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / reps * 1e3


def compare_count_mono_rows(rows, mono_rows, n_buckets, n_slots, k, label,
                            dev):
    """K2r against its plain version on one batch of rows; returns (max |kernel - plain|, the batch on the card, the
    plain version's depth, hits, unresolved lanes)."""
    from quickmer2_tpu_torch.kernels import count_mono as cm
    fmt, pk, aux, in_bytes = packed_on(rows, dev)
    kw = dict(fmt=fmt, k=k, n_buckets=n_buckets, read_len=rows.shape[1])
    d_kernel = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    d_plain = torch.zeros_like(d_kernel)
    m_kernel = cm.count_mono_rows(pk, aux, mono_rows, d_kernel, **kw)
    m_plain = cm.count_mono_rows_plain(pk, aux, mono_rows, d_plain, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(d_kernel[:-1], d_plain[:-1]),
              max_abs_err(m_kernel, m_plain))
    hits = int(d_kernel[:-1].sum())
    n_unres = int(np.unpackbits(m_kernel.cpu().numpy().view(np.uint8)).sum())
    R, L = rows.shape
    log(f"  count_mono_rows {label} ({fmt}): {R} rows of {L}, k={k}, "
        f"{R * (L - k + 1)} lanes, {hits} hits, {n_unres} unresolved lanes, "
        f"max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(f"count_mono_rows {label} ({fmt}, L={L}, "
                             f"k={k}) disagrees with its plain version")
    return err, (fmt, pk, aux, in_bytes, kw), d_plain, m_kernel


def window_traffic(batch, depth, n_buckets) -> tuple[int, int, int]:
    """(valid windows, mono rows they name, buckets with a hit) of one
    batch of read rows as compare_count_mono_rows returns it."""
    from quickmer2_tpu_torch.ops import codec, rowpack
    fmt, pk, aux, _, kw = batch
    k, L = kw["k"], kw["read_len"]
    reads = rowpack.unpack_batch(fmt, pk, aux, read_len=L)
    chi, clo, ok = codec.sliding_kmers(reads.reshape(-1), k)
    lane = torch.arange(chi.numel(), device=pk.device)
    ok = ok & (lane % L < L - k + 1)
    return (int(ok.sum()),) + touched(chi[ok], clo[ok], depth, n_buckets)


def check_count_mono_rows(counter, rows, dev):
    """K2r on one exact batch against the counter's mono table, timed,
    with the wrapper's host time a call."""
    from quickmer2_tpu_torch.kernels import count_mono as cm
    mono = counter._mono
    table = (counter._mono_rows, mono.n_buckets, mono.n_slots, counter.k)
    err, batch, d_plain, m_kernel = compare_count_mono_rows(
        rows, *table, "exact batch", dev)
    fmt, pk, aux, in_bytes, kw = batch
    d = torch.zeros_like(d_plain)

    def call():
        return cm.count_mono_rows(pk, aux, counter._mono_rows, d, **kw)
    ms, queued_ms = kernel_ms(call, 10)
    wrapper_ms = host_ms(call, 50)
    plain_ms = cuda_ms(lambda: cm.count_mono_rows_plain(
        pk, aux, counter._mono_rows, d, **kw), 2)
    # least traffic: packed rows in, each touched 64-B mono row read
    # once, the 32-B sector of each bucket's depth words with a hit read
    # and written once, the mask out; ~52 int ops per valid window
    n_valid, rows_touched, buckets_hit = window_traffic(
        batch, d_plain, mono.n_buckets)
    n_bytes = (in_bytes + 64 * rows_touched + 64 * buckets_hit
               + 4 * m_kernel.numel())
    b_ms, b_by = bound_ms(n_bytes, 52 * n_valid)
    log(f"  count_mono_rows time {ms:.4f} ms (queued {queued_ms:.4f} "
        f"ms), wrapper host time {wrapper_ms:.4f} ms a call, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB, {n_valid} valid windows, "
        f"{rows_touched} rows touched, {buckets_hit} with a hit)")
    return {"name": "count_mono_rows", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/count_mono.cu",
            "replaces": "quickmer2_tpu/ops/anchored.py:942",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "host_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_count_mono_rows_edges(counter, g, dev):
    """K2r on the shapes its window map branches on, each against its
    plain version: k = 15, 30, 31, 32 (30 on the counter's own table, the
    others on a table of the unique k-mers of the genome's first 1 Mb at
    load 1, so that buckets fill); rows of 64, 150 (a 38-B pitch, not a
    multiple of 8), 160 and 1024 (segmented 10 kb reads); the lens and
    the mask format (SEP bases inside rows); a short batch of 1001 reads,
    so that R * W is not a multiple of 32."""
    from quickmer2_tpu_torch.device import words
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops.anchored import rows_from_flat_codes
    from quickmer2_tpu_torch.ops.monotable import MonoTable
    rng = np.random.default_rng(11)
    region = g[:1 << 20]
    reads = simulate_reads(rng, region, 1001, READ_LEN, ERR)
    long_reads = simulate_reads(rng, region, 60, 10_000, ERR)
    flat = np.concatenate([long_reads, np.full((60, 1), codec.SEP,
                                               np.uint8)], 1).reshape(-1)
    for k in (15, 30, 31, 32):
        if k == counter.k:
            mono = counter._mono
            mono_rows = counter._mono_rows
        else:
            canon, valid = codec.sliding_kmers_np(region, k)
            hi, lo = codec.split_u64(distinct(canon[valid & (canon != 0)]))
            mono = MonoTable.build(hi, lo, load=1.0)
            mono_rows = words(mono.rows, dev)
        for lens in (np.ascontiguousarray(reads[:, :64]), reads,
                     rows_of(reads), rows_from_flat_codes(flat, 1024,
                                                          segment_k=k)):
            mask = lens.copy()
            mask[rng.random(mask.shape) < 0.003] = codec.SEP
            for rows in (lens, mask):
                compare_count_mono_rows(rows, mono_rows, mono.n_buckets,
                                        mono.n_slots, k, "edge", dev)


def compare_anchored(index, rows, kw, label, dev):
    """K3 against its plain version on one batch of rows, untimed."""
    from quickmer2_tpu_torch.kernels.anchored import (
        anchored_count, anchored_count_plain)
    fmt, pk, aux, _ = packed_on(rows, dev)
    tab = (index.rows, index.genome_tiles, index.dblock)
    d_k = torch.zeros(index.n_kmers + 2, dtype=torch.int32, device=dev)
    d_p = torch.zeros_like(d_k)
    c_k = anchored_count(pk, aux, *tab, d_k, fmt=fmt, **kw)
    c_p = anchored_count_plain(pk, aux, *tab, d_p, fmt=fmt, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(d_k, d_p), max_abs_err(c_k, c_p))
    log(f"  {label} ({fmt}, rows of {rows.shape[1]}): codes 0/1/2 = "
        f"{np.bincount(c_k.cpu().numpy(), minlength=3).tolist()}, "
        f"{int((d_k != 0).sum())} diff words set, "
        f"max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


# rows wider than 1,024 bases, which K3 takes a block a read, a warp a
# tile of 1,024: widths checked (a multiple of 32 and not), widths timed,
# and the widest row the kernels take (the lens format's u16 lengths)
WIDE_WIDTHS = (2048, 3000, 16384)
WIDE_TIMED = (2048, 16384)
WIDE_MAX = 65535


def planted_long_reads(rng, g, length, n):
    """n reads of `length` bases of g, error-free but for one to three
    substitutions at bases 1,000-1,060 (across the first tile boundary,
    base 1,024, of K3's block over wide rows); every other one reverse
    complemented, so that its substitutions sit near its end."""
    starts = rng.integers(0, len(g) - length, size=n)
    reads = g[starts[:, None] + np.arange(length)[None, :]]
    for i in range(n):
        at = 1000 + rng.choice(61, 1 + i % 3, replace=False)
        reads[i, at] = (reads[i, at] + 1 + i % 3) % 4
    reads[1::2] = ((reads[1::2, ::-1] + 2) % 4).astype(np.uint8)
    return reads


def planted_tile_reads(rng, g, width, n):
    """n reads of `width` bases of g (every other one reverse
    complemented), each with one to three substitutions within 40 bases
    of one tile boundary of K3's block, read i at the (i mod B + 1)-th of
    the row's B boundaries (bases 1,024, 2,048, ...), and, where the
    row's last tile is partial, at its first, middle and last bases."""
    from quickmer2_tpu_torch.kernels.anchored import TILE_L
    starts = rng.integers(0, len(g) - width, size=n)
    reads = g[starts[:, None] + np.arange(width)[None, :]]
    reads[1::2] = ((reads[1::2, ::-1] + 2) % 4).astype(np.uint8)
    bounds = np.arange(TILE_L, width, TILE_L)
    last = width - width % TILE_L
    for i in range(n):
        at = bounds[i % len(bounds)] - 40 + rng.choice(80, 1 + i % 3,
                                                       replace=False)
        if width % TILE_L:
            at = np.concatenate([at, [last, (last + width) // 2, width - 1]])
        reads[i, at] = (reads[i, at] + 1 + i % 3) % 4
    return reads


def long_rows(read_sets, width, k):
    """Rows of `width` of each set of read codes (u8[R, length]), cut
    into k-1-overlap segments as the count cuts long reads."""
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops.anchored import rows_from_flat_codes
    out = []
    for reads in read_sets:
        flat = np.concatenate([reads, np.full((len(reads), 1), codec.SEP,
                                              np.uint8)], 1)
        out.append(rows_from_flat_codes(flat.reshape(-1), width,
                                        segment_k=k))
    return np.concatenate(out)


def with_ns(rows, rng):
    """The rows with N bases (SEP codes) at 0.05 % and one at bases
    1,000-1,060 of every third row: the mask format."""
    from quickmer2_tpu_torch.ops import codec
    out = rows.copy()
    out[rng.random(out.shape) < 0.0005] = codec.SEP
    idx = np.arange(0, len(out), 3)
    out[idx, 1000 + idx % 61] = codec.SEP
    return out


def time_anchored_wide(index, kw, rows, dev):
    """K3 tier 1 on one batch of wide rows: ms, queued ms, plain ms and
    the bound anchored_bound gives from the batch's own trace."""
    from quickmer2_tpu_torch.kernels.anchored import (
        anchored_count, anchored_count_plain)
    fmt, pk, aux, in_bytes = packed_on(rows, dev)
    tab = (index.rows, index.genome_tiles, index.dblock)
    d = torch.zeros(index.n_kmers + 2, dtype=torch.int32, device=dev)
    trace = {}
    anchored_count_plain(pk, aux, *tab, d, fmt=fmt, trace=trace, **kw)
    ms, queued_ms = kernel_ms(
        lambda: anchored_count(pk, aux, *tab, d, fmt=fmt, **kw), 10)
    plain_ms = cuda_ms(lambda: anchored_count_plain(pk, aux, *tab, d,
                                                    fmt=fmt, **kw), 1, warm=0)
    b_ms, b_by, n_bytes, n_ops, uniq = anchored_bound(trace, in_bytes, rows)
    log(f"  anchored tier 1 ({fmt}) on {len(rows)} rows of {rows.shape[1]}: "
        f"time {ms:.4f} ms (queued {queued_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} G ops; {uniq})")
    return {"rows": len(rows), "width": rows.shape[1], "ms": ms,
            "queued_ms": queued_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def branch_kws(counter):
    """(label, options) of K3's three branches under the counter's
    options: tier 1 (its own), tier 2, and tier 1 with point probes in
    place of the neighbor bits."""
    t1 = counter._tier_kw(1)
    return (("tier 1", t1), ("tier 2", counter._tier_kw(2)),
            ("point probes", dict(t1, max_dirty=8, neighbor_mode=False)))


def compare_wide(index, rows, counter_w, dev):
    """K3 on a batch of wide rows in all three branches against its plain
    version; returns the largest error."""
    return max(compare_anchored(index, rows, kw, label, dev)
               for label, kw in branch_kws(counter_w))


def wide_block_threads(width):
    """The threads of the block K3 gives each row of `width` bases wider
    than TILE_L: a warp a tile of TILE_L, at most WIDE_WARPS."""
    from quickmer2_tpu_torch.kernels.anchored import TILE_L, WIDE_WARPS
    return 32 * min(-(-width // TILE_L), WIDE_WARPS)


def edge_inputs(g, k, B):
    """check_anchored_edges' random inputs, drawn from seed 7 in the order
    of every run since the wide rows were added (so that its timed
    batches stay those of PERF.md): the N masks of its narrow batches (B
    rows of ANCHOR_READ_LEN and of 64 bases), 600 simulated reads of 10
    kb, and the rows wider than 1,024 (long_rows of the 10 kb reads, 8
    reads of 20 kb and 200 reads planted across base 1,024 at each of
    WIDE_WIDTHS; a few reads of 70 kb and planted ones at WIDE_MAX), each
    with its copy in the mask format (with_ns). The reads planted at
    every tile boundary of 16,384 and in the last tile of WIDE_MAX draw
    from a generator of their own (seed 8). Returns (masks, long_reads,
    wide): wide[width] = (rows, masked rows), wide["tiles"] the planted
    rows of 16,384."""
    rng = np.random.default_rng(7)
    masks = (rng.random((B, ANCHOR_READ_LEN)) < 0.002,
             rng.random((B, 64)) < 0.002)
    long_reads = simulate_reads(rng, g, 600, 10_000, 0.003)
    sets = [long_reads, simulate_reads(rng, g, 8, 20_000, 0.003)]
    edge_rng = np.random.default_rng(8)
    wide = {}
    for width in WIDE_WIDTHS:
        rows = long_rows(sets + [planted_long_reads(rng, g, width + 100, 200)],
                         width, k)
        wide[width] = (rows, with_ns(rows, rng))
        if width == 16384:
            tiles = long_rows([planted_tile_reads(edge_rng, g, width, 64)],
                              width, k)
            wide["tiles"] = (tiles, with_ns(tiles, edge_rng))
    rows = long_rows([simulate_reads(rng, g, 4, 70_000, 0.001),
                      planted_long_reads(rng, g, WIDE_MAX + 100, 4),
                      planted_tile_reads(edge_rng, g, WIDE_MAX, 8)],
                     WIDE_MAX, k)
    wide[WIDE_MAX] = (rows, with_ns(rows, rng))
    return masks, long_reads, wide


def check_anchored_edges(index, counter, g, reads, dev):
    """K3 on the shapes its layout branches on, each against its plain
    version: the mask format (N bases) in all three branches, rows of 64
    (2 lanes a read) and of 1024 (segmented 10 kb reads, 32 lanes a
    read) in both tiers; then rows wider than 1,024 (a block a read, a
    warp a tile; edge_inputs) in all three branches, lens and mask
    format (compare_wide). Returns the kernel-table row of the wide rows
    (tier 1 timed at 2,048 and, under "w16384", at 16,384, on the inputs
    of every run since the rows were added) and the batches of 2,048
    (lens, mask)."""
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops.anchored import (
        AnchoredDepthCounter, rows_from_flat_codes)
    B, k = counter.batch_reads, counter.k
    masks, long_reads, wide = edge_inputs(g, k, B)
    lens = rows_of(reads[B:2 * B])
    mask = lens.copy()
    mask[masks[0]] = codec.SEP
    for rows in (lens, mask):
        for label, kw in branch_kws(counter):
            compare_anchored(index, rows, kw, label, dev)
    narrow = AnchoredDepthCounter(index, k, 64, prefetch_puts=False,
                                  device=dev)
    r64 = np.ascontiguousarray(reads[2 * B:3 * B, :64])
    m64 = r64.copy()
    m64[masks[1]] = codec.SEP
    for rows in (r64, m64):
        for tier in (1, 2):
            compare_anchored(index, rows, narrow._tier_kw(tier),
                             f"tier {tier}", dev)
    flat = np.concatenate([long_reads, np.full((600, 1), codec.SEP,
                                               np.uint8)], 1)
    wide_rows = rows_from_flat_codes(flat.reshape(-1), 1024, segment_k=k)
    wide_1024 = AnchoredDepthCounter(index, k, 1024, prefetch_puts=False,
                                     device=dev)
    for tier in (1, 2):
        compare_anchored(index, wide_rows, wide_1024._tier_kw(tier),
                         f"tier {tier}", dev)
    del narrow, wide_1024
    row, err = {}, 0
    for width in (*WIDE_WIDTHS, WIDE_MAX):
        counter_w = AnchoredDepthCounter(index, k, width,
                                         prefetch_puts=False, device=dev)
        log(f"  rows of {width}: a block of {wide_block_threads(width)} "
            "threads a row")
        for batch in wide[width] + (wide["tiles"] if width == 16384 else ()):
            err = max(err, compare_wide(index, batch, counter_w, dev))
        if width in WIDE_TIMED:
            row[width] = time_anchored_wide(index, counter_w._tier_kw(1),
                                            wide[width][0], dev)
        del counter_w
    first, second = (row[w] for w in WIDE_TIMED)
    return {"name": "anchored_wide", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/anchored.cu",
            "replaces": "quickmer2_tpu/ops/anchored.py:512",
            "max_abs_err": err, **first, "library_ms": None,
            f"w{WIDE_TIMED[1]}": second}, wide[2048]


def check_anchored_kernels(fa, g, reads, dev):
    """The anchored path's kernels against their plain versions: the
    key filter and K4 on the index's own table (and at k = 15 and 32 on
    a small dictionary), K3 in tier 1 and 2 on the main path's batches
    (timed) and on its edge shapes, K2r on an exact batch. Returns the
    timed kernel-table rows."""
    t = time.time()
    stream, dict_kmers, index, counter = anchored_setup(fa, dev)
    log(f"  anchored index: {index.n_kmers} k-mers, {index.n_buckets} "
        f"buckets, genome {index.genome_len} bases, built on the card in "
        f"{time.time() - t:.1f} s")
    k = counter.k
    filt, row = check_key_filter(index, dev)
    rows = [row, check_neighbor_bits(stream, index, filt, k, dev)]
    del filt
    for kk in (15, 32):
        check_neighbor_bits_small(kk, dev)
    rows += check_join_bits(stream, dict_kmers, k, dev)
    B = counter.batch_reads
    rows.append(check_anchored(index, counter, rows_of(reads[:B]), 1, dev))
    tier2, exact, first = spill_batches(index, counter, reads, dev)
    log(f"  tier-1 codes 0/1/2 of the first batch: {first.tolist()}")
    rows.append(check_anchored(index, counter, tier2, 2, dev))
    row, wide = check_anchored_edges(index, counter, g, reads, dev)
    rows.append(row)
    rows.append(check_count_mono_rows(counter, exact, dev))
    check_count_mono_rows_edges(counter, g, dev)
    rows.append(check_count_packed_rows(index, exact, k, dev))
    rows += check_anchor_probes(index, counter, rows_of(reads[:B]), tier2,
                                wide, dev)
    del stream, dict_kmers, index, counter
    torch.cuda.empty_cache()
    return rows


# -- phase 2, the flat engines: K7, K8, K9 and the sort-join crossover -----

def flat_codes(reads, n_bases):
    """The first n_bases codes of the flat count's stream of `reads`
    (each read followed by a separator)."""
    from quickmer2_tpu_torch.ops import codec
    sep = np.full((len(reads), 1), codec.SEP, np.uint8)
    stream = np.concatenate([reads, sep], 1).reshape(-1)
    if len(stream) < n_bases:
        raise AssertionError(f"{len(stream)} codes, {n_bases} wanted")
    return stream[:n_bases]


def flat_batch(codes, dev):
    """codes → the 2-bit batch (pk, bits) on the card, and its bytes."""
    from quickmer2_tpu_torch.ops import rowpack
    pk, bits = rowpack.pack_rows(codes[None, :])
    return (torch.from_numpy(pk[0]).to(dev), torch.from_numpy(bits[0]).to(dev),
            pk.nbytes + bits.nbytes)


def codec_windows(pk, bits, k, n_bases):
    """(chi, clo, valid) of the batch's windows, by the plain codec."""
    from quickmer2_tpu_torch.ops import codec, rowpack
    codes = rowpack.unpack_rows(pk[None], bits[None], read_len=n_bases)[0]
    return codec.sliding_kmers(codes, k)


def hit_sectors(depth) -> int:
    """32-B sectors of a rank-space depth vector with a hit, the trash
    lane's included."""
    return int(torch.unique(torch.nonzero(depth[:-1]).flatten() // 8)
               .numel()) + 1


def linear_traffic(chi, clo, table, H):
    """What K7 must read for these windows: distinct table sectors over
    every probe step (8-B entries, 4 a sector) and distinct rank sectors
    of the slots where the scans stop; and the probe steps."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.ops.hash import djb_pair, probe_lookup, slot_at
    idx0 = djb_pair(chi, clo) & (H - 1)
    idx, _ = probe_lookup(u32(table[:, 0]), u32(table[:, 1]), chi, clo, H)
    steps = (idx - idx0).abs() + 1
    first = torch.cumsum(steps, 0) - steps
    within = (torch.arange(int(steps.sum()), device=chi.device)
              - torch.repeat_interleave(first, steps))
    step = torch.where((idx0 & (H >> 1)) != 0, -1, 1)
    slots = slot_at(torch.repeat_interleave(idx0, steps)
                    + within * torch.repeat_interleave(step, steps), H)
    return (int(torch.unique(slots // 4).numel()),
            int(torch.unique(slot_at(idx, H) // 8).numel()),
            int(steps.sum()))


def compare_parts(name, label, launch, d_plain, parts, zero):
    """A kernel's slot-space depth at each slice count P in `parts`
    (launch(depth, P)) against its plain version's, whole vectors, the
    trash counter included: exactly equal. Returns the depth of the
    last P."""
    for p in parts:
        d_p = zero()
        launch(d_p, p)
        torch.cuda.synchronize()
        err = max_abs_err(d_p, d_plain)
        if err != 0:
            raise AssertionError(f"{name} {label} at P = {p} disagrees with "
                                 f"its plain version (max |diff| {err})")
    return d_p


def check_translation(name, label, d_slot, rank_slots, n, want, timed):
    """slot_depth_to_rank of a kernel's slot-space depth against the
    rank-space depth of the JAX step's semantics (`want`, computed
    without slots), and back: rank_depth_to_slot then slot_depth_to_rank
    gives `want` again. Returns (ms, bound ms) when timed."""
    from quickmer2_tpu_torch.kernels.count_flat import (
        rank_depth_to_slot, slot_depth_to_rank)
    got = slot_depth_to_rank(d_slot, rank_slots, n)
    back = slot_depth_to_rank(
        rank_depth_to_slot(want, rank_slots, len(d_slot)), rank_slots, n)
    torch.cuda.synchronize()
    err = max(max_abs_err(got, want), max_abs_err(back, want))
    if err != 0:
        raise AssertionError(f"{name} {label}: slot -> rank disagrees with "
                             f"the rank-space step (max |diff| {err})")
    if not timed:
        return None
    ms = cuda_ms(lambda: slot_depth_to_rank(d_slot, rank_slots, n), 10)
    # the slot of each rank read once, the slot depth read once (every
    # lane adds to the sum), the rank depth's sectors written once; an add
    # a lane
    n_bytes = (8 * n + 4 * len(d_slot) + 32 * -(-4 * (n + 1) // 32))
    b_ms, _ = bound_ms(n_bytes, len(d_slot))
    log(f"  {name} slot -> rank: {ms:.4f} ms, bound {b_ms:.4f} ms (bytes: "
        f"{n_bytes / 1e6:.1f} MB), equal to the rank-space step")
    return ms, b_ms


def linear_crossings(chi, clo, table, H, n_parts):
    """Valid windows whose scan stops in another slice than its home slot
    (past a slice's edge, or wrapped), at P = n_parts."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.ops.hash import djb_pair, probe_lookup, slot_at
    shift = (H // n_parts).bit_length() - 1
    home = djb_pair(chi, clo) & (H - 1)
    idx, _ = probe_lookup(u32(table[:, 0]), u32(table[:, 1]), chi, clo, H)
    return int(((home >> shift) != (slot_at(idx, H) >> shift)).sum())


def check_count_linear(dic, codes, dev, timed, label, parts):
    """K7 on the .qm table of `dic` and one batch: its slot depth and
    trash counter exactly equal to the plain version's at each slice
    count in `parts` and at its own; the translation to rank order equal
    to the rank-space step. Returns a kernel-table row when timed."""
    from quickmer2_tpu_torch.device import u32, words
    from quickmer2_tpu_torch.kernels.count_flat import (
        count_linear_launch, count_linear_step, count_linear_step_plain,
        linear_partitions_for, linear_rank_slots, linear_table)
    from quickmer2_tpu_torch.ops.hash import probe_lookup, slot_at
    table = linear_table(dic, dev)
    rank = words(np.asarray(dic.rank, np.int32).view(np.uint32), dev)
    H, n = dic.hash_size, dic.n_kmers
    rank_slots = linear_rank_slots(dic, dev)
    pk, bits, nbytes = flat_batch(codes, dev)
    kw = dict(k=dic.kmer_size, hash_size=H, n_bases=len(codes))
    own = linear_partitions_for(H)
    parts = sorted({1, 2, own, *parts})

    def zero():
        return torch.zeros(H + 1, dtype=torch.int32, device=dev)
    d_kernel, d_plain = zero(), zero()
    count_linear_step(pk, bits, table, d_kernel, **kw)
    count_linear_step_plain(pk, bits, table, d_plain, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(d_kernel, d_plain)
    if err != 0:
        raise AssertionError(f"count_linear {label} disagrees with its "
                             "plain version")
    compare_parts("count_linear", label, lambda d, p: count_linear_launch(
        pk, bits, table, d, n_parts=p, **kw), d_plain, parts, zero)
    # the rank-space step (JAX's count_step): rank of the stop slot, the
    # trash lane for an invalid window
    chi, clo, ok = codec_windows(pk, bits, dic.kmer_size, len(codes))
    idx, _ = probe_lookup(u32(table[:, 0]), u32(table[:, 1]), chi, clo, H)
    want = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    r = torch.where(ok, u32(rank)[slot_at(idx, H)], n)
    want.index_add_(0, r, torch.ones_like(r, dtype=torch.int32))
    tr = check_translation("count_linear", label, d_kernel, rank_slots, n,
                           want, timed)
    cross = linear_crossings(chi[ok], clo[ok], table, H, max(parts))
    log(f"  count_linear {label} k={dic.kmer_size}: {n} keys, {H} slots (P "
        f"= {own}; checked at P = {parts}), batch {len(codes)} bases: "
        f"{int(d_kernel[:-1].sum())} slot adds, {int(d_kernel[-1])} trash, "
        f"{cross} scans ending in another slice than their home's at P = "
        f"{max(parts)}; max |kernel - plain| = {err}")
    if not timed:
        return cross
    ms, queued_ms = kernel_ms(
        lambda: count_linear_step(pk, bits, table, d_kernel, **kw), 10)
    plain_ms = cuda_ms(
        lambda: count_linear_step_plain(pk, bits, table, d_plain, **kw), 1)
    sweep = {p: round(cuda_ms(lambda: count_linear_launch(
        pk, bits, table, d_plain, n_parts=p, **kw), 10), 4)
        for p in (1, 2, 4, 8, 32, 64) if p != own}
    t_sec, r_sec, probes = linear_traffic(chi[ok], clo[ok], table, H)
    d_sec = hit_sectors(want)
    n_win = len(codes) - dic.kmer_size + 1
    n_bytes = nbytes + 32 * (t_sec + r_sec) + 64 * d_sec
    # ~36 int ops a window (codec, canonical min, DJB), 8 a probe step
    b_ms, b_by = bound_ms(n_bytes, 36 * n_win + 8 * probes)
    log(f"  count_linear time {ms:.4f} ms (queued {queued_ms:.4f} ms) at P = "
        f"{own}, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB; {probes} probe steps over {int(ok.sum())} "
        f"valid windows, {probes / max(int(ok.sum()), 1):.4f} a window; "
        f"{t_sec} table, {r_sec} rank, {d_sec} depth sectors); ms at other "
        f"P: {sweep}")
    return {"name": "count_linear", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/count_flat.cu",
            "replaces": "quickmer2_tpu/pipelines/count.py:40",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "plain_ms": plain_ms, "partitions": own, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "translate_ms": tr[0],
            "translate_bound_ms": tr[1]}


def check_count_packed(table, codes, k, dev, timed, label, parts):
    """K8 on a PackedTable and one batch, as check_count_linear does K7.
    Returns a kernel-table row when timed."""
    from quickmer2_tpu_torch.kernels.count_flat import (
        count_packed_launch, count_packed_step, count_packed_step_plain,
        packed_partitions_for, packed_rank_slots)
    from quickmer2_tpu_torch.ops import packed_table
    rows = table.device_rows(dev)
    B, n = table.n_buckets, table.n_kmers
    rank_slots = packed_rank_slots(rows, n)
    pk, bits, nbytes = flat_batch(codes, dev)
    kw = dict(k=k, n_buckets=B, n_bases=len(codes))
    own = packed_partitions_for(B)
    parts = sorted({1, 2, own, *parts})

    def zero():
        return torch.zeros(2 * B + 1, dtype=torch.int32, device=dev)
    d_kernel, d_plain = zero(), zero()
    count_packed_step(pk, bits, rows, d_kernel, **kw)
    count_packed_step_plain(pk, bits, rows, d_plain, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(d_kernel, d_plain)
    if err != 0:
        raise AssertionError(f"count_packed {label} disagrees with its "
                             "plain version")
    compare_parts("count_packed", label, lambda d, p: count_packed_launch(
        pk, bits, rows, d, n_parts=p, **kw), d_plain, parts, zero)
    # the rank-space step (JAX's count_step_packed_pk)
    chi, clo, ok = codec_windows(pk, bits, k, len(codes))
    found, r, _ = packed_table.probe_packed(rows, chi, clo, B, n)
    want = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    r = torch.where(ok & found, r, n)
    want.index_add_(0, r, torch.ones_like(r, dtype=torch.int32))
    tr = check_translation("count_packed", label, d_kernel, rank_slots, n,
                           want, timed)
    log(f"  count_packed {label} k={k}: {n} keys, {B} buckets (P = {own}; "
        f"checked at P = {parts}), batch {len(codes)} bases: "
        f"{int(d_kernel[:-1].sum())} hits, {int(d_kernel[-1])} trash, "
        f"max |kernel - plain| = {err}")
    if not timed:
        return None
    ms, queued_ms = kernel_ms(
        lambda: count_packed_step(pk, bits, rows, d_kernel, **kw), 10)
    plain_ms = cuda_ms(
        lambda: count_packed_step_plain(pk, bits, rows, d_plain, **kw), 2)
    sweep = {p: round(cuda_ms(lambda: count_packed_launch(
        pk, bits, rows, d_plain, n_parts=p, **kw), 10), 4)
        for p in (1, 2, 8, 16, 32, 128) if p != own}
    # K8b at full width (blk_lo = 0, block_buckets = B: one block) beside
    # K8, in the order K8, K8b, K8b, K8: ms back to back, then queued
    from quickmer2_tpu_torch.kernels.block_probe import (
        block_displaced_filter)
    from quickmer2_tpu_torch.kernels.count_flat import (
        count_packed_block_launch)
    disp = block_displaced_filter(rows, B, 0)
    d_full, d_8 = zero(), zero()
    count_packed_block_launch(pk, bits, rows, disp, d_full, blk_lo=0,
                              block_buckets=B, n_parts=own, **kw)
    count_packed_launch(pk, bits, rows, d_8, n_parts=own, **kw)
    torch.cuda.synchronize()
    if max_abs_err(d_full, d_8) != 0:
        raise AssertionError("K8b at full width disagrees with K8")
    pair = {"count_packed": lambda: count_packed_launch(
        pk, bits, rows, d_plain, n_parts=own, **kw),
        "count_packed_block": lambda: count_packed_block_launch(
        pk, bits, rows, disp, d_plain, blk_lo=0, block_buckets=B,
        n_parts=own, **kw)}
    abba = [(name, [round(x, 4) for x in kernel_ms(pair[name], 10)])
            for name in ("count_packed", "count_packed_block",
                         "count_packed_block", "count_packed")]
    log(f"  count_packed against count_packed_block at full width, ms / "
        f"queued ms in turn: {abba}")
    nz = ok & ((chi | clo) != 0)
    rows_touched = probe_rows(rows, chi[nz], clo[nz])
    d_sec = hit_sectors(want)
    n_win = len(codes) - k + 1
    n_bytes = nbytes + 32 * rows_touched + 64 * d_sec
    # ~48 int ops a window: codec and DJB (36), two buckets, 4 compares
    b_ms, b_by = bound_ms(n_bytes, 48 * n_win)
    log(f"  count_packed time {ms:.4f} ms (queued {queued_ms:.4f} ms) at P = "
        f"{own}, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB, {rows_touched} rows, {d_sec} depth "
        f"sectors); ms at other P: {sweep}")
    return {"name": "count_packed", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/count_flat.cu",
            "replaces": "quickmer2_tpu/pipelines/count.py:131",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "plain_ms": plain_ms, "partitions": own, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "translate_ms": tr[0],
            "translate_bound_ms": tr[1], "against_block_full_width": abba}


def check_kmerize(codes, k, dev, timed, label):
    """K9 on one batch; (chi, clo, valid) exactly equal."""
    from quickmer2_tpu_torch.kernels.count_flat import (
        kmerize_step, kmerize_step_plain)
    pk, bits, nbytes = flat_batch(codes, dev)
    kw = dict(k=k, n_bases=len(codes))
    got = kmerize_step(pk, bits, **kw)
    want = kmerize_step_plain(pk, bits, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
              int((got[2] != want[2]).sum()))
    log(f"  kmerize {label} k={k}: batch {len(codes)} bases, "
        f"{int(got[2].sum())} valid windows, max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(f"kmerize {label} disagrees with its plain "
                             "version")
    if not timed:
        return None
    ms, queued_ms = kernel_ms(lambda: kmerize_step(pk, bits, **kw), 10)
    plain_ms = cuda_ms(lambda: kmerize_step_plain(pk, bits, **kw), 2)
    n_win = len(codes) - k + 1
    n_bytes = nbytes + 9 * n_win
    # ~24 int ops a window: the funnel shifts, reversal, canonical min
    b_ms, b_by = bound_ms(n_bytes, 24 * n_win)
    log(f"  kmerize time {ms:.4f} ms (queued {queued_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB)")
    return {"name": "kmerize", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/count_flat.cu",
            "replaces": "quickmer2_tpu/pipelines/count.py:152",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


# K7, K8, K9's untimed shapes: (k, keys, batch bases), batches that are
# no multiple of 64 bases
FLAT_ENGINE_EDGES = ((15, 400_000, (1 << 21) + 13), (31, 400_000, 3_000_001),
                     (32, 400_000, (1 << 21) + 45))


def check_flat_engines_small(rng, k, n_keys, n_bases, dev, parts):
    """K7, K8, K9 at k on a random dictionary (a third of the batch's
    windows among its keys) and a batch with read separators and N
    bases; K7 and K8 also at the smoke's slice counts (parts: K7's, K8's)
    on these tables."""
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops.packed_table import PackedTable
    from quickmer2_tpu_torch.utils import native
    g = rng.integers(0, 4, n_bases).astype(np.uint8)
    canon, valid, _ = native.sliding_canon(g, k)
    hits = canon[valid & (canon != 0) & (rng.random(len(canon)) < 0.3)]
    top = (1 << (2 * k)) - 1
    rand = rng.integers(1, 1 << 62, n_keys, dtype=np.int64).astype(np.uint64)
    keys = distinct(np.concatenate([hits, rand & np.uint64(top)]))
    keys = keys[keys != 0]
    keys = keys[rng.permutation(len(keys))[:n_keys]]
    dic = Dictionary.from_kmers_in_order(keys, 1 << 21, k)
    codes = g.copy()
    codes[READ_LEN::READ_LEN + 1] = codec.SEP
    codes[rng.random(n_bases) < 0.01] = codec.SEP
    check_count_linear(dic, codes, dev, False, "edge", [parts[0]])
    check_count_packed(PackedTable.from_dictionary(dic), codes, k, dev, False,
                       "edge", [parts[1]])
    check_kmerize(codes, k, dev, False, "edge")


def check_count_linear_wrap(rng, dev, parts):
    """K7 on a 4096-slot table, full but for two slots near the top:
    scans from the upper half run down through slot 0 and wrap to slot
    H - 1, where a planted key is found; misses run long, across the
    slices of P = parts (K7's smoke slice count), which some must."""
    from quickmer2_tpu_torch.dictionary import Dictionary, make_rank
    from quickmer2_tpu_torch.io import formats
    from quickmer2_tpu_torch.ops import hash as qhash
    from quickmer2_tpu_torch.utils import native
    H, k, empty = 4096, 15, (3000, 3500)
    g = rng.integers(0, 4, 4 * H).astype(np.uint8)
    canon, valid, _ = native.sliding_canon(g, k)
    keys = distinct(canon[valid & (canon != 0)])
    keys = keys[rng.permutation(len(keys))]
    table = np.zeros(H, np.uint64)
    placed = keys[:H // 4]
    qhash.probe_insert_np(table, placed, H)
    table[list(empty)] = 0
    free = np.setdiff1d(np.flatnonzero(table == 0), empty)
    table[rng.permutation(free)] = keys[len(placed):len(placed) + len(free)]
    spare = keys[len(placed) + len(free):]
    start = qhash.djb_u64_np(spare) & (H - 1)
    table[H - 1] = spare[(start >= H // 2) & (start < min(empty))][0]
    slots = np.flatnonzero(table)
    dic = Dictionary(formats.QmHeader(k, 0, 0, 0, H, int(slots[0])), table,
                     slots.astype(np.int64), make_rank(H, slots))
    starts = rng.integers(0, len(g) - READ_LEN, 20_000)
    reads = g[starts[:, None] + np.arange(READ_LEN)]
    codes = np.concatenate([flat_codes(reads, 20_000 * (READ_LEN + 1) - 7),
                            (table[H - 1] >> (2 * np.arange(
                                k - 1, -1, -1, dtype=np.uint64))
                             & np.uint64(3)).astype(np.uint8)])
    cross = check_count_linear(dic, codes, dev, False, "4096 slots, wrapping",
                               [parts])
    if cross == 0:
        raise AssertionError("no scan of the wrapping table crossed a slice")


SORTJOIN_NS = (1 << 14, 1 << 16, 1 << 18, 1 << 20)


def sortjoin_crossover(dict_kmers, codes, k, dev):
    """One batch through the mono engine (K2) and the sort-join engine
    (K9 + ops.sortjoin) on dictionaries of the first n keys of the
    smoke's, n in SORTJOIN_NS: CUDA-event ms of each (back to back), the
    sort-join depth checked against K8's on a packed table of the same
    keys. Returns {n: (mono ms, sortjoin ms)} and the largest n at which
    sort-join was faster (0 if none)."""
    from quickmer2_tpu_torch.device import words
    from quickmer2_tpu_torch.kernels.count_flat import (
        count_packed_step, kmerize_step, packed_rank_slots, slot_depth_to_rank)
    from quickmer2_tpu_torch.kernels.count_mono import count_mono_step
    from quickmer2_tpu_torch.ops import codec
    from quickmer2_tpu_torch.ops.monotable import MonoTable
    from quickmer2_tpu_torch.ops.packed_table import PackedTable
    from quickmer2_tpu_torch.ops.sortjoin import SortJoinEngine
    pk, bits, _ = flat_batch(codes, dev)
    n_bases = len(codes)
    out, best = {}, 0
    for n in SORTJOIN_NS:
        keys = dict_kmers[:n]
        hi, lo = codec.split_u64(keys)
        mono = MonoTable.build(hi, lo)
        rows = words(mono.rows, dev)
        depth = torch.zeros(mono.n_slots + 1, dtype=torch.int32, device=dev)
        engine = SortJoinEngine(keys, dev)
        engine.count_codes(*kmerize_step(pk, bits, k=k, n_bases=n_bases))
        packed = PackedTable.build(hi, lo, np.arange(n, dtype=np.uint32))
        prows = packed.device_rows(dev)
        ref = torch.zeros(2 * packed.n_buckets + 1, dtype=torch.int32,
                          device=dev)
        count_packed_step(pk, bits, prows, ref, k=k,
                          n_buckets=packed.n_buckets, n_bases=n_bases)
        ref = slot_depth_to_rank(ref, packed_rank_slots(prows, n), n)
        got = engine.finish()
        if not np.array_equal(got, ref[:-1].cpu().numpy().view(np.uint32)):
            raise AssertionError(f"sort-join at n = {n} disagrees with K8")
        mono_ms = cuda_ms(lambda: count_mono_step(
            pk, bits, rows, depth, k=k, n_buckets=mono.n_buckets,
            n_bases=n_bases), 5)
        sj_ms = cuda_ms(lambda: engine.count_codes(
            *kmerize_step(pk, bits, k=k, n_bases=n_bases)), 5)
        out[n] = (round(mono_ms, 4), round(sj_ms, 4))
        if sj_ms < mono_ms:
            best = n
        # the join's least traffic: K9's 9 B a window read, the sorted
        # keys read once, the bincount's depth written once
        j_ms, _ = bound_ms(9 * (n_bases - k + 1) + 8 * n + 4 * (n + 1), 0)
        log(f"  sort-join crossover n = {n}: mono (K2) {mono_ms:.4f} ms, "
            f"sort-join (K9 + torch) {sj_ms:.4f} ms a {n_bases}-base batch "
            f"(the join's bound {j_ms:.4f} ms, bytes); sort-join depth "
            f"equal to K8's ({int(got.sum())} hits)")
        del rows, depth, engine, ref, prows
    return out, best


def check_counter_resume(dic, table, codes):
    """The linear and packed DepthCounters on the card: a snapshot taken
    a third of the way in (rank order, the JAX package's format),
    restored into a new counter whose own snapshot equals it, then
    resumed to the same finish as an uninterrupted counter."""
    from quickmer2_tpu_torch.pipelines.count import DepthCounter
    cut = len(codes) // 3
    for layout, prebuilt in (("linear", None), ("packed", table)):
        t = time.time()

        def counter():
            return DepthCounter(dic, batch_bases=1 << 22, layout=layout,
                                packed_table=prebuilt, device="cuda")
        full = counter()
        full.feed_codes(codes)
        want = full.finish()
        half = counter()
        half.feed_codes(codes[:cut])
        snap = half.snapshot()
        again = counter()
        again.restore(snap)
        if not np.array_equal(again.snapshot()["depth"], snap["depth"]):
            raise AssertionError(f"{layout}: a restored snapshot differs")
        again.feed_codes(codes[cut:])
        if not np.array_equal(again.finish(), want):
            raise AssertionError(f"{layout}: the resumed depth differs")
        log(f"  {layout} DepthCounter: snapshot at {cut} of {len(codes)} "
            f"codes restored (snapshot again equal) and resumed to the "
            f"uninterrupted depth ({int(want.sum())} hits), "
            f"{time.time() - t:.1f} s")
        del full, half, again


def check_flat_engines(fa, g, reads, dev):
    """K7, K8 and K9 against their plain versions: timed at k = 30 on the
    smoke's own .qm (the linear table), its PackedTable (host build
    timed) and one 2^24-base batch of the smoke's reads, K7 and K8 also
    at P = 1, 2 and other slice counts; untimed at k = 15, 31, 32 and on
    a wrapping 4096-slot table, at P = 1, 2 and the smoke's; the linear
    and packed counters' snapshot and resume; K10 on the genome g against
    the same PackedTable; then the sort-join crossover. Returns the timed
    kernel-table rows."""
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.kernels.count_flat import (
        linear_partitions_for, packed_partitions_for)
    from quickmer2_tpu_torch.ops.packed_table import PackedTable
    dic = Dictionary.from_qm(fa + ".qm")
    codes = flat_codes(reads, 1 << 24)
    rows = [check_count_linear(dic, codes, dev, True, "smoke", [])]
    t = time.time()
    table = PackedTable.from_dictionary(dic)
    log(f"  PackedTable.from_dictionary: {dic.n_kmers} keys, "
        f"{table.n_buckets} buckets, host build {time.time() - t:.2f} s")
    rows.append(check_count_packed(table, codes, dic.kmer_size, dev, True,
                                   "smoke", []))
    rows.append(check_count_packed_block(table, codes, dic.kmer_size, dev))
    parts = (linear_partitions_for(dic.hash_size),
             packed_partitions_for(table.n_buckets))
    check_counter_resume(dic, table, codes)
    rows.append(check_member_scan(dic, table, g, dev))
    del table
    torch.cuda.empty_cache()
    rows.append(check_kmerize(codes, dic.kmer_size, dev, True, "smoke"))
    for k, n_keys, n_bases in FLAT_ENGINE_EDGES:
        check_flat_engines_small(np.random.default_rng(k), k, n_keys,
                                 n_bases, dev, parts)
    check_count_linear_wrap(np.random.default_rng(4096), dev, parts[0])
    cross, best = sortjoin_crossover(dic.kmers_in_order, codes,
                                     dic.kmer_size, dev)
    log(f"  sort-join crossover {json.dumps(cross)}: sort-join wins up to "
        f"n = {best} (0: never)")
    torch.cuda.empty_cache()
    return rows


# -- phase 2, the device emit and est's window sums: K10, K11 -------------

def host_members(dic, codes):
    """The host emit's hit set on `codes`: valid, nonzero windows whose
    canonical k-mer the .qm table holds (native.lookup_keys)."""
    from quickmer2_tpu_torch.utils import native
    canon, valid, _ = native.sliding_canon(codes, dic.kmer_size)
    _, found = native.lookup_keys(np.asarray(dic.table), canon)
    return valid & (canon != 0) & found


def member_ungated(rows, pk, bits, k, n_bases, n_buckets):
    """The hit mask of a chunk by a probe of both candidate rows with no
    gate (ops/packed_table.py::probe_packed, as JAX's _member_chunk), and
    the chunk's (chi, clo, valid nonzero)."""
    from quickmer2_tpu_torch.kernels.emit_member import pack_mask
    from quickmer2_tpu_torch.ops.packed_table import probe_packed
    chi, clo, ok = codec_windows(pk, bits, k, n_bases)
    nz = ok & ((chi | clo) != 0)
    found, _, _ = probe_packed(rows, chi, clo, n_buckets, 0)
    return pack_mask(found & nz), chi, clo, nz


def compare_member_scan(scanner, codes, want, label):
    """The scanner's mask on `codes` (K10 a chunk) against the plain
    version (with the scanner's bitmap of keys at h2) and a probe of both
    rows with no gate chunk by chunk, and against the host lookup's
    `want`."""
    from quickmer2_tpu_torch.kernels.emit_member import (
        member_scan_plain, unpack_mask)
    from quickmer2_tpu_torch.ops import rowpack
    n_chunks = 0
    for off, take, seg in scanner.chunks(codes):
        got = scanner.scan_chunk(seg)
        pk, bits = rowpack.pack_rows(seg[None])
        pk = torch.from_numpy(pk[0]).to(scanner.device)
        bits = torch.from_numpy(bits[0]).to(scanner.device)
        plain = member_scan_plain(
            pk, bits, scanner.rows, k=scanner.k, n_buckets=scanner.n_buckets,
            n_bases=len(seg), displaced=scanner.displaced)
        ungated = member_ungated(scanner.rows, pk, bits, scanner.k, len(seg),
                                 scanner.n_buckets)[0]
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        if err != 0:
            raise AssertionError(f"member_scan {label} chunk at {off} "
                                 "disagrees with its plain version")
        if max_abs_err(got, ungated) != 0:
            raise AssertionError(f"member_scan {label} chunk at {off}: the "
                                 "gated h2 read drops a hit that both "
                                 "rows' probe finds")
        if (want is not None and not np.array_equal(
                unpack_mask(got, take), want[off:off + take])):
            raise AssertionError(f"member_scan {label} chunk at {off} "
                                 "disagrees with the host lookup")
        n_chunks += 1
    n = len(codes) - scanner.k + 1
    log(f"  member_scan {label}: {n} windows in {n_chunks} chunks of "
        f"{scanner.chunk}; equal to the plain version, to both rows' "
        "ungated probe" + ("" if want is None else
                           f" and to the host lookup ({int(want.sum())} "
                           "hits)"))


def plant_members(table_rows, g, k, n, rng):
    """Genome codes g[:n + k - 1] with, every 128 bases, a key that sits
    in its h2 bucket (h1's was full at build), and 64 bases after each a
    canonical code absent from the table whose h1 bucket is full (a
    window that misses behind a full h1): the windows K10's bitmap of
    keys at h2 must let through, and those whose h2 read it mostly
    skips. Returns the codes and the counts of each planted."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.ops.hamming_join import _rc_np
    from quickmer2_tpu_torch.ops.hash import djb_pair
    B = table_rows.shape[0]
    e = u32(table_rows.reshape(-1, 4))
    h = djb_pair(e[:, 0], e[:, 1])
    at = torch.arange(e.shape[0], device=e.device) // 2
    moved = ((e[:, 0] | e[:, 1]) != 0) & ((h & (B - 1)) != at)
    keys = ((e[moved, 0] << 32) | e[moved, 1]).cpu().numpy()
    full = ((table_rows[:, :4] != 0).any(1)
            & (table_rows[:, 4:] != 0).any(1))
    top = (1 << (2 * k)) - 1
    cand = rng.integers(1, top, 400_000, dtype=np.int64).astype(np.uint64)
    cand = np.minimum(cand, _rc_np(cand, k)).astype(np.int64)  # canonical
    ch = torch.from_numpy(cand >> 32).to(e.device)
    cl = torch.from_numpy(cand & 0xFFFFFFFF).to(e.device)
    hb = djb_pair(ch, cl) & (B - 1)
    behind = cand[full[hb].cpu().numpy()]
    behind = behind[~np.isin(behind.astype(np.uint64),
                             ((e[:, 0] << 32) | e[:, 1]).cpu().numpy()
                             .astype(np.uint64))]
    out = g[:n + k - 1].copy()
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    slots = np.arange(0, n - 64, 64)
    for start, src in ((slots[0::2], keys), (slots[1::2], behind)):
        src = src[:len(start)].astype(np.uint64)
        bases = ((src[:, None] >> shifts) & np.uint64(3)).astype(np.uint8)
        out[start[:len(src), None] + np.arange(k)] = bases
    return out, min(len(keys), len(slots[0::2])), min(len(behind),
                                                      len(slots[1::2]))


MEMBER_NEIGHBOUR = 64                   # K10 timed at a second P too


def check_member_scan(dic, table, g, dev):
    """K10 against its plain version (with the scanner's bitmap of keys
    at h2), against a probe of both rows with no gate and against the
    host lookup: the whole smoke genome chunked as the scanner chunks it
    (one chunk), against a packed table of the search's .qm k-mers; two
    shards of it (data_devices 2); the genome at chunks of 2^22 with an
    N run over a seam and inside a halo, the tail chunk SEP-padded; a
    2^22-window chunk with the table's keys at h2 and absent codes behind
    a full h1 planted. Then timed on one 2^24-window chunk of the
    genome's codes at the scanner's slice count, each pass by
    torch.profiler, and at P = MEMBER_NEIGHBOUR (checked), with its h2
    row reads with the gate and without it. Returns the kernel-table
    row."""
    from quickmer2_tpu_torch.kernels.emit_member import (
        _member_scan_launch, member_partitions_for, member_scan,
        member_scan_plain)
    from quickmer2_tpu_torch.kernels.block_probe import maybe_displaced
    from quickmer2_tpu_torch.ops import codec, packed_table, rowpack
    from quickmer2_tpu_torch.ops.hash import djb_pair
    from quickmer2_tpu_torch.parallel.emit_parallel import (
        CHUNK, DeviceMembershipScanner)
    k = dic.kmer_size
    scanner = DeviceMembershipScanner(table, k, device=dev)
    want = host_members(dic, g)
    compare_member_scan(scanner, g, want, "genome")
    # search --emit-devices 2's scan: each chunk halo-split over a 2 x 1
    # mesh of the card, K10 a shard
    t = time.time()
    sharded = DeviceMembershipScanner(table, k, data_devices=2,
                                      devices=[dev, dev])
    if not np.array_equal(sharded.scan(g), want):
        raise AssertionError("member_scan over 2 shards disagrees with the "
                             "host lookup")
    log(f"  member_scan, data_devices=2 on the card twice: {len(want)} "
        f"windows, mask equal to the host emit's lookup, "
        f"{time.time() - t:.2f} s")
    seamed = g.copy()
    seam = CHUNK // 4
    seamed[seam - 40: seam + 17] = codec.SEP        # an N run over a seam
    seamed[2 * seam + 11] = codec.SEP               # one inside a halo
    small = DeviceMembershipScanner(table, k, chunk=seam, device=dev)
    compare_member_scan(small, seamed, host_members(dic, seamed),
                        "N runs at seams")
    planted, n_at_h2, n_behind = plant_members(
        scanner.rows, g, k, seam, np.random.default_rng(1414))
    compare_member_scan(small, planted, None,
                        f"{n_at_h2} keys at h2 and {n_behind} absent codes "
                        "behind a full h1 planted")
    # one full chunk of the genome's codes, timed
    codes = np.concatenate([g, g])[:CHUNK + k - 1]
    pk, bits = rowpack.pack_rows(codes[None])
    pk = torch.from_numpy(pk[0]).to(dev)
    bits = torch.from_numpy(bits[0]).to(dev)
    B = table.n_buckets
    kw = dict(k=k, n_buckets=B, n_bases=len(codes))
    rows, disp = scanner.rows, scanner.displaced
    got = member_scan(pk, bits, rows, displaced=disp, **kw)
    plain = member_scan_plain(pk, bits, rows, displaced=disp, **kw)
    ungated, chi, clo, nz = member_ungated(rows, pk, bits, k, len(codes), B)
    torch.cuda.synchronize()
    err = max_abs_err(got, plain)
    if err != 0 or max_abs_err(got, ungated) != 0:
        raise AssertionError("member_scan on a full chunk disagrees with "
                             "its plain version or both rows' probe")
    own = member_partitions_for(B)

    def call():
        member_scan(pk, bits, rows, displaced=disp, **kw)
    ms, queued_ms = kernel_ms(call, 10)
    passes = profile_kernels(call, 5, "member_scan")

    def launch():
        return _member_scan_launch(pk, bits, rows, disp,
                                   n_parts=MEMBER_NEIGHBOUR, **kw)
    if max_abs_err(launch(), ungated) != 0:
        raise AssertionError(f"member_scan at P = {MEMBER_NEIGHBOUR} "
                             "disagrees with both rows' probe")
    sweep = {MEMBER_NEIGHBOUR: round(cuda_ms(launch, 10, queued=True), 4)}
    plain_ms = cuda_ms(lambda: member_scan_plain(pk, bits, rows,
                                                 displaced=disp, **kw), 2)
    # h2 row reads: without the gate every valid nonzero window that h1's
    # row lacks; with it only where h1's row is also full and the
    # window's bit is set
    h = djb_pair(chi, clo)
    h1, _ = packed_table.bucket_hashes_t(h, B)
    r1 = rows[h1].to(torch.int64) & 0xFFFFFFFF
    in1 = (((r1[:, 0] == chi) & (r1[:, 1] == clo))
           | ((r1[:, 4] == chi) & (r1[:, 5] == clo)))
    full1 = (r1[:, :4] != 0).any(1) & (r1[:, 4:] != 0).any(1)
    h2_reads = {"ungated": int((nz & ~in1).sum()),
                "gated": int((nz & ~in1 & full1
                              & maybe_displaced(h, disp)).sum())}
    del r1, in1, full1, h, h1
    # least traffic: the packed chunk, each distinct 32-B candidate row
    # (h1 of every valid nonzero window, h2 where h1 lacks the code, is
    # full and the bitmap lets it through: probe_rows), the mask
    n_rows = probe_rows(rows, chi[nz], clo[nz], displaced=disp)
    n_win = len(codes) - k + 1
    n_bytes = pk.numel() + bits.numel() + 32 * n_rows + 4 * got.numel()
    # ~48 int ops a window, as K8: codec and DJB, two buckets, 4 compares
    b_ms, b_by = bound_ms(n_bytes, 48 * n_win)
    # the one library call beside it: torch.isin of the chunk's valid
    # canonical codes against the survivors' (the membership, unpacked)
    e = rows.reshape(-1, 4).to(torch.int64) & 0xFFFFFFFF
    live = (e[:, 0] | e[:, 1]) != 0
    keys = (e[live, 0] << 32) | e[live, 1]
    q = ((chi << 32) | clo)[nz]
    library_ms = cuda_ms(lambda: torch.isin(q, keys), 3)
    log(f"  member_scan time {ms:.4f} ms (queued {queued_ms:.4f} ms) a "
        f"2^24-window chunk at P = {own}, passes (torch.profiler, ms a "
        f"call) {passes}; queued ms at P = {sweep} (checked); h2 row "
        f"reads {h2_reads}; plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {n_bytes / 1e6:.1f} MB, {n_rows} rows of {B} buckets), "
        f"torch.isin of its {q.numel()} valid nonzero codes against the "
        f"{keys.numel()} survivors {library_ms:.4f} ms")
    return {"name": "member_scan", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/emit_member.cu",
            "replaces": "quickmer2_tpu/parallel/emit_parallel.py:99",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "partitions": own, "passes": passes,
            "sweep_queued_ms": sweep, "h2_row_reads": h2_reads,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


EST_SCALE_KMERS = 101_000_000   # human scale, as tests/test_est.py
EST_SCALE_WINDOW = 1000


def window_inputs(depth, qgc, kstarts, kends, dev):
    """u16 numpy depth / .qgc and window bounds → the wrapper's tensors."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).view(dtype)).to(dev)
    return (put(np.asarray(depth, np.uint16), np.int16),
            put(np.asarray(qgc, np.uint16), np.int16),
            put(np.asarray(kstarts, np.int32), np.int32),
            put(np.asarray(kends, np.int32), np.int32))


def segment_sums_library(depth, qgc, factors, kstarts, kends):
    """The same function by plain PyTorch calls (the library yardstick):
    the products, then torch.segment_reduce over windows and the gaps
    between them."""
    n = depth.numel()
    ks, ke = kstarts.to(torch.int64), kends.to(torch.int64)
    prev = torch.cat([ks.new_zeros(1), ke[:-1]])
    lengths = torch.stack([ks - prev, ke - ks], 1).reshape(-1)
    lengths = torch.cat([lengths, (n - ke[-1:])])

    def run():
        gc = (qgc.to(torch.int64) & 0x1FF).clamp(max=len(factors) - 1)
        prod = factors[gc] * (depth.to(torch.int64) & 0xFFFF).float()
        return torch.segment_reduce(prod, "sum", lengths=lengths)[1:-1:2]
    return run


def check_window_sums(depth, qgc, factors, kstarts, kends, dev, label):
    """K11 on one input: two launches bit for bit the same and equal to
    the plain version (the same summation order), and within 1e-4
    (relative) of a float64 truth. Returns the timings."""
    from quickmer2_tpu_torch.kernels.est_windows import (
        window_sums, window_sums_plain)
    args = (depth, qgc, factors, kstarts, kends)
    got = window_sums(*args)
    again = window_sums(*args)
    plain = window_sums_plain(*args)
    lib = segment_sums_library(*args)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"window_sums {label}: two launches differ")
    err = float((got - plain).abs().max()) if got.numel() else 0.0
    if err != 0:
        raise AssertionError(f"window_sums {label} disagrees with its plain "
                             f"version (max |diff| {err})")
    f64 = factors.double()
    gc = (qgc.to(torch.int64) & 0x1FF).clamp(max=len(factors) - 1)
    cum = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                     torch.cumsum(f64[gc] * (depth.to(torch.int64) & 0xFFFF)
                                  .double(), 0)])
    truth = cum[kends.long()] - cum[kstarts.long()]
    live = truth > 0
    rel = float(((got.double() - truth).abs()[live] / truth[live]).max())
    lib_err = float(((lib().double() - truth).abs()[live]
                     / truth[live]).max())
    log(f"  window_sums {label}: {depth.numel()} k-mers, {kstarts.numel()} "
        f"windows; two launches identical, equal to the plain version; "
        f"max relative error against float64 {rel:.3e} (the library "
        f"composition's {lib_err:.3e})")
    if not rel <= 1e-4:
        raise AssertionError(f"window_sums {label}: relative error {rel} "
                             "against float64 above 1e-4")
    ms, queued_ms = kernel_ms(lambda: window_sums(*args), 10)
    plain_ms = cuda_ms(lambda: window_sums_plain(*args), 2)
    library_ms = cuda_ms(lib, 5)
    covered = int((kends.long() - kstarts.long()).clamp(min=0).sum())
    # least traffic: depth and .qgc of each covered k-mer, the bounds, the
    # sums; ~4 operations a k-mer
    n_bytes = 4 * covered + 12 * kstarts.numel() + 4 * factors.numel()
    b_ms, b_by = bound_ms(n_bytes, 4 * covered)
    log(f"  window_sums {label} time {ms:.4f} ms (queued {queued_ms:.4f} "
        f"ms), plain {plain_ms:.4f} ms, library composition "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB)")
    return {"max_abs_err": err, "max_rel_err_f64": rel, "ms": ms,
            "queued_ms": queued_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def check_window_sums_scale(dev):
    """K11 on a human-scale array: 101 M k-mers, windows of 1,000."""
    n, w = EST_SCALE_KMERS, EST_SCALE_WINDOW
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    depth = torch.poisson(torch.full((n,), 25.0, device=dev),
                          generator=gen).to(torch.int16)
    qgc = torch.randint(0, 401, (n,), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.int16)
    factors = torch.linspace(0.4, 2.8, 401, device=dev)
    kstarts = torch.arange(0, n - w + 1, w, dtype=torch.int32, device=dev)
    res = check_window_sums(depth, qgc, factors, kstarts, kstarts + w, dev,
                            f"{n / 1e6:g} M k-mers")
    del depth, qgc
    torch.cuda.empty_cache()
    return res


def check_est_windows(fa, sample, dev):
    """K11 on the flat count's .bin with the smoke's .qgc / .bed (the
    shapes est gives it). Returns the kernel-table row."""
    from quickmer2_tpu_torch.io import formats
    from quickmer2_tpu_torch.pipelines.est import run_est
    qgc = formats.read_u16(fa + ".qgc")
    depth = formats.read_u16(sample + ".bin")
    n = min(len(qgc), len(depth))
    _, windows = formats.read_windows_bed(fa + ".bed")
    windows = windows[windows[:, 3] < n]
    res = run_est(fa, sample, os.path.join(WORK, "tmp.CN.bed"),
                  verbose=False, device="cuda")
    factors = torch.from_numpy(np.asarray(res["factors"], np.float32)).to(dev)
    d, q, ks, ke = window_inputs(depth[:n], qgc[:n], windows[:, 2],
                                 windows[:, 3], dev)
    row = check_window_sums(d, q, factors, ks, ke, dev, "smoke .bin")
    return {"name": "window_sums", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/est_windows.cu",
            "replaces": "quickmer2_tpu/ops/est_device.py:39", **row}


def est_device_sums(world, sample, reset_counts, read_counts):
    """run_est(device_sums=True) on the flat count, its own path: the
    chroms, starts and ends of the host est's CN bed, CN within 1e-4; K11
    must launch. Returns K11's launches."""
    from quickmer2_tpu_torch.pipelines.est import run_est
    out = sample + ".dev.CN.bed"
    reset_counts()
    t = time.time()
    stats = run_est(world["fa"], sample, out, verbose=False, device="cuda",
                    device_sums=True)
    launches = read_counts()["window_sums"]
    if launches == 0:
        raise AssertionError("window_sums never launched in est "
                             "(device_sums)")
    host = [ln.split("\t") for ln in open(sample + ".CN.bed")]
    dev_rows = [ln.split("\t") for ln in open(out)]
    if [r[:3] for r in host] != [r[:3] for r in dev_rows]:
        raise AssertionError("est device_sums windows differ from the host "
                             "est's")
    diff = max(abs(float(a[3]) - float(b[3]))
               for a, b in zip(host, dev_rows))
    if not diff <= 1e-4:
        raise AssertionError(f"est device_sums CN off the host est's by "
                             f"{diff}")
    log(f"phase est (device_sums): {time.time() - t:.2f} s, "
        f"{len(dev_rows)} windows, max |CN - host CN| {diff:.3e}, "
        f"window_sums launches {launches} "
        f"{json.dumps(stats['phases'])}")
    return launches


def search_emit_pair(world, reset_counts, read_counts):
    """Search at -e 0 with the host emit and with the device emit
    (--emit-devices 1), their own paths: .qm, .bed and .qgc identical;
    K10 must launch. Returns K10's launches."""
    from quickmer2_tpu_torch.config import SearchConfig
    from quickmer2_tpu_torch.pipelines.search import run_search
    outs = []
    for emit_devices in (None, 1):
        out = os.path.join(WORK, f"e0_{emit_devices or 'host'}")
        stats = {}
        reset_counts()
        t = time.time()
        run_search(world["fa"], SearchConfig(
            kmer_size=30, edit_distance=0, window_size=1000,
            control_bed=world["ctrl"]), out_prefix=out, verbose=False,
            stats=stats, device="cuda", emit_devices=emit_devices)
        got = read_counts()["member_scan"]
        log(f"phase search -e 0 (emit_devices={emit_devices}): "
            f"{time.time() - t:.1f} s, emit_s {stats['phases']['emit_s']}, "
            f"emit_table_s {stats['phases'].get('emit_table_s', 0.0)}, "
            f"member_scan "
            f"launches {got} {json.dumps(stats)}")
        outs.append(out)
    if got == 0:
        raise AssertionError("member_scan never launched in the device "
                             "emit's search")
    for ext in (".qm", ".bed", ".qgc"):
        with open(outs[0] + ext, "rb") as f, open(outs[1] + ext, "rb") as h:
            if f.read() != h.read():
                raise AssertionError(f"the device emit's {ext} differs "
                                     "from the host emit's")
        os.remove(outs[0] + ext)
        os.remove(outs[1] + ext)
    log("  device emit: .qm, .bed, .qgc identical to the host emit's")
    return got


def check_host_subcommands(world, dic, cn_bed):
    """sparse 1 on a copy of the smoke's FASTA and .qm (the search's -w
    and control bed): the search's own .bed and .qgc, and the .qm's
    chain; then sparse 50, index on a bed of 100 k dictionary k-mers, and
    colortrack / colorkey on the flat CN bed. Host code: seconds."""
    from quickmer2_tpu_torch.analytics.colortrack import (
        make_colortrack, write_color_key)
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.pipelines.index import run_index
    from quickmer2_tpu_torch.pipelines.sparse import run_sparse
    d = os.path.join(WORK, "sparse")
    os.makedirs(d)
    fa = os.path.join(d, "g.fa")
    os.symlink(world["fa"], fa)
    os.symlink(world["fa"] + ".qm", fa + ".qm")
    for thin in (1, 50):
        t = time.time()
        out = run_sparse(fa, thin, window_size=1000,
                         control_bed=world["ctrl"], verbose=False,
                         device="cuda")
        log(f"phase sparse {thin}: {time.time() - t:.1f} s, "
            f"{out.n_kmers} k-mers kept, hash_size {out.hash_size:#x}")
        if thin == 1:
            for ext in (".bed", ".qgc"):
                with open(fa + ext, "rb") as f, \
                        open(world["fa"] + ext, "rb") as h:
                    if f.read() != h.read():
                        raise AssertionError(f"sparse 1 {ext} differs from "
                                             "the search's")
            rqm = Dictionary.from_qm(fa + ".rqm")
            if not np.array_equal(rqm.kmers_in_order, dic.kmers_in_order):
                raise AssertionError("sparse 1 .rqm chain differs from the "
                                     ".qm's")
            log("  sparse 1: .bed and .qgc identical to the search's, .rqm "
                "chain equal to the .qm's")
        elif not 0 < out.n_kmers < dic.n_kmers // 10:
            raise AssertionError(f"sparse 50 kept {out.n_kmers} k-mers")
    t = time.time()
    k = dic.kmer_size
    kmers = dic.kmers_in_order[::max(1, dic.n_kmers // 100_000)][:100_000]
    lut = np.frombuffer(b"ACTG", np.uint8)
    digits = (kmers[:, None] >> (2 * np.arange(k - 1, -1, -1, dtype=np.uint64))
              ) & np.uint64(3)
    seqs = lut[digits.astype(np.int64)]
    bed = os.path.join(d, "kmers.bed")
    with open(bed, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"chr1\t{i}\t{i + k}\t{s.tobytes().decode()}\n")
    idx = run_index(bed, os.path.join(d, "k.qm"), hash_size=1 << 18,
                    verbose=False, device="cuda")
    if not np.array_equal(idx.kmers_in_order, kmers):
        raise AssertionError("index: the .qm chain is not the bed's k-mers")
    log(f"phase index: {len(kmers)} k-mers in {time.time() - t:.1f} s, "
        "chain equal to the bed's k-mers")
    t = time.time()
    track = make_colortrack(cn_bed, "smoke", os.path.join(d, "s.bedColor"))
    key = write_color_key(os.path.join(d, "color-track.bed"))
    n_track = sum(1 for _ in open(track))
    n_cn = sum(1 for _ in open(cn_bed))
    if not 0 < n_track <= n_cn or sum(1 for _ in open(key)) != 11:
        raise AssertionError("colortrack / colorkey wrote unexpected rows")
    log(f"phase colortrack, colorkey: {n_cn} CN rows merged into {n_track} "
        f"track rows, in {time.time() - t:.2f} s")
    shutil.rmtree(d)


# -- phase 3, the flat engines, checkpoints, the cohort, entry() ---------

# each other flat engine counts the smoke's reads; auto, which picks mono
# by the dictionary's size alone, counts the small world's 50 k reads
ENGINES = ("linear", "packed", "sortjoin")
# the kernel that each flat layout's count launches
LAYOUT_KERNEL = {"mono": "count_mono", "linear": "count_linear",
                 "packed": "count_packed", "sortjoin": "kmerize"}


def count_engines(fa, fq, n_windows, reset_counts, read_counts,
                  engines=ENGINES, mono="s"):
    """run_count of `fq` with each of `engines`, each its own path
    (counts reset just before, read just after): its .bin must equal the
    mono count's (`mono`.bin), and its layout's kernel must launch.
    Returns the launches of K7, K8 and K9 on their engines' paths."""
    from quickmer2_tpu_torch.pipelines.count import run_count
    with open(os.path.join(WORK, mono + ".bin"), "rb") as f:
        want = f.read()
    launches = {}
    for engine in engines:
        out = os.path.join(WORK, f"e_{engine}")
        reset_counts()
        t = time.time()
        st = run_count(fa + ".qm", fq, out, verbose=False, engine=engine,
                       device="cuda")
        count_phase(f"count (flat, {engine})", time.time() - t, st,
                    n_windows)
        got = read_counts()
        kernel = LAYOUT_KERNEL[st["layout"]]
        log(f"launches on the {engine} engine's path: {got}")
        if got[kernel] == 0:
            raise AssertionError(f"{kernel} never launched on the {engine} "
                                 f"engine's path: {got}")
        if engine != "auto":
            launches[kernel] = got[kernel]
        with open(out + ".bin", "rb") as f:
            if f.read() != want:
                raise AssertionError(f"the {engine} engine's .bin differs "
                                     "from the mono .bin")
        log(f"  {engine} (layout {st['layout']}) .bin identical to mono")
    return launches


class Interrupted(Exception):
    pass


class LimitedFile:
    """A file whose reads raise Interrupted after n_reads: a count that
    dies mid-stream."""

    def __init__(self, f, n_reads):
        self._f = f
        self._left = n_reads

    def read(self, n):
        if self._left <= 0:
            raise Interrupted()
        self._left -= 1
        return self._f.read(n)

    def seek(self, n):
        return self._f.seek(n)

    def close(self):
        return self._f.close()


def check_resume(fa, sub):
    """Flat (mono, linear) and anchored counts of the small world's 50 k reads
    interrupted after a few checkpoints, then resumed from them: each
    .bin must equal the uninterrupted count's."""
    import builtins
    from quickmer2_tpu_torch.pipelines.count import run_count
    from quickmer2_tpu_torch.utils import checkpoint
    real = builtins.open
    every = 2 << 20
    for mode, engine in (("flat", "mono"), ("flat", "linear"),
                         ("anchored", "mono")):
        t = time.time()
        ckpt = os.path.join(WORK, f"ck_{mode}_{engine}")
        kw = dict(batch_bases=1 << 22, chunk_bytes=1 << 20, verbose=False,
                  mode=mode, engine=engine, checkpoint_path=ckpt,
                  checkpoint_every_bytes=every, device="cuda")
        out = os.path.join(WORK, f"r_{mode}_{engine}")

        def limited(path, *a, **k):
            f = real(path, *a, **k)
            return LimitedFile(f, 9) if path == sub else f
        builtins.open = limited
        try:
            run_count(fa + ".qm", sub, out, **kw)
            raise AssertionError("the interrupted count ran to its end")
        except Interrupted:
            pass
        finally:
            builtins.open = real
        offset = checkpoint.load(ckpt)[0]
        run_count(fa + ".qm", sub, out, **kw)
        if os.path.exists(ckpt):
            raise AssertionError("the checkpoint outlived its count")
        with open(out + ".bin", "rb") as f, \
                open(os.path.join(WORK, f"sub_{mode}_cuda.bin"), "rb") as h:
            if f.read() != h.read():
                raise AssertionError(f"the resumed {mode} {engine} count "
                                     "differs from the uninterrupted one")
        log(f"phase resume ({mode}, {engine}): interrupted after "
            f"{9 << 20} bytes and {offset // every} checkpoints, resumed from byte "
            f"{offset}; .bin identical to the uninterrupted count, "
            f"{time.time() - t:.1f} s")


def check_cohort(fa, sub):
    """A two-sample cohort (the small world's reads twice: a sample's state must
    not leak into the next) in both modes: each sample's .bin, .txt and
    .CN.bed equal the single-sample run's."""
    from quickmer2_tpu_torch.pipelines.cohort import run_cohort
    singles = {"flat": ("sub_flat_cuda",) * 2,
               "anchored": ("sub_anchored_cuda",) * 2}
    for mode, single in singles.items():
        t = time.time()
        outs = [os.path.join(WORK, f"co_{mode}_{i}") for i in range(2)]
        stats = run_cohort(fa + ".qm", list(zip((sub, sub), outs)), mode=mode,
                           ref_fasta=fa if mode == "anchored" else None,
                           verbose=False, device="cuda")
        for out, ref in zip(outs, single):
            for ext in (".bin", ".txt", ".CN.bed"):
                with open(out + ext, "rb") as f, \
                        open(os.path.join(WORK, ref + ext), "rb") as h:
                    if f.read() != h.read():
                        raise AssertionError(f"cohort ({mode}) {ext} differs "
                                             f"from the single run {ref}")
        log(f"phase cohort ({mode}): 2 samples in {time.time() - t:.1f} s "
            f"({', '.join(str(s['elapsed_s']) for s in stats)} s each); "
            f".bin, .txt, .CN.bed identical to the single-sample runs")


LONG_READS = 300              # 10 kb reads of the small world
LONG_READ_LEN = 2048          # the anchored row width they are cut to


def check_long_reads(world, fa, rng, reset_counts, read_counts):
    """`count --mode anchored --read-len 2048` and `cohort --mode anchored
    --read-len 2048` (the CLI's main in this process, its output sent to
    stderr) on 10 kb reads of the small world, cut into segments of
    2,048: rows that K3 takes a block a row, a warp a tile. Each .bin
    must equal the flat mono count's of the same reads, byte for byte.
    Returns K3's launches on those rows in the two runs, which must be
    nonzero."""
    import contextlib
    from quickmer2_tpu_torch.cli import main as cli_main
    from quickmer2_tpu_torch.pipelines.count import run_count
    t = time.time()
    lfq = os.path.join(WORK, "long.fq")
    write_fastq(lfq, simulate_reads(rng, world["g"][:SMALL_BASES],
                                    LONG_READS, 10_000, 0.001))
    run_count(fa + ".qm", lfq, os.path.join(WORK, "long_flat"),
              verbose=False, device="cuda")
    reset_counts()
    outs = (os.path.join(WORK, "long_anchored"),
            os.path.join(WORK, "long_cohort"))
    wide = ["--mode", "anchored", "--read-len", str(LONG_READ_LEN)]
    with contextlib.redirect_stdout(sys.stderr):
        cli_main(["count", *wide, fa, lfq, outs[0]])
        cli_main(["cohort", *wide, fa, f"{lfq}:{outs[1]}"])
    launched = read_counts()["anchored_wide"]
    with open(os.path.join(WORK, "long_flat.bin"), "rb") as f:
        want = f.read()
    for out in outs:
        with open(out + ".bin", "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{out}.bin (anchored, --read-len "
                                     f"{LONG_READ_LEN}) differs from the "
                                     "flat .bin")
    if launched == 0:
        raise AssertionError("K3 never launched on rows wider than 1,024")
    log(f"phase long reads: {LONG_READS} reads of 10 kb, count and cohort "
        f"--mode anchored --read-len {LONG_READ_LEN}: .bin identical to "
        f"the flat count's, {launched} K3 launches on the wide rows, in "
        f"{time.time() - t:.1f} s")
    return {"anchored_wide": launched}


def check_entry():
    """entry() once on the card, against the same step on the CPU."""
    from quickmer2_tpu_torch.device import to_numpy_u32
    from quickmer2_tpu_torch.entry import entry
    fn, args = entry()
    got = to_numpy_u32(fn(*args))
    fn_cpu, args_cpu = entry(device="cpu")
    want = to_numpy_u32(fn_cpu(*args_cpu))
    if not np.array_equal(got, want):
        raise AssertionError("entry() on the card differs from the CPU")
    log(f"phase entry: entry() on the card, {int(got[:-1].sum())} hits "
        f"and {int(got[-1])} trash of {len(got) - 1} k-mers, equal to the "
        "CPU")


# -- phase 2 and 3, the multi-device layer: K8b, K12, K3a -----------------

DS = 2                      # the dict axis of the kernel checks


def probe_rows(rows, chi, clo, lo=0, bb=None, displaced=None) -> int:
    """The least rows a probe of the nonzero keys (chi, clo) reads in the
    bucket block [lo, lo + bb) of the whole packed table `rows` [B, 8]
    (default: the whole table): the distinct h1 rows in the block, and
    the h2 rows in it of the keys that h1's row does not hold. Given the
    block's bitmap of keys at h2 (`displaced`, the gated probes K8b, K10,
    K12 and K3a), only of those keys that may sit at h2: h1's row full
    where it lies in the block (a key sits at h2 only behind a full h1)
    and the key's bit set."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.kernels.block_probe import maybe_displaced
    from quickmer2_tpu_torch.ops import packed_table
    from quickmer2_tpu_torch.ops.hash import djb_pair
    B = rows.shape[0]
    bb = B if bb is None else bb
    h = djb_pair(chi, clo)
    h1, h2 = packed_table.bucket_hashes_t(h, B)
    r1 = u32(rows[h1])
    need2 = ~(((r1[:, 0] == chi) & (r1[:, 1] == clo))
              | ((r1[:, 4] == chi) & (r1[:, 5] == clo)))
    if displaced is not None:
        full1 = (r1[:, :4] != 0).any(1) & (r1[:, 4:] != 0).any(1)
        local1 = (h1 >= lo) & (h1 < lo + bb)
        need2 &= (full1 | ~local1) & maybe_displaced(h, displaced)
    b = torch.cat([h1, h2[need2]])
    return int(torch.unique(b[(b >= lo) & (b < lo + bb)]).numel())


BLOCK_SWEEP = (16, 32, 64, 128, 256)    # K8b's slice counts, timed


def check_count_packed_block(table, codes, k, dev):
    """K8b at the main path's shapes: one 2^24-base batch of the reads
    split over dp = 2 data shards (split_codes_overlap, a k - 1 halo),
    each against every bucket block of the smoke's PackedTable at ds = 1,
    2 and 4, against its plain version at the block's own slice count P
    and at P = 1 and 2; at each ds the rank-space partials
    (block_slot_depth_to_rank) sum to K8's rank-space count of the whole
    batch. Timed on shard 0 against block 0 at each ds, each pass by
    torch.profiler, and at each P of BLOCK_SWEEP (each checked); at ds =
    2 the four launches of the batch beside one K8 launch on it. Returns
    the kernel-table row (ds = 2, the smoke's mesh)."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.kernels.block_probe import (
        block_displaced_filter)
    from quickmer2_tpu_torch.kernels.count_flat import (
        block_slot_depth_to_rank, count_packed_block_launch,
        count_packed_block_step, count_packed_block_step_plain,
        count_packed_step, packed_block_entries, packed_partitions_for,
        packed_rank_slots, slot_depth_to_rank)
    from quickmer2_tpu_torch.parallel.count_parallel import (
        split_codes_overlap)
    B, n = table.n_buckets, table.n_kmers
    rows_all = table.device_rows(dev)
    shards = split_codes_overlap(codes, 2, k)
    batches = [flat_batch(shards[i], dev) for i in range(2)]
    pk, bits, _ = flat_batch(codes, dev)
    d8 = torch.zeros(2 * B + 1, dtype=torch.int32, device=dev)

    def k8():
        count_packed_step(pk, bits, rows_all, d8, k=k, n_buckets=B,
                          n_bases=len(codes))
    k8()
    want = slot_depth_to_rank(d8, packed_rank_slots(rows_all, n), n)
    err, by_ds = 0, {}
    for ds in (1, 2, 4):
        bb = B // ds
        own = packed_partitions_for(bb)
        kw = dict(k=k, n_buckets=B, block_buckets=bb,
                  n_bases=shards.shape[1])

        def zero():
            return torch.zeros(2 * bb + 1, dtype=torch.int32, device=dev)
        total = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        depths = []
        for i in range(2):
            spk, sbits, _ = batches[i]
            for j in range(ds):
                rows = rows_all[j * bb:(j + 1) * bb]
                disp = block_displaced_filter(rows, B, j * bb)
                d_k, d_p = zero(), zero()
                count_packed_block_step(spk, sbits, rows, disp, d_k,
                                        blk_lo=j * bb, **kw)
                count_packed_block_step_plain(spk, sbits, rows, disp, d_p,
                                              blk_lo=j * bb, **kw)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(d_k, d_p))
                if err != 0:
                    raise AssertionError(
                        f"count_packed_block ds {ds} shard {i} block {j} "
                        "disagrees with its plain version")
                compare_parts("count_packed_block",
                              f"ds {ds} shard {i} block {j}",
                              lambda d, p: count_packed_block_launch(
                                  spk, sbits, rows, disp, d, blk_lo=j * bb,
                                  n_parts=p, **kw), d_p, sorted({1, 2, own}),
                              zero)
                if i == j == 0:         # the slice-count sweep, each P checked
                    compare_parts("count_packed_block", f"ds {ds} sweep",
                                  lambda d, p: count_packed_block_launch(
                                      spk, sbits, rows, disp, d, blk_lo=0,
                                      n_parts=p, **kw), d_p, BLOCK_SWEEP,
                                  zero)
                    d_s = zero()
                    sweep = {p: round(cuda_ms(
                        lambda p=p: count_packed_block_launch(
                            spk, sbits, rows, disp, d_s, blk_lo=0,
                            n_parts=p, **kw), 10, queued=True), 4)
                        for p in BLOCK_SWEEP}
                total += u32(block_slot_depth_to_rank(
                    d_k, packed_block_entries(rows), n))
                depths.append((i, j, rows, disp, d_k))
        if max_abs_err((total & 0xFFFFFFFF)[:n], want[:n]) != 0:
            raise AssertionError(f"count_packed_block's partials at ds {ds} "
                                 "do not sum to count_packed's depth")
        spk, sbits, nbytes = batches[0]
        rows, disp, d_k = depths[0][2:]
        def step():
            count_packed_block_step(spk, sbits, rows, disp, d_k, blk_lo=0,
                                    **kw)
        ms, queued_ms = kernel_ms(step, 10)
        passes = profile_kernels(step, 5, f"count_packed_block at ds {ds}")
        # least traffic: the packed shard, the block's 32-B rows its
        # valid nonzero windows must read (probe_rows), the 32-B sector
        # of each slot word with a hit read and written; ~48 int ops a
        # window, as K8
        chi, clo, ok = codec_windows(spk, sbits, k, kw["n_bases"])
        nz = ok & ((chi | clo) != 0)
        rows_touched = probe_rows(rows_all, chi[nz], clo[nz], 0, bb,
                                  disp)
        d_sec = int(torch.unique(torch.nonzero(d_k[:-1]).flatten() // 8)
                    .numel()) + 1
        n_bytes = nbytes + 32 * rows_touched + 64 * d_sec
        b_ms, b_by = bound_ms(n_bytes, 48 * (kw["n_bases"] - k + 1))
        by_ds[ds] = {"ms": ms, "queued_ms": queued_ms, "partitions": own,
                     "bound_ms": b_ms, "bound_by": b_by, "passes": passes,
                     "sweep_queued_ms": sweep}
        log(f"  count_packed_block ds {ds}: 2 shards of {kw['n_bases']} "
            f"bases x {ds} blocks of {bb} buckets (P = {own}; checked at "
            f"P = 1, 2), partials summing to count_packed's depth; time "
            f"{ms:.4f} ms (queued {queued_ms:.4f} ms) a shard and block, "
            f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
            f"{rows_touched} local rows, {d_sec} depth sectors); passes "
            f"(torch.profiler, ms a call) {passes}; queued ms at P = "
            f"{sweep} (each checked)")
        if ds == 2:
            plain_ms = cuda_ms(lambda: count_packed_block_step_plain(
                spk, sbits, rows, disp, d_k, blk_lo=0, **kw), 2)

            def four():
                for i, j, r, f, d in depths:
                    count_packed_block_step(*batches[i][:2], r, f, d,
                                            blk_lo=j * bb, **kw)
            four_ms = cuda_ms(four, 10, queued=True)
    k8_ms = cuda_ms(k8, 10, queued=True)
    log(f"  count_packed_block at (2, 2): the batch's four launches "
        f"{four_ms:.4f} ms queued, one count_packed on it {k8_ms:.4f} ms")
    row = {"name": "count_packed_block", "route": "cuda",
           "source": "quickmer2_tpu_torch/csrc/count_flat.cu",
           "replaces": "quickmer2_tpu/parallel/count_parallel.py:63",
           "max_abs_err": err, "plain_ms": plain_ms,
           "four_launches_queued_ms": four_ms, "k8_batch_queued_ms": k8_ms,
           "library_ms": None}
    row.update(by_ds[2])
    row["by_ds"] = by_ds
    return row


def plant_displaced(rows_all, rows, k, n_plant, offsets=(10,)):
    """A copy of the read rows with n_plant keys of the table that sit in
    their h2 bucket (h1's was full at build) written into its first rows,
    one a row at each of `offsets`: windows that K12 (and K3a, with its
    anchor offsets) finds only through its bitmap of displaced keys."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.ops.hash import djb_pair
    e = u32(rows_all.reshape(-1, 4))
    h = djb_pair(e[:, 0], e[:, 1])
    at = torch.arange(e.shape[0], device=e.device) // 2
    moved = (((e[:, 0] | e[:, 1]) != 0)
             & ((h & (rows_all.shape[0] - 1)) != at))
    keys = ((e[moved, 0] << 32) | e[moved, 1])[:n_plant].cpu().numpy()
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    bases = ((keys.astype(np.uint64)[:, None] >> shifts)
             & np.uint64(3)).astype(np.uint8)
    out = rows.copy()
    n = 0
    for t, a in enumerate(offsets):
        b = bases[t::len(offsets)][:len(out)]
        out[:len(b), a:a + k] = b
        n += len(b)
    return out, n


def k12_counts(rows_all, chi, clo, disp, lo, bb) -> dict:
    """K12's probe counts on one batch's valid nonzero codes (chi, clo)
    against the bucket block [lo, lo + bb) of the whole table rows_all:
    h1 rows read (each local h1), h2 rows read (local, where the bitmap
    `disp` allows and h1's row, where it is read, is full and lacks the
    key), hits, distinct rows touched and distinct 32-B acc sectors with
    a hit."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.kernels.block_probe import maybe_displaced
    from quickmer2_tpu_torch.ops import packed_table
    from quickmer2_tpu_torch.ops.hash import djb_pair
    h = djb_pair(chi, clo)
    h1, h2 = packed_table.bucket_hashes_t(h, rows_all.shape[0])

    def match(b):
        r = u32(rows_all[b])
        m0 = (r[:, 0] == chi) & (r[:, 1] == clo)
        full = (r[:, :4].amax(1) != 0) & (r[:, 4:].amax(1) != 0)
        return (m0 | ((r[:, 4] == chi) & (r[:, 5] == clo)),
                torch.where(m0, r[:, 2], r[:, 6]), full)
    in1, rank1, full1 = match(h1)
    in2, rank2, _ = match(h2)
    loc1 = (h1 >= lo) & (h1 < lo + bb)
    loc2 = (h2 >= lo) & (h2 < lo + bb)
    read2 = loc2 & maybe_displaced(h, disp) & ~(loc1 & (in1 | ~full1))
    hit1 = loc1 & in1
    hit = hit1 | (read2 & in2)
    rank = torch.where(hit1, rank1, rank2)[hit]
    return {"h1_rows_read": int(loc1.sum()), "h2_rows_read": int(read2.sum()),
            "hits": int(hit.sum()),
            "distinct_rows": int(torch.unique(torch.cat(
                [h1[loc1], h2[read2]])).numel()),
            "distinct_acc_sectors": int(torch.unique(rank // 8).numel())}


def exact_rows_both_rows(pk, aux, rows_j, acc, *, fmt, k, n_buckets,
                         read_len, blk_lo, block_buckets):
    """K12's reference that assumes nothing of the table's placement:
    every valid window probed in both candidate rows, ungated
    (ops/packed_table.py::probe_packed_block), 1 added at the rank of
    each one found. K12 and its plain version read h2 only where h1's
    row is full and the bitmap allows; this holds both shortcuts to the
    whole table."""
    from quickmer2_tpu_torch.kernels.count_mono import row_windows
    from quickmer2_tpu_torch.ops.packed_table import probe_packed_block
    chi, clo, valid = row_windows(pk, aux, fmt=fmt, k=k, read_len=read_len)
    found, rank, _ = probe_packed_block(rows_j, chi, clo, n_buckets,
                                        block_buckets, blk_lo, 0)
    hit = rank[valid & found]
    acc.index_add_(0, hit, torch.ones(hit.shape, dtype=acc.dtype,
                                      device=acc.device))


def check_count_packed_rows(index, rows, k, dev):
    """K12 on the main path's exact batch and on that batch with 2,000
    keys that sit at h2 planted into it, in the lens and the mask format:
    through the whole packed table (ds = 1, the single-device counter's
    recount with mono_spill off and the sharded one's at (2, 1)) and
    through each of its two bucket blocks (ds = 2), with the block's
    bitmap of displaced keys, each against its plain version and
    against a probe of both candidate rows with no gate
    (exact_rows_both_rows: neither the bitmap nor the skip of h2 behind
    an h1 row with an empty entry drops a hit); the blocks'
    accumulators sum to the whole table's. Timed on the exact batch at
    ds = 1 (with the wrapper's host time and the kernel by
    torch.profiler) and on block 0 at ds = 2, with K12's probe counts.
    Returns the kernel-table row."""
    from quickmer2_tpu_torch.kernels import count_mono as cm
    from quickmer2_tpu_torch.kernels.block_probe import (
        block_displaced_filter)
    from quickmer2_tpu_torch.ops import codec
    B = index.n_buckets
    planted, n_planted = plant_displaced(index.rows, rows, k, 2000)
    masked = planted.copy()
    masked[::7, 60] = codec.SEP
    disp = {ds: [block_displaced_filter(
        index.rows[j * (B // ds):(j + 1) * (B // ds)], B, j * (B // ds))
        for j in range(ds)] for ds in (1, DS)}

    def zero():
        return torch.zeros(index.n_kmers + 2, dtype=torch.int32, device=dev)
    err = 0
    for label, batch in (("exact batch", rows), ("planted", planted),
                         ("planted, mask format", masked)):
        fmt, pk, aux, _ = packed_on(batch, dev)
        kw = dict(fmt=fmt, k=k, n_buckets=B, read_len=batch.shape[1])
        accs = []
        for ds in (1, DS):
            bb = B // ds
            total = zero()
            for j in range(ds):
                blk = dict(kw, blk_lo=j * bb, block_buckets=bb)
                rows_j = index.rows[j * bb:(j + 1) * bb]
                a_k, a_p, a_all = zero(), zero(), zero()
                cm.count_packed_rows(pk, aux, rows_j, a_k,
                                     displaced=disp[ds][j], **blk)
                cm.count_packed_rows_plain(pk, aux, rows_j, a_p,
                                           displaced=disp[ds][j], **blk)
                exact_rows_both_rows(pk, aux, rows_j, a_all, **blk)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(a_k, a_p))
                if err != 0:
                    raise AssertionError(
                        f"count_packed_rows ({label}, ds {ds}, block {j}) "
                        "disagrees with its plain version")
                if max_abs_err(a_p, a_all) != 0:
                    raise AssertionError(
                        f"count_packed_rows ({label}, ds {ds}, block {j}): "
                        "the gated h2 read drops a hit that both rows' "
                        "probe finds")
                total += a_p
            accs.append(total)
        if max_abs_err(accs[0], accs[1]) != 0:
            raise AssertionError(f"count_packed_rows' blocks ({label}) do "
                                 "not sum to the whole table's count")
        log(f"  count_packed_rows ({label}, {fmt}): whole table and {DS} "
            f"blocks equal to the plain version and to both rows' ungated "
            f"probe, {int(accs[0].sum())} hits")
    fmt, pk, aux, in_bytes = packed_on(rows, dev)
    kw = dict(fmt=fmt, k=k, n_buckets=B, read_len=rows.shape[1])
    acc = zero()

    def call():
        cm.count_packed_rows(pk, aux, index.rows, acc, displaced=disp[1][0],
                             **kw)
    ms, queued_ms = kernel_ms(call, 10)
    wrapper_ms = host_ms(call, 50)
    passes = profile_kernels(call, 5, "count_packed_rows")
    plain_ms = cuda_ms(lambda: cm.count_packed_rows_plain(
        pk, aux, index.rows, acc, displaced=disp[1][0], **kw), 2)
    bb = B // DS
    block_queued_ms = cuda_ms(lambda: cm.count_packed_rows(
        pk, aux, index.rows[:bb], acc, displaced=disp[DS][0], blk_lo=0,
        block_buckets=bb, **kw), 10, queued=True)
    # least traffic: the packed rows in, the 32-B table rows the valid
    # nonzero windows must read (probe_rows), the 32-B sector of each rank
    # word with a hit read and written; ~48 int ops a valid window
    chi, clo, ok = cm.row_windows(pk, aux, fmt=fmt, k=k,
                                  read_len=rows.shape[1])
    nz = ok & ((chi | clo) != 0)
    counts = {ds: k12_counts(index.rows, chi[nz], clo[nz], disp[ds][0], 0,
                             B // ds) for ds in (1, DS)}
    rows_touched = probe_rows(index.rows, chi[nz], clo[nz],
                              displaced=disp[1][0])
    d_sec = counts[1]["distinct_acc_sectors"]
    n_bytes = in_bytes + 32 * rows_touched + 64 * d_sec
    b_ms, b_by = bound_ms(n_bytes, 48 * int(ok.sum()))
    log(f"  count_packed_rows ({fmt}): {len(rows)} rows of {rows.shape[1]}, "
        f"{nz.numel()} windows, {int(ok.sum())} valid, {int(nz.sum())} "
        f"valid nonzero; time {ms:.4f} ms (queued {queued_ms:.4f} ms), "
        f"block 0 of {DS} {block_queued_ms:.4f} ms queued, wrapper host "
        f"time {wrapper_ms:.4f} ms a call, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, {rows_touched} "
        f"rows, {d_sec} sectors); kernels (torch.profiler, ms a call) "
        f"{passes}; probe counts by ds (block 0) {counts}; {n_planted} "
        f"displaced keys planted")
    return {"name": "count_packed_rows", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/count_mono.cu",
            "replaces": "quickmer2_tpu/ops/anchored.py:870",
            "max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
            "host_ms": wrapper_ms, "plain_ms": plain_ms,
            "block_queued_ms": block_queued_ms, "passes": passes,
            "probe_counts": counts,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def anchor_windows(pk, aux, pkw):
    """(chi, clo, valid) of the anchor windows of a packed batch, [A, R]
    each, by the plain codec."""
    from quickmer2_tpu_torch.kernels import anchored as ka
    _, chi, clo, valid = ka._read_windows(pk, aux, pkw["fmt"], pkw["k"],
                                          pkw["read_len"])
    offs = list(pkw["anchor_offsets"])
    return chi[:, offs].T, clo[:, offs].T, valid[:, offs].T


def probe_blocks(index, pk, aux, pkw, disp, label, dev):
    """K3a on each block (len(disp) blocks, disp their bitmaps of
    displaced keys) against its plain version and both rows' ungated
    probe (kernels/anchored.py::_anchor_probes); returns found and pos
    summed over the blocks, found at most 1 a window."""
    from quickmer2_tpu_torch.device import u32
    from quickmer2_tpu_torch.kernels import anchored as ka
    B, ds = index.n_buckets, len(disp)
    bb = B // ds
    chi, clo, valid = anchor_windows(pk, aux, pkw)
    f_sum = p_sum = 0
    for j in range(ds):
        rows_j = index.rows[j * bb:(j + 1) * bb]
        blk = dict(pkw, blk_lo=j * bb, block_buckets=bb)
        f, p = ka.anchor_probes(pk, aux, rows_j, displaced=disp[j], **blk)
        fp, pp = ka.anchor_probes_plain(pk, aux, rows_j, displaced=disp[j],
                                        **blk)
        fu, pu = ka._anchor_probes(rows_j, chi.T, clo.T, valid.T,
                                   list(range(len(pkw["anchor_offsets"]))),
                                   B, j * bb, bb)
        torch.cuda.synchronize()
        if max(max_abs_err(f, fp), max_abs_err(p, pp)) != 0:
            raise AssertionError(f"anchor_probes ({label}, ds {ds}, block "
                                 f"{j}) disagrees with its plain version")
        if (max_abs_err(f, fu.to(torch.uint8)) != 0
                or max_abs_err(p, pu) != 0):
            raise AssertionError(
                f"anchor_probes ({label}, ds {ds}, block {j}): the gated h2 "
                "read drops a hit that both rows' probe finds")
        f_sum = f_sum + f.long()
        p_sum = p_sum + u32(p)
    if int(f_sum.max()) > 1:
        raise AssertionError("a key was found on two blocks")
    log(f"  anchor_probes ({label}, {pkw['fmt']}, rows of "
        f"{pkw['read_len']}) on {ds} blocks: {int(f_sum.sum())} anchors "
        f"found at offsets {list(pkw['anchor_offsets'])}, equal to the "
        "plain version and to both rows' ungated probe")
    return f_sum, p_sum


def count_blocks(index, pk, aux, kw, f_sum, p_sum, label, dev):
    """K3 with the summed anchors on each of DS blocks against its plain
    version: its codes those of the one-launch K3, its diffs summing to
    that K3's. Returns (found, pos) as K3 takes them."""
    from quickmer2_tpu_torch.device import store
    from quickmer2_tpu_torch.kernels import anchored as ka
    tab = (index.genome_tiles, index.dblock)
    bb = index.n_buckets // DS
    found = (f_sum > 0).to(torch.uint8)
    pos = store(p_sum, torch.int32)
    one = torch.zeros(index.n_kmers + 2, dtype=torch.int32, device=dev)
    c_one = ka.anchored_count(pk, aux, index.rows, *tab, one, **kw)
    total = torch.zeros_like(one)
    for j in range(DS):
        bkw = dict(kw, anchors=(found, pos), blk_lo=j * bb,
                   block_buckets=bb, ranges=j == 0)
        rows_j = index.rows[j * bb:(j + 1) * bb]
        d_k, d_p = torch.zeros_like(one), torch.zeros_like(one)
        c_k = ka.anchored_count(pk, aux, rows_j, *tab, d_k, **bkw)
        c_p = ka.anchored_count_plain(pk, aux, rows_j, *tab, d_p, **bkw)
        torch.cuda.synchronize()
        if max(max_abs_err(d_k, d_p), max_abs_err(c_k, c_p),
               max_abs_err(c_k, c_one)) != 0:
            raise AssertionError(f"anchored_count on blocks ({label}) "
                                 "disagrees with its plain version or the "
                                 "one-launch K3")
        total += d_k
    if max_abs_err(total, one) != 0:
        raise AssertionError(f"{label}: the blocks' diffs do not sum to the "
                             "one-launch K3's")
    log(f"  anchored_count on {DS} blocks, {label} ({kw['fmt']}, rows of "
        f"{kw['read_len']}): codes 0/1/2 = "
        f"{np.bincount(c_one.cpu().numpy(), minlength=3).tolist()} "
        "as the one-launch K3's, blocks' diffs summing to its diff, equal "
        "to the plain version")
    return found, pos


def check_anchor_probes(index, counter, tier1, tier2, wide, dev):
    """K3a and K3 on bucket blocks, on the main path's tier-1 and tier-2
    batches and on the tier-1 batch with 4,000 keys that sit at h2
    planted at the anchor offsets (lens and mask format): K3a on each
    block at ds = 2 and 4, with the block's bitmap of displaced keys,
    against its plain version and against a probe of both candidate
    rows with no gate (probe_blocks), its found summed over the blocks
    at most 1 a window; at ds = 2 K3 with the summed anchors on each
    block against its plain version, its codes those of the one-launch
    K3 and its diffs summing to that K3's (count_blocks). The planted
    batch cut to rows of 150 (lens and mask format: K3a's byte loads)
    at ds = 2 against the same two, and the rows of 2,048 that
    check_anchored_edges returns (`wide`, lens and mask: K3's block over
    tiles with the summed anchors) at ds = 2 in tiers 1 and 2 and with
    point probes. K3a timed
    on block 0 of the tier-1 batch at ds = 2, with its wrapper's host
    time and its h2 row reads with the gate and without (both local
    candidates); K3 on block 0 with the summed anchors timed in tiers 1
    and 2, beside its plain version and a bound from the block's own
    inputs (its local rows, the given anchors, the tiles, dblock rows
    and diff words its reads need). Returns the kernel-table rows of
    K3a and of K3 on a block (tier 1; tier 2 under "tier2")."""
    from quickmer2_tpu_torch.kernels import anchored as ka
    from quickmer2_tpu_torch.kernels.block_probe import (
        block_displaced_filter)
    from quickmer2_tpu_torch.ops import codec, packed_table
    from quickmer2_tpu_torch.ops.anchored import AnchoredDepthCounter
    from quickmer2_tpu_torch.ops.hash import djb_pair
    B = index.n_buckets
    tab = (index.genome_tiles, index.dblock)
    disp = {ds: [block_displaced_filter(
        index.rows[j * (B // ds):(j + 1) * (B // ds)], B, j * (B // ds))
        for j in range(ds)] for ds in (DS, 4)}
    offs = list(counter.anchor_offsets)
    planted, n_planted = plant_displaced(index.rows, tier1, counter.k, 4000,
                                         offsets=offs)
    masked = planted.copy()
    masked[::7, offs[1] + 5] = codec.SEP
    block = {}
    bb = B // DS
    for tier, label, rows in ((1, "tier 1", tier1), (2, "tier 2", tier2),
                              (1, "planted", planted),
                              (1, "planted, mask format", masked)):
        fmt, pk, aux, in_bytes = packed_on(rows, dev)
        kw = dict(fmt=fmt, **counter._tier_kw(tier))
        pkw = dict(fmt=fmt, k=kw["k"], read_len=kw["read_len"],
                   n_buckets=B, anchor_offsets=kw["anchor_offsets"])
        for ds in (DS, 4):
            f_sum, p_sum = probe_blocks(index, pk, aux, pkw, disp[ds], label,
                                        dev)
            if ds != DS or tier == 1 and label != "tier 1":
                continue
            found, pos = count_blocks(index, pk, aux, kw, f_sum, p_sum,
                                      f"tier {tier}", dev)
            # block 0 with the summed anchors, timed
            bkw = dict(kw, anchors=(found, pos), blk_lo=0, block_buckets=bb,
                       ranges=True)
            rows_j = index.rows[:bb]
            d_k = torch.zeros(index.n_kmers + 2, dtype=torch.int32,
                              device=dev)
            d_p = torch.zeros_like(d_k)
            tr = {}
            ka.anchored_count_plain(pk, aux, rows_j, *tab, d_p, trace=tr,
                                    **bkw)
            ms_b, queued_b = kernel_ms(
                lambda: ka.anchored_count(pk, aux, rows_j, *tab, d_k, **bkw),
                10)
            plain_b = cuda_ms(lambda: ka.anchored_count_plain(
                pk, aux, rows_j, *tab, d_p, **bkw), 1, warm=0)
            # the given anchors: found (1 B) and pos (4 B) a window
            b_ms, b_by, n_bytes, n_ops, uniq = anchored_bound(
                tr, in_bytes, rows, 5 * found.numel())
            block[tier] = {"ms": ms_b, "queued_ms": queued_b,
                           "plain_ms": plain_b, "bound_ms": b_ms,
                           "bound_by": b_by}
            log(f"  anchored_count on block 0 of {DS}, tier {tier} "
                f"({fmt}), given anchors: time {ms_b:.4f} ms "
                f"(queued {queued_b:.4f} ms), plain {plain_b:.4f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}: "
                f"{n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.4f} G ops; "
                f"{uniq}, {tr['probes']} probes)")
        if label == "tier 1":
            timed = (pk, aux, in_bytes, pkw, rows.shape[0])
    # rows of 150 bases (a --read-len that is no multiple of 32): K3a's
    # byte loads of the packed bases and of the invalid bits
    for label, rows in (("planted, rows of 150", planted[:, :150]),
                        ("planted, rows of 150, mask format",
                         masked[:, :150])):
        fmt, pk, aux, _ = packed_on(np.ascontiguousarray(rows), dev)
        L = rows.shape[1]
        pkw = dict(fmt=fmt, k=counter.k, read_len=L, n_buckets=B,
                   anchor_offsets=[a for a in offs if a <= L - counter.k])
        probe_blocks(index, pk, aux, pkw, disp[DS], label, dev)
    # rows of 2,048: K3a, and K3's block over tiles with the summed
    # anchors in all three branches
    wide_counter = AnchoredDepthCounter(index, counter.k, wide[0].shape[1],
                                        prefetch_puts=False, device=dev)
    t1 = wide_counter._tier_kw(1)
    for rows in wide:
        fmt, pk, aux, _ = packed_on(rows, dev)
        pkw = dict(fmt=fmt, k=t1["k"], read_len=t1["read_len"], n_buckets=B,
                   anchor_offsets=t1["anchor_offsets"])
        f_sum, p_sum = probe_blocks(index, pk, aux, pkw, disp[DS],
                                    "wide rows", dev)
        for label, kw in branch_kws(wide_counter):
            count_blocks(index, pk, aux, dict(kw, fmt=fmt), f_sum, p_sum,
                         f"wide rows, {label}", dev)
    del wide_counter
    pk, aux, in_bytes, pkw, R = timed
    chi, clo, valid = anchor_windows(pk, aux, pkw)
    rows0 = index.rows[:bb]
    pkw = dict(pkw, blk_lo=0, block_buckets=bb)

    def call():
        ka.anchor_probes(pk, aux, rows0, displaced=disp[DS][0], **pkw)
    ms, queued_ms = kernel_ms(call, 10)
    wrapper_ms = host_ms(call, 50)
    plain_ms = cuda_ms(lambda: ka.anchor_probes_plain(
        pk, aux, rows0, displaced=disp[DS][0], **pkw), 2)
    # least traffic: the packed rows in, the block's 32-B rows the valid
    # anchor windows must read (probe_rows), found (1 B) and pos (4 B) out
    # a window; ~60 int ops a probe (codec of k bases, DJB, compares)
    qh, ql = chi[valid], clo[valid]
    nz = (qh | ql) != 0
    rows_touched = probe_rows(index.rows, qh[nz], ql[nz], 0, bb,
                              disp[DS][0])
    n_bytes = in_bytes + 32 * rows_touched + 5 * len(offs) * R
    b_ms, b_by = bound_ms(n_bytes, 60 * int(valid.sum()))
    reads = k12_counts(index.rows, qh[nz], ql[nz], disp[DS][0], 0, bb)
    h1, h2 = packed_table.bucket_hashes_t(djb_pair(qh[nz], ql[nz]), B)
    ungated = int(((h1 < bb).sum() + (h2 < bb).sum()).item())
    log(f"  anchor_probes time {ms:.4f} ms (queued {queued_ms:.4f} ms) on "
        f"block 0 of {DS} of the tier-1 batch, wrapper host time "
        f"{wrapper_ms:.4f} ms a call, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, {rows_touched} "
        f"local rows, {int(valid.sum())} probes); rows read with the gate "
        f"{reads}, without it (both local candidates) {ungated}; "
        f"{n_planted} displaced keys planted")
    return [{"name": "anchor_probes", "route": "cuda",
             "source": "quickmer2_tpu_torch/csrc/anchored.cu",
             "replaces": "quickmer2_tpu/ops/anchored.py:575",
             "max_abs_err": 0, "ms": ms, "queued_ms": queued_ms,
             "host_ms": wrapper_ms, "plain_ms": plain_ms,
             "probe_counts": dict(reads, ungated_rows_read=ungated),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None},
            {"name": "anchored_block", "route": "cuda",
             "source": "quickmer2_tpu_torch/csrc/anchored.cu",
             "replaces": "quickmer2_tpu/ops/anchored.py:548",
             "max_abs_err": 0, **block[1], "library_ms": None,
             "tier2": block[2]}]


DIST_WORKER = r"""
import sys
sys.path.insert(0, {root!r})
from quickmer2_tpu_torch.parallel import distributed as dist
dist.initialize("file://" + {rdv!r}, 2, int(sys.argv[1]), backend="gloo",
                device="cuda")
st = dist.run_count_distributed({qm!r}, {sample!r}, {out!r},
                                batch_bases=1 << 22, verbose=False,
                                device="cuda")
print("DONE", st["process"], st["shard"])
"""


def count_sharded(dic, index, sample, mode, dp, ds, out):
    """One count of `sample` through a StreamCounter on a dp x ds mesh of
    cuda:0 (dp = ds = 1: one device, the flat count on the packed engine
    that the sharded one shards), its .bin written; returns the seconds
    of the set-up (the counter and its tables; the anchored row width
    given, so that its counter is built here) and of the stream and
    finish."""
    from quickmer2_tpu_torch.io import formats
    from quickmer2_tpu_torch.pipelines.count import StreamCounter, make_packer
    t = time.time()
    sc = StreamCounter(dic, mode=mode, index=index, batch_bases=1 << 22,
                       read_len=ANCHOR_READ_LEN if index else None,
                       engine="packed", data_devices=dp, dict_devices=ds,
                       devices=["cuda:0"] * (dp * ds), device="cuda")
    setup_s = time.time() - t
    t = time.time()
    packer = make_packer("fastq")
    with open(sample, "rb") as f:
        while True:
            data = f.read(1 << 24)
            if not data:
                break
            sc.feed_codes(packer.feed(data))
    depth = sc.finish()
    torch.cuda.synchronize()
    count_s = time.time() - t
    formats.write_u16(out + ".bin", (depth & 0xFFFF).astype(np.uint16))
    return setup_s, count_s


def check_multi_device(fa, sub, reset_counts, read_counts):
    """The multi-device layer on one card, on the small world's 50 k reads,
    dictionary and .qai: the flat ShardedDepthCounter at
    (dp, ds) = (2, 2) and the ShardedAnchoredCounter at (2, 1) and (2, 2),
    all on [cuda:0] x 4 (the (2, 2) one from an index whose packed rows
stay on the host), each .bin byte-identical to the one-card count's
    (timed beside one-device counts through the same StreamCounter: the
    flat one on the packed engine, the anchored one with its mono
    table);
    then a two-process run_count_distributed, two subprocesses on cuda:0
    meeting over a file:// rendezvous with backend="gloo" (NCCL needs a
    card a process), rank 0's .bin equal to the one-card flat .bin; and
    dryrun_multichip(4) on [cuda:0] x 4. The launch counters are reset
    before the in-process counts and read after them; K8b, K12 and K3a
    (and K3 on blocks) must have launched. Returns the launches."""
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.entry import dryrun_multichip
    from quickmer2_tpu_torch.ops.anchored import AnchoredIndex
    t_phase = time.time()
    dic = Dictionary.from_qm(fa + ".qm")
    t = time.time()
    index = AnchoredIndex.load(fa + ".qai", dic, device="cuda")
    log(f"  multi-device: .qai loaded in {time.time() - t:.1f} s")
    secs = {}
    reset_counts()
    for mode, dp, ds in (("flat", 1, 1), ("flat", 2, 2), ("anchored", 1, 1),
                         ("anchored", 2, 1), ("anchored", 2, 2)):
        out = os.path.join(WORK, f"md_{mode}_{dp}x{ds}")
        # under ds > 1 the index holds no device rows, as run_count
        # builds it: each block is placed from the host rows
        ix = (None if mode == "flat" else index if ds == 1
              else dataclasses.replace(index, rows=None))
        setup_s, count_s = count_sharded(dic, ix, sub, mode, dp, ds, out)
        secs[f"{mode} {dp}x{ds}"] = [round(setup_s, 2), round(count_s, 2)]
        with open(out + ".bin", "rb") as f, \
                open(os.path.join(WORK, f"sub_{mode}_cuda.bin"), "rb") as h:
            if f.read() != h.read():
                raise AssertionError(f"{mode} count at {dp}x{ds} on cuda:0 "
                                     "differs from the one-card .bin")
    counts = read_counts()
    log(f"  multi-device counts (set-up s, count s) on cuda:0: {secs}; "
        f"each .bin identical to the one-card count's; launches: {counts}")
    need = ("count_packed_block", "count_packed_rows", "anchor_probes",
            "anchored_block")
    if not all(counts[k] > 0 for k in need):
        raise AssertionError(f"a kernel never launched: {counts}")
    del index
    torch.cuda.empty_cache()
    t = time.time()
    script = DIST_WORKER.format(root=ROOT, rdv=os.path.join(WORK, "rdv"),
                                qm=fa + ".qm", sample=sub,
                                out=os.path.join(WORK, "dist"))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (o, e) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"distributed rank failed:\n{e[-3000:]}")
    with open(os.path.join(WORK, "dist.bin"), "rb") as f, \
            open(os.path.join(WORK, "sub_flat_cuda.bin"), "rb") as h:
        if f.read() != h.read():
            raise AssertionError("the two-process count differs from the "
                                 "one-card .bin")
    log(f"  run_count_distributed: 2 gloo processes on cuda:0 "
        f"({', '.join(o.strip() for o, _ in outs)}), rank 0's .bin "
        f"identical to the one-card count's, {time.time() - t:.1f} s")
    t = time.time()
    dry = dryrun_multichip(4, devices=["cuda:0"] * 4)
    log(f"  dryrun_multichip(4) on [cuda:0] x 4: {dry}, "
        f"{time.time() - t:.1f} s")
    log(f"phase multi-device on one card: {time.time() - t_phase:.1f} s")
    return {k: counts[k] for k in need}


def check_small_world(world, rng, dev, reset_counts, read_counts):
    """Phase 4 on the small world (`make_small_world`): its reads counted
    on the card and on the CPU in both modes (equal .bin), est; its .qai
    by the join against its anchored count's K4 .qai; the auto engine;
    resumed counts; the cohort; entry(); the multi-device layer on one
    card; long reads counted with --read-len 2048. Returns the launches
    of K5, its sort, K3 on wide rows and the multi-device kernels."""
    from quickmer2_tpu_torch.pipelines.count import run_count
    from quickmer2_tpu_torch.pipelines.est import run_est
    sfa, sub = make_small_world(world, rng)
    t = time.time()
    for mode in ("flat", "anchored"):
        bins = []
        for device in ("cuda", "cpu"):
            out = os.path.join(WORK, f"sub_{mode}_{device}")
            st = run_count(sfa + ".qm", sub, out,
                           batch_bases=1 << 22, verbose=False,
                           mode=mode, device=device)
            if (mode, device) == ("anchored", "cuda"):
                index_s = st["phases"]["index_s"]
            with open(out + ".bin", "rb") as f:
                bins.append(f.read())
        if bins[0] != bins[1]:
            raise AssertionError(f"{mode}: cuda and cpu .bin differ")
        run_est(sfa, os.path.join(WORK, f"sub_{mode}_cuda"),
                os.path.join(WORK, f"sub_{mode}_cuda.CN.bed"),
                verbose=False, device="cuda")
        log(f"phase cpu ({mode}): {SMALL_READS} reads, cuda and "
            f"cpu .bin identical ({len(bins[0])} bytes) in "
            f"{time.time() - t:.1f} s")
        t = time.time()
    # the .qai by the join against the one the anchored count's K4 built
    launches = compare_qai_builders(
        sfa, dev, reset_counts, read_counts,
        sweep=(sfa + ".qai", index_s))
    log(f"phase .qai builders: {time.time() - t:.1f} s")
    # the auto engine's count (it picks mono)
    count_engines(sfa, sub, SMALL_READS * (READ_LEN - 30 + 1),
                  reset_counts, read_counts, engines=("auto",),
                  mono="sub_flat_cuda")

    # resumed counts, the cohort, entry()
    check_resume(sfa, sub)
    check_cohort(sfa, sub)
    launches.update(check_long_reads(world, sfa, rng, reset_counts,
                                     read_counts))
    check_entry()
    # the multi-device layer on one card
    launches.update(check_multi_device(sfa, sub, reset_counts, read_counts))
    return launches


# -- phase 3: the main path ------------------------------------------------

# -- phase 3, --profile: the search and the count under torch.profiler ----

PROFILE_REGIONS = {"search": ("search.tabulate", "search.filter",
                              "search.emit"),
                   "count": ("count.stream", "count.finish")}
# the hand-written kernels each traced region must hold on the card: K1,
# K6 and the key filter in the search's edit filter; K2 in the count's
# read loop, one launch a batch: its probe pass (P > 1) or its one pass
PROFILE_KERNELS = {"search.filter": ("hamming_join_kernel",
                                     "neighbor_sum_kernel",
                                     "key_filter_kernel"),
                   "count.stream": ("count_mono_",)}
K2_LAUNCH = re.compile(r"count_mono_(probe|direct)_kernel")   # a short name
DEVICE_BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


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


def profiled_runs(runs):
    """`python -m quickmer2_tpu_torch <args> --profile DIR --json` for
    each {name: args} of `runs`, each in a process of its own (a fresh
    profiler: late in a long process one loses device events, PERF.md
    I1), one after the other, so each has the card and the host to
    itself as the unprofiled runs had. Returns {name: (wall s, the
    run's stats, the trace's events, the trace's bytes)}."""
    results = {}
    for name, args in runs.items():
        prof = os.path.join(WORK, f"prof_{name}.trace")
        t = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "quickmer2_tpu_torch", args[0],
             "--profile", prof, "--json", *args[1:]], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=600)
        wall = time.time() - t
        if proc.returncode != 0:
            raise AssertionError(
                f"{name} --profile failed:\n{proc.stdout[-3000:]}")
        stats = json.loads([ln for ln in proc.stdout.splitlines()
                            if ln.startswith("{")][-1])
        paths = [os.path.join(prof, f) for f in os.listdir(prof)
                 if f.endswith(".pt.trace.json")]
        if len(paths) != 1:
            raise AssertionError(f"{prof} holds {len(paths)} traces, not one")
        with open(paths[0]) as f:
            events = json.load(f)["traceEvents"]
        results[name] = (wall, stats, events, os.path.getsize(paths[0]))
    return results


def check_trace(label, events, regions):
    """The trace's pipeline regions (`search.*`, `count.*`): exactly
    `regions` in order, none overlapping the next; the flat counter's
    phases (`counter.*`) each inside `count.stream` or `count.finish`,
    and no other annotation; the kernels of PROFILE_KERNELS inside their
    region's device span: from the first to the last device operation
    whose launch (the runtime call of its correlation id) lies inside
    the region. (The profiler's gpu_user_annotation spans only the
    innermost range, now a counter phase.) Returns ({region:
    {"kernels": {name: n} inside its device span, "busy": the
    device-busy share of that span}}, {kernel name: n} over the whole
    trace)."""
    notes = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation")
    host = [h for h in notes if h[2].startswith(("search.", "count."))]
    phases = [h for h in notes if h[2].startswith("counter.")]
    other = sorted({h[2] for h in notes} - {h[2] for h in host + phases})
    if other:
        raise AssertionError(f"{label}: annotations {other} are neither "
                             f"pipeline regions nor counter phases")
    names = tuple(n for _, _, n in host)
    if names != regions:
        raise AssertionError(f"{label}: the trace's regions {names}, not "
                             f"{regions}")
    if any(a[1] > b[0] for a, b in zip(host, host[1:])):
        raise AssertionError(f"{label}: overlapping regions {host}")
    count = [h for h in host if h[2] in ("count.stream", "count.finish")]
    for s, t, n in phases:
        if not any(a <= s and t <= b for a, b, _ in count):
            raise AssertionError(f"{label}: {n} at {s}-{t} lies outside "
                                 f"count.stream and count.finish")
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    dev = {}
    for e in events:
        t = launched.get(e.get("args", {}).get("correlation"))
        if e.get("cat") not in DEVICE_BUSY or t is None:
            continue
        for lo, hi, name in host:
            if lo <= t <= hi:
                a, b = dev.get(name, (e["ts"], e["ts"] + e["dur"]))
                dev[name] = (min(a, e["ts"]), max(b, e["ts"] + e["dur"]))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        n = kernel_name(e["name"])
        by_name[n] = by_name.get(n, 0) + 1
    out = {}
    for _, _, name in host:
        if name not in dev:
            if name in PROFILE_KERNELS:
                raise AssertionError(f"{label}: {name} has no device span")
            out[name] = {"kernels": {}, "busy": None}
            continue
        d_lo, d_hi = dev[name]
        inside = {}
        for e in kernels:
            if d_lo <= e["ts"] and e["ts"] + e["dur"] <= d_hi:
                n = kernel_name(e["name"])
                inside[n] = inside.get(n, 0) + 1
        for want in PROFILE_KERNELS.get(name, ()):
            if not any(want in n for n in inside):
                raise AssertionError(f"{label}: no {want} inside {name}'s "
                                     f"device span: {inside}")
        out[name] = {"kernels": dict(sorted(inside.items())),
                     "device_span_ms": round((d_hi - d_lo) / 1e3, 3),
                     "busy": round(busy_share(events, d_lo, d_hi), 6)}
    return out, by_name


def check_profile(world, fq, k, unprofiled):
    """--profile on the card: `search` with the smoke's flags and
    `count` (flat, mono) on the smoke's reads, each in a process of its
    own, one after the other. Their outputs must be the unprofiled
    runs' bytes, and their traces hold the five regions in the JAX package's order with K1, K6
    and the key filter inside search.filter and K2 inside count.stream,
    as many K2 launches as the count fed batches (from the total_windows
    it prints). `unprofiled`: {"search": s, "count": s} of the main
    path's runs. Logs wall times, trace sizes, kernels by name and
    device-busy shares."""
    torch.cuda.empty_cache()
    batch = 1 << 24                   # run_count's default, as unprofiled
    runs = {
        "search": (["search", "-k", "30", "-e", "2", "-d", "100", "-w",
                    "1000", "-c", world["ctrl"], "--out-prefix",
                    os.path.join(WORK, "prof_search"), world["fa"]],
                   [(os.path.join(WORK, "prof_search") + ext,
                     world["fa"] + ext) for ext in (".qm", ".qgc", ".bed")]),
        "count": (["count", "--batch-bases", str(batch), world["fa"], fq,
                   os.path.join(WORK, "prof_count")],
                  [(os.path.join(WORK, "prof_count") + ext,
                    os.path.join(WORK, "s") + ext) for ext in (".bin", ".txt")])}
    done = profiled_runs({cmd: args for cmd, (args, _) in runs.items()})
    for cmd, (args, pairs) in runs.items():
        wall, stats, events, size = done[cmd]
        for got, want in pairs:
            with open(got, "rb") as f, open(want, "rb") as h:
                if f.read() != h.read():
                    raise AssertionError(f"{cmd} --profile: {got} differs "
                                         f"from the unprofiled {want}")
        regions, by_name = check_trace(cmd, events, PROFILE_REGIONS[cmd])
        run_s = (stats["elapsed_s"] if cmd == "count" else
                 sum(stats["phases"][p] for p in ("tabulate_s", "filter_s",
                                                  "emit_s")))
        log(f"phase profile ({cmd}): {wall:.1f} s for the process, the run "
            f"{run_s:.2f} s by its stats against {unprofiled[cmd]:.2f} s "
            f"unprofiled (in the smoke's process); outputs identical; "
            f"trace {size / 1e6:.2f} MB, "
            f"{len(events)} events; device kernels by name {by_name}")
        for name, r in regions.items():
            log(f"  {name}: {r}")
        if cmd == "count":
            per = batch - k + 1
            if stats["total_windows"] % per:
                raise AssertionError(f"total_windows {stats['total_windows']}"
                                     f" is no whole number of batches")
            fed = stats["total_windows"] // per
            k2 = sum(n for name, n in by_name.items()
                     if K2_LAUNCH.fullmatch(name))
            if k2 != fed:
                raise AssertionError(f"the trace holds {k2} K2 launches, the "
                                     f"count fed {fed} batches")
            log(f"  K2 launches in the trace {k2} = batches fed {fed} "
                f"(total_windows {stats['total_windows']} / {per})")


def median_cn(cn_bed, excl, seg):
    rows = [ln.split() for ln in open(cn_bed)]
    cn = np.array([[float(r[1]), float(r[2]), float(r[3])] for r in rows])
    in_seg = (cn[:, 0] >= seg[0]) & (cn[:, 1] <= seg[1])
    base = np.ones(len(cn), bool)
    for a, b in excl:
        base &= (cn[:, 1] < a - 1000) | (cn[:, 0] > b + 1000)
    return (float(np.median(cn[base, 2])), int(base.sum()),
            float(np.median(cn[in_seg, 2])), int(in_seg.sum()))


def cn_check(world, cn_bed, label):
    base_cn, n_base, seg_cn, n_seg = median_cn(cn_bed, world["excl"],
                                               world["seg"])
    log(f"CN ({label}): baseline median {base_cn:.4f} over {n_base} "
        f"windows, CNV segment median {seg_cn:.4f} over {n_seg} windows")
    if not abs(base_cn - 2.0) <= 0.1:
        raise AssertionError(f"{label} baseline CN {base_cn} not in 2 ± 0.1")
    if not abs(seg_cn - 6.0) <= 0.5:
        raise AssertionError(f"{label} CNV segment CN {seg_cn} not in 6 ± 0.5")


def count_phase(label, count_s, cstats, n_windows):
    """Log a count's wall and its rate: the reads' k-mer windows over
    stream + finish (the same numerator for both modes)."""
    wall = cstats["phases"]["stream_s"] + cstats["phases"]["finish_s"]
    log(f"phase {label}: {count_s:.1f} s, {n_windows} read windows, "
        f"{n_windows / wall:.0f} k-mers/s (stream + finish) "
        f"{json.dumps(cstats)}")


def main() -> int:
    check_only = "--check-only" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from quickmer2_tpu_torch.config import SearchConfig
    from quickmer2_tpu_torch.kernels import build
    from quickmer2_tpu_torch.kernels.anchored import (
        anchor_probes, anchored_count)
    from quickmer2_tpu_torch.kernels.count_flat import (
        count_linear_step, count_packed_block_step, count_packed_step,
        kmerize_step)
    from quickmer2_tpu_torch.kernels.count_mono import (
        count_mono_rows, count_mono_step, count_packed_rows)
    from quickmer2_tpu_torch.kernels.emit_member import member_scan
    from quickmer2_tpu_torch.kernels.est_windows import window_sums
    from quickmer2_tpu_torch.kernels.hamming_join import (
        bucket_layouts, bucket_runs, join_bits, join_compare)
    from quickmer2_tpu_torch.kernels.neighbor_bits import (
        key_filter, neighbor_bits)
    from quickmer2_tpu_torch.kernels.neighbor_sum import neighbor_sum
    from quickmer2_tpu_torch.pipelines.count import run_count
    from quickmer2_tpu_torch.pipelines.est import run_est
    from quickmer2_tpu_torch.pipelines.search import (
        _tabulate_streaming, run_search)
    from quickmer2_tpu_torch.io import fasta as fasta_io

    from quickmer2_tpu_torch.utils import native
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; native host parser "
        f"{'built' if native.available() else 'UNAVAILABLE'}")

    def reset_counts():
        for fn in (count_mono_step, join_compare, anchored_count,
                   count_mono_rows, neighbor_bits, key_filter, neighbor_sum,
                   join_bits, bucket_runs, count_linear_step,
                   count_packed_step,
                   kmerize_step, member_scan, window_sums,
                   count_packed_block_step, count_packed_rows, anchor_probes,
                   bucket_layouts):
            fn.launches = 0
        anchored_count.branch_launches = dict.fromkeys(
            anchored_count.branch_launches, 0)
        anchored_count.block_launches = 0
        anchored_count.wide_launches = 0

    def read_counts():
        return {"count_mono": count_mono_step.launches,
                "hamming_join": join_compare.launches,
                "anchored_tier1": anchored_count.branch_launches["neighbor"],
                "anchored_tier2": anchored_count.branch_launches["runs"],
                "anchored_point": anchored_count.branch_launches["point"],
                "count_mono_rows": count_mono_rows.launches,
                "neighbor_bits": neighbor_bits.launches,
                "key_filter": key_filter.launches,
                "neighbor_sum": neighbor_sum.launches,
                "join_bits": join_bits.launches,
                "bucket_runs": bucket_runs.launches,
                "count_linear": count_linear_step.launches,
                "count_packed": count_packed_step.launches,
                "kmerize": kmerize_step.launches,
                "member_scan": member_scan.launches,
                "window_sums": window_sums.launches,
                "count_packed_block": count_packed_block_step.launches,
                "count_packed_rows": count_packed_rows.launches,
                "anchor_probes": anchor_probes.launches,
                "anchored_block": anchored_count.block_launches,
                "anchored_wide": anchored_count.wide_launches,
                "bucket_layouts": bucket_layouts.launches}

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_all = time.time()
    try:
        # -- 1. build --------------------------------------------------
        t = time.time()
        built = build.build_all()
        log(f"phase build: {time.time() - t:.2f} s "
            + ", ".join(f"{n} {b['s']:.2f} s" for n, b in built.items()))
        for name, b in built.items():
            for line in ptxas_summary(b["log"]):
                log(f"  nvcc {name}: {line}")

        # -- inputs ------------------------------------------------------
        rng = np.random.default_rng(2024)
        t = time.time()
        world = make_world(rng)
        log(f"genome: {len(world['g'])} bases in {time.time() - t:.1f} s")

        # -- 2. kernels against their plain versions (flat path) --------
        t = time.time()
        rows = [check_count_mono(rng, 30, 11_000_000, 1 << 24, dev, True)]
        check_count_mono(rng, 32, 2_000_000, 1 << 22, dev, False)
        for k, n_keys, n_bases in K2_EDGES:
            check_count_mono(np.random.default_rng(k), k, n_keys, n_bases,
                             dev, False)
        uniq, occ, _ = _tabulate_streaming(fasta_io.iter_fasta(world["fa"]), 30)
        rows += check_hamming_join(uniq, occ, 30, 64, 32, dev, True)
        # pads 128/64 untimed, on every 4th distinct k-mer (the join plan
        # is host work that scales with the set)
        check_hamming_join(uniq[::4], occ[::4], 30, 128, 64, dev, False)
        row, table = check_neighbor_sum(uniq, occ, 30, dev)
        rows.append(row)
        for kk in (15, 32):
            check_neighbor_sum_small(kk, dev)
        check_filters(uniq, occ, table, 30, dev)
        del uniq, occ, table
        torch.cuda.empty_cache()
        est_scale = check_window_sums_scale(dev)
        log(f"phase kernels (flat path): {time.time() - t:.1f} s (tolerance: "
            f"exact equality, integer outputs)")

        g = world["g"]
        t = time.time()
        n_reads = COVERAGE * len(g) // READ_LEN
        reads = simulate_reads(rng, g, n_reads, READ_LEN, ERR)
        seg = g[world["seg"][0]:world["seg"][1]]
        extra = simulate_reads(rng, seg, 2 * COVERAGE * len(seg) // READ_LEN,
                               READ_LEN, ERR)
        fq = os.path.join(WORK, "r.fq")
        write_fastq(fq, np.concatenate([reads, extra]))
        n_windows = (n_reads + len(extra)) * (READ_LEN - 30 + 1)
        log(f"reads: {n_reads} + {len(extra)} extra over the CNV "
            f"segment, {READ_LEN} bp, {ERR} subs/bp, in "
            f"{time.time() - t:.1f} s")

        # -- 3. the flat path: search → count → est ----------------------
        reset_counts()
        sstats = {}
        t = time.time()
        run_search(world["fa"], SearchConfig(
            kmer_size=30, edit_distance=2, edit_depth_threshold=100,
            window_size=1000, control_bed=world["ctrl"]),
            verbose=False, stats=sstats, device="cuda")
        log(f"phase search: {time.time() - t:.1f} s {json.dumps(sstats)}")
        log(f"  search join_s {sstats['phases']['join_s']:.2f} s (the join "
            f"plan's host routing plan_s {sstats['filter']['plan_s']:.2f} s, "
            f"{sstats['filter']['join_calls']} join calls), slow_table_s "
            f"{sstats['phases']['slow_table_s']:.2f} s, slow_s "
            f"{sstats['phases']['slow_s']:.2f} s")
        srch = read_counts()
        log(f"launches in the search: {srch}")
        if not all(srch[k] > 0 for k in ("hamming_join", "neighbor_sum",
                                          "key_filter", "bucket_layouts")):
            raise AssertionError(f"a kernel never launched: {srch}")
        launches = {k: srch[k] for k in ("neighbor_sum", "key_filter",
                                         "bucket_layouts")}
        if not check_only:
            t = time.time()
            cstats = run_count(world["fa"] + ".qm", fq,
                               os.path.join(WORK, "s"), verbose=False,
                               device="cuda")
            count_phase("count (flat)", time.time() - t, cstats, n_windows)
            t = time.time()
            cn_bed = os.path.join(WORK, "s.CN.bed")
            estats = run_est(world["fa"], os.path.join(WORK, "s"), cn_bed,
                             verbose=False, device="cuda")
            log(f"phase est: {time.time() - t:.2f} s "
                f"{json.dumps({k: v for k, v in estats.items() if k != 'factors'})}")
            flat = read_counts()
            log(f"launches on the flat path: {flat}")
            if not (flat["count_mono"] > 0 and flat["hamming_join"] > 0):
                raise AssertionError(f"a kernel never launched: {flat}")
            cn_check(world, cn_bed, "flat")
            launches.update({k: flat[k] for k in ("count_mono",
                                                  "hamming_join")})
            # -- 3, the same search and count under --profile ------------
            check_profile(world, fq, 30, {
                "search": sum(sstats["phases"][p] for p in (
                    "tabulate_s", "filter_s", "emit_s")),
                "count": cstats["elapsed_s"]})
            # -- 3, est's device window sums, the device emit, and the
            # host subcommands, each its own path -----------------------
            sample = os.path.join(WORK, "s")
            launches["window_sums"] = est_device_sums(
                world, sample, reset_counts, read_counts)
            row = check_est_windows(world["fa"], sample, dev)
            row["scale_101M"] = est_scale
            rows.append(row)
            launches["member_scan"] = search_emit_pair(
                world, reset_counts, read_counts)
            from quickmer2_tpu_torch.dictionary import Dictionary
            check_host_subcommands(
                world, Dictionary.from_qm(world["fa"] + ".qm"), cn_bed)

        # -- 2, the flat engines: kernels against their plain versions --
        t = time.time()
        rows += check_flat_engines(world["fa"], world["g"], reads, dev)
        log(f"phase kernels (flat engines): {time.time() - t:.1f} s "
            f"(tolerance: exact equality, integer outputs)")
        if not check_only:
            # -- 3, the other flat engines' counts, each its own path ----
            launches.update(count_engines(world["fa"], fq, n_windows,
                                          reset_counts, read_counts))

        # -- 2, anchored path: kernels against their plain versions -----
        t = time.time()
        rows += check_anchored_kernels(world["fa"], world["g"], reads,
                                       dev)
        log(f"phase kernels (anchored path): {time.time() - t:.1f} s "
            f"(tolerance: exact equality, integer outputs)")
        if check_only:
            t = time.time()
            launches.update(compare_qai_builders(
                world["fa"], dev, reset_counts, read_counts))
            log(f"phase .qai builders: {time.time() - t:.1f} s")

        if not check_only:
            # -- 3. the anchored path: count --mode anchored → est -------
            qai = world["fa"] + ".qai"
            if os.path.exists(qai):
                raise AssertionError("a .qai exists before the anchored count")
            reset_counts()
            t = time.time()
            astats = run_count(world["fa"] + ".qm", fq,
                               os.path.join(WORK, "a"), verbose=False,
                               mode="anchored", device="cuda")
            count_phase("count (anchored)", time.time() - t, astats,
                        n_windows)
            n_rows = astats["n_reads"]
            log(f"  .qai build (index_s) {astats['phases']['index_s']:.2f} s; "
                f"tier-1 spills {astats['n_spilled']} of {n_rows} rows "
                f"({astats['n_spilled'] / n_rows:.4%}), exact recounts "
                f"{astats['n_spilled2']} ({astats['n_spilled2'] / n_rows:.4%})")
            t = time.time()
            cn_bed = os.path.join(WORK, "a.CN.bed")
            run_est(world["fa"], os.path.join(WORK, "a"), cn_bed,
                    verbose=False, device="cuda")
            log(f"phase est (anchored): {time.time() - t:.2f} s")
            anch = read_counts()
            log(f"launches on the anchored path: {anch}")
            need = ("anchored_tier1", "anchored_tier2", "count_mono_rows",
                    "neighbor_bits", "key_filter")
            if not all(anch[k] > 0 for k in need):
                raise AssertionError(f"a kernel never launched: {anch}")
            with open(os.path.join(WORK, "s.bin"), "rb") as f, \
                    open(os.path.join(WORK, "a.bin"), "rb") as h:
                if f.read() != h.read():
                    raise AssertionError("anchored and flat .bin files differ")
            log("anchored .bin identical to flat .bin")
            cn_check(world, cn_bed, "anchored")
            # the key filter launches in both paths: once for the search's
            # table, once for the anchored index's
            launches.update({k: anch[k] + launches.get(k, 0) for k in need})

            # -- 4. the card against the port's own CPU path, on the small
            # world ------------------------------------------------------
            launches.update(check_small_world(world, rng, dev,
                                              reset_counts, read_counts))

        for row in rows:
            row["launches"] = launches.get(row["name"], 0)
            if row["name"] in PTXAS_ROWS:
                src, match = PTXAS_ROWS[row["name"]]
                row["ptxas"] = ptxas_of(built[src]["log"], match)
        log(f"smoke total: {time.time() - t_all:.1f} s")
        # -- 5. the card ------------------------------------------------
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        print(json.dumps({"kernels": rows}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
