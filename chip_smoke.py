"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                # the full run (needs one card)
    python3 chip_smoke.py --check-only   # build + kernel checks only

Phases:
  1. build   — nvcc builds every kernel of the path (csrc/*.cu), one
               process per source, in parallel;
  2. kernels — each kernel against its plain PyTorch version on the card,
               at the main path's shapes; integer outputs, so the
               tolerance is exact equality; CUDA-event times of both;
  3. main    — search (k=30, e=2, d=100, w=1000, control bed) → count
               (flat, mono) → est on a 12 Mb realistic genome
               (tools/realistic_genome.py, S. cerevisiae scale) with
               ~20x simulated 150 bp reads; the launch counters are reset
               just before and read just after; CN is checked on the
               baseline windows (2 ± 0.1) and on a segment with 3x extra
               read depth (6 ± 0.5);
  4. cpu     — a 50 k-read subset counted with device="cuda" and with
               device="cpu" gives byte-identical .bin files;
  5. card    — name and power limit from nvidia-smi.
Prints the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises (non-zero exit). With
no CUDA card it exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")

HBM_BYTES_S = 3.35e12            # H100 SXM HBM3
# int32 ALU: 132 SMs x 64 lanes x 1.98 GHz (the data sheet's 67 TFLOP/s
# float32 is 128 lanes x 2 flops per FMA at the same clock)
INT32_OPS_S = 132 * 64 * 1.98e9

GENOME_BASES = 12_000_000
READ_LEN = 150
COVERAGE = 20
ERR = 0.003


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call of fn() over `reps` calls, by CUDA
    events after `warm` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / INT32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over u32 word tensors."""
    from quickmer2_tpu_torch.device import u32
    if a.numel() == 0:
        return 0
    return int((u32(a) - u32(b)).abs().max().item())


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
    separators and N bases; returns a kernel-table row when timed."""
    from quickmer2_tpu_torch.device import words
    from quickmer2_tpu_torch.kernels.count_mono import (
        count_mono_step, count_mono_step_plain)
    from quickmer2_tpu_torch.ops import codec, rowpack
    from quickmer2_tpu_torch.ops.monotable import MonoTable
    from quickmer2_tpu_torch.utils import native

    g = rng.integers(0, 4, n_bases).astype(np.uint8)
    canon, valid, _ = native.sliding_canon(g, k)
    hits = canon[valid & (canon != 0) & (rng.random(len(canon)) < 0.3)]
    top = (1 << (2 * k)) - 1
    rand = rng.integers(1, 1 << 62, n_keys, dtype=np.int64).astype(np.uint64)
    keys = np.unique(np.concatenate([hits, rand & np.uint64(top)]))
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

    def zero():
        return torch.zeros(table.n_slots + 1, dtype=torch.int32, device=dev)
    d_kernel, d_plain = zero(), zero()
    m_kernel = count_mono_step(pk_d, bits_d, rows, d_kernel, **kw)
    m_plain = count_mono_step_plain(pk_d, bits_d, rows, d_plain, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(d_kernel[:-1], d_plain[:-1]),
              max_abs_err(m_kernel, m_plain))
    n_unres = int(np.unpackbits(m_kernel.cpu().numpy().view(np.uint8)).sum())
    log(f"  count_mono k={k}: {len(keys)} keys, {table.n_buckets} buckets, "
        f"side {table.side.n_kmers} keys, batch {n_bases} bases: "
        f"{int(d_kernel[:-1].sum())} hits, {n_unres} unresolved lanes, "
        f"max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(f"count_mono k={k} disagrees with its plain version")
    if not timed:
        return None
    ms = cuda_ms(lambda: count_mono_step(pk_d, bits_d, rows, d_kernel, **kw), 10)
    plain_ms = cuda_ms(
        lambda: count_mono_step_plain(pk_d, bits_d, rows, d_plain, **kw), 2)
    # least traffic: packed batch in, each touched row read once, each
    # touched depth word read and written once, mask words out; least
    # work: a rolling codec (~16 int ops), canonical min, DJB over 8
    # bytes (~16), 8 entry compares (~16) per window
    n_win = n_bases - k + 1
    codes = rowpack.unpack_rows(pk_d[None], bits_d[None], read_len=n_bases)[0]
    chi, clo, ok = codec.sliding_kmers(codes, k)
    from quickmer2_tpu_torch.ops.hash import djb_pair
    bucket = djb_pair(chi[ok], clo[ok]) & (table.n_buckets - 1)
    rows_touched = int(torch.unique(bucket).numel())
    slots_touched = int((d_plain[:-1] != 0).sum())
    n_bytes = (pk.nbytes + bits.nbytes + 64 * rows_touched
               + 8 * slots_touched + 4 * m_kernel.numel())
    b_ms, b_by = bound_ms(n_bytes, 52 * n_win)
    log(f"  count_mono time {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
        f"{rows_touched} rows touched)")
    return {"name": "count_mono", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/count_mono.cu",
            "replaces": "quickmer2_tpu/pipelines/count.py:139",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def join_layouts(uniq, occ, k, cpad, cpad_q, dev):
    """Part 0, word chunk 0 and query chunk 0 of the search's own join
    plan at these pads: its queries (the singletons), its interleaved
    chunks and its slow-path routing, built by its layout scatter."""
    from quickmer2_tpu_torch.ops import hamming_join as hj
    plan = hj._JoinPlan(uniq[occ == 1], uniq, occ, k, cpad=cpad,
                        cpad_q=cpad_q, device=dev)
    qsel = plan.query_chunk(0)
    lay = plan.layouts(0, 0, plan.queries(qsel))
    return lay, len(qsel), plan.n_bkts[0]


def check_hamming_join(uniq, occ, k, cpad, cpad_q, dev, timed):
    from quickmer2_tpu_torch.kernels.hamming_join import (
        join_compare, join_compare_plain)
    from quickmer2_tpu_torch.ops.hamming_join import _part_masks
    lay, nq, n_buckets = join_layouts(uniq, occ, k, cpad, cpad_q, dev)
    kw = dict(e=2, masks=_part_masks(k), n_buckets=n_buckets, cpad=cpad,
              cpad_q=cpad_q)
    s_kernel = torch.zeros(nq + 1, dtype=torch.int32, device=dev)
    s_plain = torch.zeros_like(s_kernel)
    join_compare(*lay, s_kernel, **kw)
    join_compare_plain(*lay, s_plain, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(s_kernel[:-1], s_plain[:-1])
    live_w = (lay[2][:-1].view(n_buckets, cpad) != 0).sum(1).to(torch.int64)
    live_q = (lay[5][:-1].view(n_buckets, cpad_q) != nq).sum(1).to(torch.int64)
    pairs = int((live_w * live_q).sum())
    log(f"  hamming_join cpad {cpad}/{cpad_q}: {n_buckets} buckets, {nq} "
        f"queries, {pairs} live pairs, {int((s_kernel[:-1] != 0).sum())} "
        f"nonzero sums, max |kernel - plain| = {err}")
    if err != 0:
        raise AssertionError(
            f"hamming_join {cpad}/{cpad_q} disagrees with its plain version")
    if not timed:
        return None
    ms = cuda_ms(lambda: join_compare(*lay, s_kernel, **kw), 10)
    plain_ms = cuda_ms(lambda: join_compare_plain(*lay, s_plain, **kw), 1)
    # least traffic: occ of every word lane and qidx of every query lane
    # (they tell which lanes are live), the (hi, lo) codes of the live
    # words and live queries, each live query's sum read and written
    # once; least work: ~20 int ops per live pair
    n_live_w, n_live_q = int(live_w.sum()), int(live_q.sum())
    n_bytes = (4 * (lay[2].numel() + lay[5].numel())
               + 8 * (n_live_w + n_live_q) + 8 * n_live_q)
    b_ms, b_by = bound_ms(n_bytes, 20 * pairs)
    log(f"  hamming_join time {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
        f"{20 * pairs / 1e9:.2f} G ops; {n_live_w} live words, {n_live_q} "
        f"live queries)")
    return {"name": "hamming_join", "route": "cuda",
            "source": "quickmer2_tpu_torch/csrc/hamming_join.cu",
            "replaces": "tools/proto_join2d.py:55",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# -- phase 3: the main path ------------------------------------------------

def median_cn(cn_bed, excl, seg):
    rows = [ln.split() for ln in open(cn_bed)]
    cn = np.array([[float(r[1]), float(r[2]), float(r[3])] for r in rows])
    in_seg = (cn[:, 0] >= seg[0]) & (cn[:, 1] <= seg[1])
    base = np.ones(len(cn), bool)
    for a, b in excl:
        base &= (cn[:, 1] < a - 1000) | (cn[:, 0] > b + 1000)
    return (float(np.median(cn[base, 2])), int(base.sum()),
            float(np.median(cn[in_seg, 2])), int(in_seg.sum()))


def main() -> int:
    check_only = "--check-only" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from quickmer2_tpu_torch.config import SearchConfig
    from quickmer2_tpu_torch.kernels import build
    from quickmer2_tpu_torch.kernels.count_mono import count_mono_step
    from quickmer2_tpu_torch.kernels.hamming_join import join_compare
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
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        # -- 1. build --------------------------------------------------
        t = time.time()
        built = build.build_all()
        log(f"phase build: {time.time() - t:.2f} s "
            + ", ".join(f"{n} {b['s']:.2f} s" for n, b in built.items()))
        for name, b in built.items():
            for line in b["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

        # -- inputs ------------------------------------------------------
        rng = np.random.default_rng(2024)
        t = time.time()
        world = make_world(rng)
        log(f"genome: {len(world['g'])} bases in {time.time() - t:.1f} s")

        # -- 2. kernels against their plain versions --------------------
        t = time.time()
        rows = [check_count_mono(rng, 30, 11_000_000, 1 << 24, dev, True)]
        check_count_mono(rng, 32, 2_000_000, 1 << 22, dev, False)
        uniq, occ, _ = _tabulate_streaming(fasta_io.iter_fasta(world["fa"]), 30)
        rows.append(check_hamming_join(uniq, occ, 30, 64, 32, dev, True))
        check_hamming_join(uniq, occ, 30, 128, 64, dev, False)
        del uniq, occ
        torch.cuda.empty_cache()
        log(f"phase kernels: {time.time() - t:.1f} s (tolerance: exact "
            f"equality, integer outputs)")
        launches = {"count_mono": 0, "hamming_join": 0}

        if not check_only:
            # -- 3. main path: search → count → est ----------------------
            g = world["g"]
            t = time.time()
            n_reads = COVERAGE * len(g) // READ_LEN
            reads = simulate_reads(rng, g, n_reads, READ_LEN, ERR)
            seg = g[world["seg"][0]:world["seg"][1]]
            extra = simulate_reads(rng, seg, 2 * COVERAGE * len(seg) // READ_LEN,
                                   READ_LEN, ERR)
            fq = os.path.join(WORK, "r.fq")
            write_fastq(fq, np.concatenate([reads, extra]))
            log(f"reads: {n_reads} + {len(extra)} extra over the CNV "
                f"segment, {READ_LEN} bp, {ERR} subs/bp, in "
                f"{time.time() - t:.1f} s")

            count_mono_step.launches = 0
            join_compare.launches = 0
            sstats = {}
            t = time.time()
            run_search(world["fa"], SearchConfig(
                kmer_size=30, edit_distance=2, edit_depth_threshold=100,
                window_size=1000, control_bed=world["ctrl"]),
                verbose=False, stats=sstats, device="cuda")
            search_s = time.time() - t
            t = time.time()
            cstats = run_count(world["fa"] + ".qm", fq,
                               os.path.join(WORK, "s"), verbose=False,
                               device="cuda")
            count_s = time.time() - t
            t = time.time()
            cn_bed = os.path.join(WORK, "s.CN.bed")
            estats = run_est(world["fa"], os.path.join(WORK, "s"), cn_bed,
                             verbose=False, device="cuda")
            est_s = time.time() - t
            launches = {"count_mono": count_mono_step.launches,
                        "hamming_join": join_compare.launches}
            log(f"phase search: {search_s:.1f} s {json.dumps(sstats)}")
            windows = cstats["total_windows"]
            wall = cstats["phases"]["stream_s"] + cstats["phases"]["finish_s"]
            log(f"phase count: {count_s:.1f} s, {windows} windows, "
                f"{windows / wall:.0f} k-mers/s (stream + finish) "
                f"{json.dumps(cstats)}")
            log(f"phase est: {est_s:.2f} s "
                f"{json.dumps({k: v for k, v in estats.items() if k != 'factors'})}")
            log(f"launches on the main path: {launches}")
            base_cn, n_base, seg_cn, n_seg = median_cn(
                cn_bed, world["excl"], world["seg"])
            log(f"CN: baseline median {base_cn:.4f} over {n_base} windows, "
                f"CNV segment median {seg_cn:.4f} over {n_seg} windows")
            if not (launches["count_mono"] > 0 and launches["hamming_join"] > 0):
                raise AssertionError(f"a kernel never launched: {launches}")
            if not abs(base_cn - 2.0) <= 0.1:
                raise AssertionError(f"baseline CN {base_cn} not in 2 ± 0.1")
            if not abs(seg_cn - 6.0) <= 0.5:
                raise AssertionError(f"CNV segment CN {seg_cn} not in 6 ± 0.5")

            # -- 4. the card against the port's own CPU path --------------
            t = time.time()
            sub = os.path.join(WORK, "sub.fq")
            write_fastq(sub, reads[:50_000])
            bins = []
            for device in ("cuda", "cpu"):
                out = os.path.join(WORK, "sub_" + device)
                run_count(world["fa"] + ".qm", sub, out, batch_bases=1 << 22,
                          verbose=False, device=device)
                with open(out + ".bin", "rb") as f:
                    bins.append(f.read())
            if bins[0] != bins[1]:
                raise AssertionError("cuda and cpu .bin files differ")
            log(f"phase cpu: 50000 reads, cuda and cpu .bin identical "
                f"({len(bins[0])} bytes) in {time.time() - t:.1f} s")

        for row in rows:
            row["launches"] = launches[row["name"]]
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
