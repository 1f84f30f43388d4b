"""Multi-process count over torch.distributed, the port of
quickmer2_tpu/parallel/distributed.py.

Every process streams a disjoint, record-aligned byte shard of the
sample through the one-process StreamCounter (on its own device, or
sharded over its own devices), and the per-process depth vectors merge
by one chunked all-reduce at the end; process 0 writes the artifacts.

    from quickmer2_tpu_torch.parallel import distributed as dist
    dist.initialize("tcp://host:port", n, rank, backend="nccl")
    stats = dist.run_count_distributed("ref.fa.qm", "reads.fq", "out")

Each record is counted by exactly one process (shard boundaries snap to
record starts) and the merge is an integer sum, so the result is the
one-process result bit for bit at any process count. NCCL needs one card
a process; two processes on one card take backend="gloo".
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist

from quickmer2_tpu_torch.device import resolve_device


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device: str | torch.device = "cuda") -> None:
    """torch.distributed bootstrap. coordinator: an init_method URL
    ("tcp://host:port", "file:///path"); with no arguments the env://
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). backend:
    "nccl" or "gloo", as given; by default "nccl" for a CUDA device and
    "gloo" for the CPU. Under NCCL each process takes the card of its
    rank (modulo the cards of the box)."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator is None and num_processes is None:
        tdist.init_process_group(backend)
    else:
        tdist.init_process_group(backend, init_method=coordinator,
                                 world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(tdist.get_rank() % torch.cuda.device_count())


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def _snap_to_record(f, pos: int, is_fastq: bool) -> int:
    """Advance pos to the next record start at or after pos.

    FASTA: next line starting with '>'. FASTQ: next '@' header line that
    is a record start, told from an '@' quality line by the line two
    ahead starting with '+'."""
    if pos == 0:
        return 0
    f.seek(max(pos - 1, 0))
    f.readline()  # finish any partial line
    while True:
        line_start = f.tell()
        line = f.readline()
        if not line:
            return line_start
        if not is_fastq:
            if line.startswith(b">"):
                return line_start
        elif line.startswith(b"@"):
            mark = f.tell()
            f.readline()                  # sequence
            plus = f.readline()
            f.seek(mark)
            if plus.startswith(b"+"):
                return line_start


def byte_shard(path: str, process_id: int | None = None,
               num_processes: int | None = None):
    """This process's (offset, length) byte range of the sample file,
    snapped to record boundaries so each read belongs to exactly one
    process."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        is_fastq = f.read(1) == b"@"
        raw_lo = size * pid // n
        raw_hi = size * (pid + 1) // n
        lo = _snap_to_record(f, raw_lo, is_fastq)
        hi = _snap_to_record(f, raw_hi, is_fastq) if raw_hi < size else size
    return lo, max(hi - lo, 0)


def read_shard(path: str, offset: int, length: int,
               chunk_bytes: int = 1 << 24):
    """Yield chunks of the byte range."""
    with open(path, "rb") as f:
        f.seek(offset)
        remaining = length
        while remaining > 0:
            data = f.read(min(chunk_bytes, remaining))
            if not data:
                break
            remaining -= len(data)
            yield data


def allreduce_depth(local_depth: np.ndarray,
                    chunk: int = 1 << 24) -> np.ndarray:
    """Sum the processes' depth vectors (u32, wrapping) by all_reduce(SUM)
    in chunks of `chunk` words, so each process ships O(n) bytes in all
    and holds one chunk at a time; the identity for one process. The
    chunks ride as int64 on the CPU under gloo and on the process's card
    under NCCL."""
    local_depth = np.asarray(local_depth)
    if process_count() == 1:
        return local_depth
    dev = (torch.device("cuda", torch.cuda.current_device())
           if tdist.get_backend() == "nccl" else torch.device("cpu"))
    out = np.empty(len(local_depth), np.uint32)
    for off in range(0, len(local_depth), chunk):
        seg = torch.from_numpy(local_depth[off: off + chunk].astype(np.int64))
        seg = seg.to(dev)
        tdist.all_reduce(seg, op=tdist.ReduceOp.SUM)
        out[off: off + len(seg)] = (seg.cpu().numpy() & 0xFFFFFFFF)
    return out


def run_count_distributed(qm_path: str, sample_path: str, out_prefix: str,
                          batch_bases: int = 1 << 24, fmt: str | None = None,
                          verbose: bool = True, mode: str = "flat",
                          ref_fasta: str | None = None,
                          read_len: int | None = None,
                          data_devices: int | None = None,
                          dict_devices: int | None = None,
                          checkpoint_path: str | None = None,
                          checkpoint_every_bytes: int = 1 << 30,
                          chunk_bytes: int = 1 << 24,
                          device: str | torch.device = "cuda") -> dict:
    """Data-parallel count across processes: each counts its
    record-aligned byte shard through the port's StreamCounter on
    `device` (mode="anchored" loads or builds the shared .qai; builds
    that race end in an atomic rename), data_devices / dict_devices
    shard it further over the process's own devices, the partials merge
    with one chunked all-reduce, and process 0 writes <out_prefix>.bin
    (and .txt when the .qgc exists).

    checkpoint_path: each process writes <checkpoint_path>.p<rank> every
    checkpoint_every_bytes of its shard (shard offset and StreamCounter
    snapshot, the JAX package's format); a killed process resumes from
    its own file, which must name the same shard, and the others' work
    is not repeated. The files go when the count succeeds."""
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.io import formats
    from quickmer2_tpu_torch.pipelines.count import (
        StreamCounter, _companion, gc_curve_from_depth, make_packer)
    from quickmer2_tpu_torch.utils import checkpoint

    dev = resolve_device(device)
    rank = process_index()
    dictionary = Dictionary.from_qm(qm_path)
    index = None
    if mode == "anchored":
        from quickmer2_tpu_torch.ops.anchored import AnchoredIndex
        if ref_fasta is None:
            ref_fasta = _companion(qm_path, "")
        index = AnchoredIndex.from_dictionary_and_fasta(
            dictionary, ref_fasta, cache_path=ref_fasta + ".qai",
            place_rows=(dict_devices or 1) == 1, device=dev)
    sc = StreamCounter(dictionary, mode=mode, index=index,
                       batch_bases=batch_bases, read_len=read_len,
                       data_devices=data_devices, dict_devices=dict_devices,
                       device=dev)
    lo, length = byte_shard(sample_path)
    with open(sample_path, "rb") as f:
        is_fastq = f.read(1) == b"@"
    fmt = fmt or ("fastq" if is_fastq else "fasta-lines")
    packer = make_packer(fmt)

    my_ckpt = f"{checkpoint_path}.p{rank}" if checkpoint_path else None
    consumed = 0          # bytes of this shard already counted
    next_ckpt = checkpoint_every_bytes
    resumed = checkpoint.load(my_ckpt) if my_ckpt else None
    if resumed is not None:
        consumed, arrays, meta = resumed
        if meta.get("shard") != [lo, length]:
            raise ValueError(
                f"{my_ckpt}: checkpoint shard {meta.get('shard')} != "
                f"current shard {[lo, length]}; resume with the same "
                f"process count and sample file")
        packer.set_state(meta["packer"])
        sc.restore(arrays, meta["state"])
        next_ckpt = consumed + checkpoint_every_bytes
        if verbose:
            print(f"count[p{rank}]: resumed at shard byte {consumed}")
    for chunk in read_shard(sample_path, lo + consumed,
                            max(length - consumed, 0), chunk_bytes):
        sc.feed_codes(packer.feed(chunk))
        consumed += len(chunk)
        if my_ckpt and consumed >= next_ckpt:
            arrays, state_meta = sc.snapshot()
            checkpoint.save(my_ckpt, consumed, arrays,
                            meta={"fmt": fmt, "packer": packer.get_state(),
                                  "state": state_meta, "shard": [lo, length]})
            next_ckpt += checkpoint_every_bytes
    depth = allreduce_depth(sc.finish())
    if my_ckpt and os.path.exists(my_ckpt):
        os.remove(my_ckpt)

    stats = {"n_kmers": dictionary.n_kmers, "process": rank,
             "shard": (lo, length), **sc.stats}
    if rank == 0:
        depth_u16 = (depth & 0xFFFF).astype(np.uint16)
        formats.write_u16(out_prefix + ".bin", depth_u16)
        qgc_path = _companion(qm_path, ".qgc")
        if os.path.exists(qgc_path):
            qgc = formats.read_u16(qgc_path)[: dictionary.n_kmers]
            mean, count, var, mean_depth = gc_curve_from_depth(depth_u16, qgc)
            formats.write_gc_curve(out_prefix + ".txt", mean, count, var)
            stats["mean_depth"] = mean_depth
            if verbose:
                print("Mean sequencing depth: %.2f" % mean_depth)
    return stats
