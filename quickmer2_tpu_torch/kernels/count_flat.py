"""The flat count's other exact engines: the CUDA kernels of
csrc/count_flat.cu and their plain PyTorch versions. Each takes one
batch of `n_bases` 2-bit codes (the ops.rowpack layout, one row = the
batch), as count_mono.count_mono_step does.

`count_linear_step` (K7) replaces quickmer2_tpu/pipelines/count.py::
count_step: the reference's linear probe (ops.hash.probe_lookup) over
the .qm table and a depth add where the scan stops. The table is a word
tensor [H, 2] of (hi, lo) a slot (`linear_table`), so a probe step is
one 8-B load.

`count_packed_step` (K8) replaces count_step_packed_pk: the two-choice
packed-table probe (ops.packed_table) and a depth add at the matching
entry.

Both count in slot space, as K2 does: depth u32[S + 1] over the
table's S slots (K7: the H slots of the .qm table; K8: slot 2 * bucket
+ entry of the packed table's B buckets, S = 2B), its last lane a trash
counter of the invalid windows, the misses and K7's stops on an empty
slot. `slot_depth_to_rank` maps it to the JAX counter's rank-space
depth u32[n_kmers + 1] (trash lane last) through the slot of each rank
(`linear_rank_slots`, `packed_rank_slots`), and `rank_depth_to_slot`
maps a rank-space depth back, so snapshots are the JAX package's. The
translation is plain torch (a gather in rank order and two sums), new
glue and no TPU kernel's port. On the
card a table larger than L2 is probed slice by slice
(`linear_partitions_for`, `packed_partitions_for`), through a scratch
buffer cached per device and size.

`count_packed_block_step` (K8b) replaces quickmer2_tpu/parallel/
count_parallel.py::make_sharded_count_step's local step: K8 against one
bucket block [blk_lo, blk_lo + block_buckets) of a dict-sharded packed
table, in the block's slot space u32[2 * block_buckets + 1] (trash last:
every window the block does not count). `block_slot_depth_to_rank` maps
it to the JAX step's rank-space partial u32[n_kmers + 1] through the
block's live entries (`packed_block_entries`).

`kmerize_step` (K9) replaces _kmerize_step_pk, the sort-join engine's
codec: (chi, clo, valid) of every window, invalid windows as key 0
(ops.sortjoin's contract).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises. Each wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quickmer2_tpu_torch.device import U32, store, u32, words
from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.kernels.count_mono import (
    MAX_PARTS, slice_count, workspace)
from quickmer2_tpu_torch.ops import codec, packed_table, rowpack
from quickmer2_tpu_torch.ops.hash import MAX_STEPS, probe_lookup, slot_at

_ARGTYPES = {
    "qm2t_count_linear": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "qm2t_count_packed": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p],
    "qm2t_count_packed_block": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "qm2t_kmerize": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}


def linear_partitions_for(hash_size: int) -> int:
    """K7's slice count P: a table pair and a depth word are 12 B a
    slot."""
    return slice_count(hash_size, 12)


def packed_partitions_for(n_buckets: int) -> int:
    """K8's slice count P: a row and two depth words are 40 B a
    bucket."""
    return slice_count(n_buckets, 4 * packed_table.ROW_WIDTH + 8)


def linear_table(dictionary, device: torch.device) -> torch.Tensor:
    """The .qm table of a dictionary as a word tensor of (hi, lo) pairs
    [H, 2] on `device`."""
    hi, lo, _ = dictionary.device_arrays()
    return words(np.stack([hi, lo], axis=1), device)


def linear_rank_slots(dictionary, device: torch.device) -> torch.Tensor:
    """K7's slot of each rank: the .qm chain, int64 [n_kmers]."""
    return torch.from_numpy(np.asarray(dictionary.chain_slots,
                                       np.int64)).to(device)


def packed_rank_slots(rows: torch.Tensor, n_kmers: int) -> torch.Tensor:
    """K8's slot (2 * bucket + entry) of each rank, int64 [n_kmers]: the
    live entries' rank fields, which must name each rank once."""
    e = rows.reshape(-1, 4)
    slots = torch.nonzero((e[:, 0] | e[:, 1]) != 0).flatten()
    ranks = e[:, 2].index_select(0, slots).long()
    if len(slots) != n_kmers:
        raise ValueError(f"packed table holds {len(slots)} keys, "
                         f"{n_kmers} expected")
    out = torch.full((n_kmers,), -1, dtype=torch.int64, device=rows.device)
    out.index_copy_(0, ranks, slots)
    return out


def slot_depth_to_rank(depth: torch.Tensor, rank_slots: torch.Tensor,
                       n_kmers: int) -> torch.Tensor:
    """Rank-space depth u32[n_kmers + 1] of a slot-space depth (same word
    dtype and device): lane r takes the depth of slot rank_slots[r], and
    the trash lane the rest, the trash counter included (every lane's sum
    less the k-mers', mod 2^32). The result is the JAX counter's bit for
    bit."""
    out = torch.empty(n_kmers + 1, dtype=depth.dtype, device=depth.device)
    torch.index_select(depth, 0, rank_slots, out=out[:n_kmers])
    out[n_kmers] = (depth.sum(dtype=depth.dtype)
                    - out[:n_kmers].sum(dtype=depth.dtype))
    return out & U32 if out.dtype == torch.int64 else out


def rank_depth_to_slot(depth: torch.Tensor, rank_slots: torch.Tensor,
                       n_lanes: int) -> torch.Tensor:
    """The slot-space depth u32[n_lanes] of a rank-space one: slot
    rank_slots[r] takes depth[r], the trash counter (the last lane) the
    trash lane, every other slot 0; slot_depth_to_rank gives the
    rank-space depth back."""
    out = torch.zeros(n_lanes, dtype=depth.dtype, device=depth.device)
    out.index_copy_(0, rank_slots, depth[:-1])
    out[-1] = depth[-1]
    return out


def batch_windows(pk, bits, k: int, n_bases: int):
    """(chi, clo, valid) of a batch's windows by the plain codec."""
    codes = rowpack.unpack_rows(pk[None], bits[None], read_len=n_bases)[0]
    return codec.sliding_kmers(codes, k)


def _add(depth: torch.Tensor, lanes: torch.Tensor) -> None:
    depth.index_add_(0, lanes, torch.ones(lanes.shape, dtype=depth.dtype,
                                          device=depth.device))


def check_batch(what, pk, bits, k, n_bases, specs):
    """Raise unless pk and bits hold a batch of n_bases codes on one device
    (8-B aligned) that the kernels take at this k, and `specs` hold
    (build.check_tensors)."""
    build.check_tensors(what, pk.device, [
        ("pk", pk, torch.uint8, (-(-n_bases // 4),)),
        ("bits", bits, torch.uint8, (-(-n_bases // 8),)), *specs])
    if not 1 <= k <= 32 or n_bases < k:
        raise ValueError(f"{what}: bad k={k} for {n_bases} bases")
    if (pk.data_ptr() | bits.data_ptr()) & 7:
        raise ValueError(f"{what}: pk and bits must be 8-byte aligned")


def _check_parts(what, n_parts, n_units):
    if (not 1 <= n_parts <= min(MAX_PARTS, n_units)
            or n_parts & (n_parts - 1)):
        raise ValueError(f"{what}: bad slice count {n_parts} for "
                         f"{n_units} table units")


def _launch(fn: str, what: str, device: torch.device, *args) -> None:
    lib = build.load("count_flat", _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    build.check(lib, rc, what)


# -- K7: the linear probe -------------------------------------------------

def count_linear_step_plain(pk, bits, table, depth, *, k: int,
                            hash_size: int, n_bases: int,
                            max_steps: int = MAX_STEPS) -> None:
    """Plain PyTorch version: unpack, kmerize, probe, add at the stop
    slot (the trash counter for an invalid window or an empty slot)."""
    chi, clo, valid = batch_windows(pk, bits, k, n_bases)
    thi, tlo = u32(table[:, 0]), u32(table[:, 1])
    idx, _ = probe_lookup(thi, tlo, chi, clo, hash_size, max_steps)
    s = slot_at(idx, hash_size)
    live = valid & ((thi[s] | tlo[s]) != 0)
    _add(depth, torch.where(live, s, hash_size))


def count_linear_step(pk: torch.Tensor, bits: torch.Tensor,
                      table: torch.Tensor, depth: torch.Tensor, *, k: int,
                      hash_size: int, n_bases: int,
                      max_steps: int = MAX_STEPS) -> None:
    """One batch into the slot-space `depth` u32[hash_size + 1] (updated
    in place)."""
    if pk.device.type == "cpu":
        count_linear_step_plain(pk, bits, table, depth, k=k,
                                hash_size=hash_size, n_bases=n_bases,
                                max_steps=max_steps)
        return
    count_linear_launch(pk, bits, table, depth, k=k, hash_size=hash_size,
                        n_bases=n_bases, max_steps=max_steps,
                        n_parts=linear_partitions_for(hash_size))
    count_linear_step.launches += 1


def count_linear_launch(pk, bits, table, depth, *, k: int, hash_size: int,
                        n_bases: int, n_parts: int,
                        max_steps: int = MAX_STEPS) -> None:
    """K7 on CUDA tensors at P = n_parts slices (1: the one-pass kernel);
    count_linear_step's launch, which it alone counts."""
    check_batch("count_linear_step", pk, bits, k, n_bases, [
        ("table", table, torch.int32, (hash_size, 2)),
        ("depth", depth, torch.int32, (hash_size + 1,))])
    if hash_size < 2 or hash_size > 1 << 31 or hash_size & (hash_size - 1):
        raise ValueError(f"count_linear_step: bad hash_size {hash_size}")
    _check_parts("count_linear_step", n_parts, hash_size)
    n = n_bases - k + 1
    work = workspace(pk.device, n) if n_parts > 1 else None
    _launch("qm2t_count_linear", "count_linear", pk.device, pk.data_ptr(),
            bits.data_ptr(), table.data_ptr(), depth.data_ptr(), n_bases, k,
            hash_size, max_steps, n_parts,
            None if work is None else work.data_ptr())


count_linear_step.launches = 0


# -- K8: the two-choice packed table ---------------------------------------

def count_packed_step_plain(pk, bits, rows, depth, *, k: int, n_buckets: int,
                            n_bases: int) -> None:
    """Plain PyTorch version: the whole table as the one block of
    count_packed_block_step_plain, whose slot space is then K8's."""
    count_packed_block_step_plain(pk, bits, rows, depth, k=k,
                                  n_buckets=n_buckets, blk_lo=0,
                                  block_buckets=n_buckets, n_bases=n_bases)


def count_packed_step(pk: torch.Tensor, bits: torch.Tensor,
                      rows: torch.Tensor, depth: torch.Tensor, *, k: int,
                      n_buckets: int, n_bases: int) -> None:
    """One batch into the slot-space `depth` u32[2 * n_buckets + 1]
    (updated in place)."""
    if pk.device.type == "cpu":
        count_packed_step_plain(pk, bits, rows, depth, k=k,
                                n_buckets=n_buckets, n_bases=n_bases)
        return
    count_packed_launch(pk, bits, rows, depth, k=k, n_buckets=n_buckets,
                        n_bases=n_bases,
                        n_parts=packed_partitions_for(n_buckets))
    count_packed_step.launches += 1


def count_packed_launch(pk, bits, rows, depth, *, k: int, n_buckets: int,
                        n_bases: int, n_parts: int) -> None:
    """K8 on CUDA tensors at P = n_parts slices (1: the one-pass kernel);
    count_packed_step's launch, which it alone counts."""
    check_batch("count_packed_step", pk, bits, k, n_bases, [
        ("rows", rows, torch.int32, (n_buckets, packed_table.ROW_WIDTH)),
        ("depth", depth, torch.int32, (2 * n_buckets + 1,))])
    if n_buckets < 1 or n_buckets > 1 << 32 or n_buckets & (n_buckets - 1):
        raise ValueError(f"count_packed_step: bad n_buckets {n_buckets}")
    _check_parts("count_packed_step", n_parts, n_buckets)
    n = n_bases - k + 1
    work = workspace(pk.device, n) if n_parts > 1 else None
    _launch("qm2t_count_packed", "count_packed", pk.device, pk.data_ptr(),
            bits.data_ptr(), rows.data_ptr(), depth.data_ptr(), n_bases, k,
            n_buckets, n_parts, None if work is None else work.data_ptr())


count_packed_step.launches = 0


# -- K8b: one bucket block of the packed table ----------------------------

def packed_block_entries(rows: torch.Tensor):
    """(rank, slot) of every live entry of a block's rows [Bb, 8], int64:
    its rank field and its slot 2 * local bucket + entry."""
    e = rows.reshape(-1, 4)
    slots = torch.nonzero((e[:, 0] | e[:, 1]) != 0).flatten()
    return e[:, 2].index_select(0, slots).long() & U32, slots


def block_slot_depth_to_rank(depth: torch.Tensor, entries,
                             n_kmers: int) -> torch.Tensor:
    """Rank-space partial u32[n_kmers + 1] of a block's slot-space depth
    (same word dtype and device): the ranks of the block's entries take
    their slots' depth, every other rank 0, and the trash lane the rest
    (every lane's sum less the k-mers', mod 2^32): the JAX sharded step's
    partial, bit for bit."""
    ranks, slots = entries
    out = torch.zeros(n_kmers + 1, dtype=depth.dtype, device=depth.device)
    out.index_copy_(0, ranks, depth.index_select(0, slots))
    out[n_kmers] = (depth.sum(dtype=depth.dtype)
                    - out[:n_kmers].sum(dtype=depth.dtype))
    return out & U32 if out.dtype == torch.int64 else out


def count_packed_block_step_plain(pk, bits, rows, depth, *, k: int,
                                  n_buckets: int, blk_lo: int,
                                  block_buckets: int, n_bases: int) -> None:
    """Plain PyTorch version: unpack, kmerize, probe the block's
    candidates, add at the matching local slot (the trash for an invalid
    window, a miss or a key of another block)."""
    from quickmer2_tpu_torch.ops.hash import djb_pair
    chi, clo, valid = batch_windows(pk, bits, k, n_bases)
    trash = 2 * block_buckets
    slot = torch.full(chi.shape, trash, dtype=torch.int64, device=chi.device)
    ok = valid & ((chi | clo) != 0)
    for b in packed_table.bucket_hashes_t(djb_pair(chi, clo), n_buckets):
        off = (b - blk_lo) & U32
        local = off < block_buckets
        r = u32(rows[torch.where(local, off, 0)])
        for e in range(packed_table.ENTRIES_PER_BUCKET):
            m = (ok & local & (r[:, 4 * e] == chi)
                 & (r[:, 4 * e + 1] == clo))
            slot = torch.where(m, 2 * off + e, slot)
    _add(depth, slot)


def count_packed_block_step(pk: torch.Tensor, bits: torch.Tensor,
                            rows: torch.Tensor, depth: torch.Tensor, *,
                            k: int, n_buckets: int, blk_lo: int,
                            block_buckets: int, n_bases: int) -> None:
    """One batch into the block's slot-space `depth` u32[2 *
    block_buckets + 1] (updated in place); rows: the block's [Bb, 8]."""
    if pk.device.type == "cpu":
        count_packed_block_step_plain(
            pk, bits, rows, depth, k=k, n_buckets=n_buckets, blk_lo=blk_lo,
            block_buckets=block_buckets, n_bases=n_bases)
        return
    count_packed_block_launch(
        pk, bits, rows, depth, k=k, n_buckets=n_buckets, blk_lo=blk_lo,
        block_buckets=block_buckets, n_bases=n_bases,
        n_parts=packed_partitions_for(block_buckets))
    count_packed_block_step.launches += 1


def count_packed_block_launch(pk, bits, rows, depth, *, k: int,
                              n_buckets: int, blk_lo: int,
                              block_buckets: int, n_bases: int,
                              n_parts: int) -> None:
    """K8b on CUDA tensors at P = n_parts slices of the block's buckets;
    count_packed_block_step's launch, which it alone counts."""
    check_batch("count_packed_block_step", pk, bits, k, n_bases, [
        ("rows", rows, torch.int32, (block_buckets, packed_table.ROW_WIDTH)),
        ("depth", depth, torch.int32, (2 * block_buckets + 1,))])
    if (n_buckets < 1 or n_buckets > 1 << 32 or n_buckets & (n_buckets - 1)
            or block_buckets < 1 or n_buckets % block_buckets
            or blk_lo % block_buckets or blk_lo + block_buckets > n_buckets):
        raise ValueError(f"count_packed_block_step: bad block [{blk_lo}, "
                         f"{blk_lo} + {block_buckets}) of {n_buckets}")
    _check_parts("count_packed_block_step", n_parts, block_buckets)
    n = n_bases - k + 1
    work = workspace(pk.device, n) if n_parts > 1 else None
    _launch("qm2t_count_packed_block", "count_packed_block", pk.device,
            pk.data_ptr(), bits.data_ptr(), rows.data_ptr(),
            depth.data_ptr(), n_bases, k, n_buckets, blk_lo, block_buckets,
            n_parts, None if work is None else work.data_ptr())


count_packed_block_step.launches = 0


# -- K9: the sort-join engine's codec --------------------------------------

def kmerize_step_plain(pk, bits, *, k: int, n_bases: int):
    """Plain PyTorch version: unpack, kmerize, zero the invalid keys."""
    chi, clo, valid = batch_windows(pk, bits, k, n_bases)
    dtype = torch.int64 if pk.device.type == "cpu" else torch.int32
    return (store(torch.where(valid, chi, 0), dtype),
            store(torch.where(valid, clo, 0), dtype), valid)


def kmerize_step(pk: torch.Tensor, bits: torch.Tensor, *, k: int,
                 n_bases: int):
    """(chi, clo, valid) of the batch's n_bases - k + 1 windows: word
    tensors and bool; invalid windows carry key (0, 0)."""
    if pk.device.type == "cpu":
        return kmerize_step_plain(pk, bits, k=k, n_bases=n_bases)
    check_batch("kmerize_step", pk, bits, k, n_bases, [])
    n = n_bases - k + 1
    chi = torch.empty(n, dtype=torch.int32, device=pk.device)
    clo = torch.empty(n, dtype=torch.int32, device=pk.device)
    valid = torch.empty(n, dtype=torch.bool, device=pk.device)
    _launch("qm2t_kmerize", "kmerize", pk.device, pk.data_ptr(),
            bits.data_ptr(), chi.data_ptr(), clo.data_ptr(), valid.data_ptr(),
            n_bases, k)
    kmerize_step.launches += 1
    return chi, clo, valid


kmerize_step.launches = 0
