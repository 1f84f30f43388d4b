"""The flat count's other exact engines: the CUDA kernels of
csrc/count_flat.cu and their plain PyTorch versions. Each takes one
batch of `n_bases` 2-bit codes (the ops.rowpack layout, one row = the
batch), as count_mono.count_mono_step does.

`count_linear_step` (K7) replaces quickmer2_tpu/pipelines/count.py::
count_step: the reference's linear probe (ops.hash.probe_lookup) over
the .qm table, the slot → rank gather, and depth[rank] += 1 into a
rank-space depth u32[n_kmers + 1] whose last lane (the trash lane) takes
the invalid windows and the misses. The table is a word tensor [H, 2] of
(hi, lo) a slot (`linear_table`), so a probe step is one 8-B load.

`count_packed_step` (K8) replaces count_step_packed_pk: the two-choice
packed-table probe (ops.packed_table), depth[rank] += 1 on a hit, the
trash lane otherwise.

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

from quickmer2_tpu_torch.device import store, u32, words
from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.ops import codec, packed_table, rowpack
from quickmer2_tpu_torch.ops.hash import MAX_STEPS, probe_lookup, slot_at

_ARGTYPES = {
    "qm2t_count_linear": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "qm2t_count_packed": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p],
    "qm2t_kmerize": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}


def linear_table(dictionary, device: torch.device):
    """(table, rank) word tensors of a dictionary on `device`: the .qm
    table as (hi, lo) pairs [H, 2] and the slot → rank map [H]."""
    hi, lo, rank = dictionary.device_arrays()
    return (words(np.stack([hi, lo], axis=1), device),
            words(rank.view(np.uint32), device))


def _windows(pk, bits, k: int, n_bases: int):
    codes = rowpack.unpack_rows(pk[None], bits[None], read_len=n_bases)[0]
    return codec.sliding_kmers(codes, k)


def _add(depth: torch.Tensor, lanes: torch.Tensor) -> None:
    depth.index_add_(0, lanes, torch.ones(lanes.shape, dtype=depth.dtype,
                                          device=depth.device))


def _check_batch(what, pk, bits, k, n_bases, specs):
    build.check_tensors(what, pk.device, [
        ("pk", pk, torch.uint8, (-(-n_bases // 4),)),
        ("bits", bits, torch.uint8, (-(-n_bases // 8),)), *specs])
    if not 1 <= k <= 32 or n_bases < k:
        raise ValueError(f"{what}: bad k={k} for {n_bases} bases")
    if (pk.data_ptr() | bits.data_ptr()) & 7:
        raise ValueError(f"{what}: pk and bits must be 8-byte aligned")


def _launch(fn: str, what: str, device: torch.device, *args) -> None:
    lib = build.load("count_flat", _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    build.check(lib, rc, what)


# -- K7: the linear probe -------------------------------------------------

def count_linear_step_plain(pk, bits, table, rank, depth, *, k: int,
                            hash_size: int, n_bases: int,
                            max_steps: int = MAX_STEPS) -> None:
    """Plain PyTorch version: unpack, kmerize, probe, gather, add."""
    chi, clo, valid = _windows(pk, bits, k, n_bases)
    idx, _ = probe_lookup(u32(table[:, 0]), u32(table[:, 1]), chi, clo,
                          hash_size, max_steps)
    trash = depth.shape[0] - 1
    r = u32(rank[slot_at(idx, hash_size)])
    _add(depth, torch.where(valid, r, trash))


def count_linear_step(pk: torch.Tensor, bits: torch.Tensor,
                      table: torch.Tensor, rank: torch.Tensor,
                      depth: torch.Tensor, *, k: int, hash_size: int,
                      n_bases: int, max_steps: int = MAX_STEPS) -> None:
    """One batch into the rank-space `depth` (updated in place)."""
    if pk.device.type == "cpu":
        count_linear_step_plain(pk, bits, table, rank, depth, k=k,
                                hash_size=hash_size, n_bases=n_bases,
                                max_steps=max_steps)
        return
    _check_batch("count_linear_step", pk, bits, k, n_bases, [
        ("table", table, torch.int32, (hash_size, 2)),
        ("rank", rank, torch.int32, (hash_size,)),
        ("depth", depth, torch.int32, (depth.shape[0],))])
    if hash_size < 2 or hash_size > 1 << 31 or hash_size & (hash_size - 1):
        raise ValueError(f"count_linear_step: bad hash_size {hash_size}")
    _launch("qm2t_count_linear", "count_linear", pk.device, pk.data_ptr(),
            bits.data_ptr(), table.data_ptr(), rank.data_ptr(),
            depth.data_ptr(), n_bases, k, hash_size, depth.shape[0] - 1,
            max_steps)
    count_linear_step.launches += 1


count_linear_step.launches = 0


# -- K8: the two-choice packed table ---------------------------------------

def count_packed_step_plain(pk, bits, rows, depth, *, k: int, n_buckets: int,
                            n_bases: int) -> None:
    """Plain PyTorch version: unpack, kmerize, probe both buckets, add."""
    chi, clo, valid = _windows(pk, bits, k, n_bases)
    trash = depth.shape[0] - 1
    found, rank, _ = packed_table.probe_packed(rows, chi, clo, n_buckets,
                                               trash)
    _add(depth, torch.where(valid & found, rank, trash))


def count_packed_step(pk: torch.Tensor, bits: torch.Tensor,
                      rows: torch.Tensor, depth: torch.Tensor, *, k: int,
                      n_buckets: int, n_bases: int) -> None:
    """One batch into the rank-space `depth` (updated in place)."""
    if pk.device.type == "cpu":
        count_packed_step_plain(pk, bits, rows, depth, k=k,
                                n_buckets=n_buckets, n_bases=n_bases)
        return
    _check_batch("count_packed_step", pk, bits, k, n_bases, [
        ("rows", rows, torch.int32, (n_buckets, packed_table.ROW_WIDTH)),
        ("depth", depth, torch.int32, (depth.shape[0],))])
    if n_buckets < 1 or n_buckets > 1 << 32 or n_buckets & (n_buckets - 1):
        raise ValueError(f"count_packed_step: bad n_buckets {n_buckets}")
    _launch("qm2t_count_packed", "count_packed", pk.device, pk.data_ptr(),
            bits.data_ptr(), rows.data_ptr(), depth.data_ptr(), n_bases, k,
            n_buckets, depth.shape[0] - 1)
    count_packed_step.launches += 1


count_packed_step.launches = 0


# -- K9: the sort-join engine's codec --------------------------------------

def kmerize_step_plain(pk, bits, *, k: int, n_bases: int):
    """Plain PyTorch version: unpack, kmerize, zero the invalid keys."""
    chi, clo, valid = _windows(pk, bits, k, n_bases)
    dtype = torch.int64 if pk.device.type == "cpu" else torch.int32
    return (store(torch.where(valid, chi, 0), dtype),
            store(torch.where(valid, clo, 0), dtype), valid)


def kmerize_step(pk: torch.Tensor, bits: torch.Tensor, *, k: int,
                 n_bases: int):
    """(chi, clo, valid) of the batch's n_bases - k + 1 windows: word
    tensors and bool; invalid windows carry key (0, 0)."""
    if pk.device.type == "cpu":
        return kmerize_step_plain(pk, bits, k=k, n_bases=n_bases)
    _check_batch("kmerize_step", pk, bits, k, n_bases, [])
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
