"""Entry point of the port: one step of the flagship count, with its
arguments.

entry() is the PyTorch analog of __graft_entry__.entry: the same toy
genome, dictionary and read codes (made here from numpy), and the
count's step through the reference's linear probe (kernel K7,
kernels.count_flat.count_linear_step) on the card, its slot-space depth
translated to rank order. `fn(*args)` adds the reads' k-mers to the
depth vector args[-1] and returns it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from quickmer2_tpu_torch.device import resolve_device, store, u32, word_dtype
from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.kernels.count_flat import (
    count_linear_step, linear_rank_slots, linear_table, slot_depth_to_rank)
from quickmer2_tpu_torch.ops import codec, rowpack


def _toy_genome(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=n).astype(np.uint8)


def _toy_dictionary(hash_size=1 << 12, k=30, seed=0):
    """Dictionary of the unique canonical k-mers of the toy genome, in
    genome order (so the toy reads' probes hit)."""
    canon, valid = codec.sliding_kmers_np(_toy_genome(seed=seed), k)
    kmers = canon[valid & (canon != 0)]
    _, first = np.unique(kmers, return_index=True)
    kmers = kmers[np.sort(first)]
    return Dictionary.from_kmers_in_order(kmers, hash_size, k)


def _toy_codes(n=4096, seed=0):
    """Simulated reads over the toy genome, separator-delimited."""
    genome = _toy_genome(seed=seed)
    rng = np.random.default_rng(seed + 1)
    parts = []
    total = 0
    while total < n:
        s = int(rng.integers(0, len(genome) - 100))
        parts.append(genome[s : s + 100])
        parts.append(np.array([codec.SEP], np.uint8))
        total += 101
    return np.concatenate(parts)[:n]


def _step(pk, bits, table, rank_slots, depth, *, k, hash_size, n_bases):
    slots = torch.zeros(hash_size + 1, dtype=depth.dtype, device=depth.device)
    count_linear_step(pk, bits, table, slots, k=k, hash_size=hash_size,
                      n_bases=n_bases)
    ranks = slot_depth_to_rank(slots, rank_slots, depth.shape[0] - 1)
    depth.copy_(store(u32(depth) + u32(ranks), depth.dtype))
    return depth


def entry(device: str = "cuda"):
    """(fn, args): the linear-probe count step and its arguments (2-bit
    packed codes and their invalid bits, the .qm table as (hi, lo)
    pairs, the slot of each rank, a zero rank-space depth u32[n_kmers +
    1]) on `device` (default the card; raises without one)."""
    dev = resolve_device(device)
    k = 30
    dic = _toy_dictionary(k=k)
    table = linear_table(dic, dev)
    codes = _toy_codes()
    pk, bits = rowpack.pack_rows(codes[None, :])
    depth = torch.zeros(dic.n_kmers + 1, dtype=word_dtype(dev), device=dev)
    fn = functools.partial(_step, k=k, hash_size=dic.hash_size,
                           n_bases=len(codes))
    args = (torch.from_numpy(pk[0]).to(dev), torch.from_numpy(bits[0]).to(dev),
            table, linear_rank_slots(dic, dev), depth)
    return fn, args
