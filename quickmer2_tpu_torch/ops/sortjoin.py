"""Sort-join exact count engine: the flat count without a hash table.

Port of quickmer2_tpu/ops/sortjoin.py::SortJoinEngine in plain PyTorch.
The dictionary's keys are sorted once, in the order of
np.argsort(kmers, kind="stable"); depth accumulates in that order, u32
[n + 1] (the last lane a pad that stays 0), and is permuted back to
genome (rank) order at finish. The state is the JAX engine's, so
snapshots interchange.

Each batch's window keys (kernels.count_flat.kmerize_step, K9) join the
sorted keys by binary search (torch.searchsorted); the hits' positions
are added as one histogram (torch.bincount). The JAX engine joins by a
two-key sort of the keys and the queries in fixed 2^20-lane tiles, the
shape XLA could compile; neither the sort of the queries nor the tiles
are needed for the same result.

A key is the canonical code (hi << 32 | lo) as an int64 with bit 63
flipped, so that the signed order of the keys is the unsigned order of
the codes (at k = 32 a canonical code can have bit 63 set; CPU torch has
no uint64 sort or searchsorted). Invalid windows carry key 0, which no
dictionary holds (quirk Q3).
"""

from __future__ import annotations

import numpy as np
import torch

from quickmer2_tpu_torch.device import (
    store, to_numpy_u32, u32, word_dtype, words)

SIGN_BIT = -(1 << 63)


def sort_keys(chi: torch.Tensor, clo: torch.Tensor) -> torch.Tensor:
    """int64 sort keys of (hi, lo) word tensors: the code, bit 63
    flipped."""
    return ((u32(chi) << 32) | u32(clo)) ^ SIGN_BIT


class SortJoinEngine:
    """Key-sorted-order exact counter over code batches on one device."""

    def __init__(self, kmers_in_order: np.ndarray, device: torch.device):
        kmers = np.asarray(kmers_in_order, np.uint64)
        self.device = device
        self.order = np.argsort(kmers, kind="stable")
        flipped = kmers[self.order] ^ np.uint64(1 << 63)
        self.skeys = torch.from_numpy(flipped.view(np.int64)).to(device)
        self.n = len(kmers)
        self.depth_sorted = torch.zeros(self.n + 1, dtype=word_dtype(device),
                                        device=device)

    def count_codes(self, chi: torch.Tensor, clo: torch.Tensor,
                    valid: torch.Tensor) -> None:
        """Add one batch: canonical (hi, lo) word tensors and their
        validity; invalid lanes count as key 0."""
        if self.n == 0:
            return
        q = torch.where(valid, sort_keys(chi, clo), SIGN_BIT)
        pos = torch.searchsorted(self.skeys, q)
        hit = self.skeys[pos.clamp(max=self.n - 1)] == q
        counts = torch.bincount(torch.where(hit, pos, self.n),
                                minlength=self.n + 1)[:self.n]
        self.depth_sorted[:self.n] = store(
            u32(self.depth_sorted[:self.n]) + counts, self.depth_sorted.dtype)

    def finish(self) -> np.ndarray:
        """Depth in genome (rank) order, u32[n]."""
        out = np.zeros(self.n, np.uint32)
        out[self.order] = to_numpy_u32(self.depth_sorted)[:self.n]
        return out

    # -- state carried across (pipelines.count.DepthCounter) ------------

    def snapshot_depth(self) -> np.ndarray:
        return to_numpy_u32(self.depth_sorted)

    def restore_depth(self, depth: np.ndarray) -> None:
        if len(depth) != self.n + 1:
            raise ValueError(
                f"sortjoin checkpoint depth length {len(depth)} != "
                f"{self.n + 1}")
        self.depth_sorted = words(np.asarray(depth, np.uint32), self.device)
