"""Multi-device flat count: data-parallel read shards x a dictionary
sharded into bucket blocks, the port of
quickmer2_tpu/parallel/count_parallel.py.

  * the host splits each code batch into `dp` chunks overlapping by k-1
    codes (split_codes_overlap: no window is lost at a shard boundary);
  * the packed two-choice table (ops.packed_table) is split into `ds`
    contiguous bucket blocks; buckets are self-contained, so no halo is
    needed: a key's entry lives in exactly one block, and the block that
    holds it counts its hits;
  * device (i, j) of the mesh counts data shard i against block j with
    kernel K8b (kernels.count_flat.count_packed_block_step), in the
    block's slot space; each partial maps to the JAX step's rank-space
    partial depth[i, j] (u32[n + 1], trash last) at snapshot and finish,
    and the partials merge by an integer sum in grid order, so the bytes
    do not depend on the order or the mesh shape.

The counter is a DepthCounter (its batching, tail and residual) with the
mesh's device step and depth. Snapshots carry the JAX counter's
depth[dp, ds, n + 1], so a sharded checkpoint resumes in either package
(with the same mesh shape).
"""

from __future__ import annotations

import numpy as np
import torch

from quickmer2_tpu_torch.device import to_numpy_u32, word_dtype, words
from quickmer2_tpu_torch.kernels.count_flat import (
    block_slot_depth_to_rank, count_packed_block_step, packed_block_entries)
from quickmer2_tpu_torch.ops import rowpack
from quickmer2_tpu_torch.ops.codec import SEP
from quickmer2_tpu_torch.ops.packed_table import ROW_WIDTH, PackedTable
from quickmer2_tpu_torch.pipelines.count import DepthCounter


def split_codes_overlap(batch: np.ndarray, dp: int, k: int) -> np.ndarray:
    """Split a code batch into dp chunks with k-1 overlap → [dp, chunk]."""
    n = len(batch)
    chunk = -(-n // dp)
    padded = np.full(dp * chunk + (k - 1), SEP, np.uint8)
    padded[:n] = batch
    out = np.empty((dp, chunk + k - 1), np.uint8)
    for i in range(dp):
        out[i] = padded[i * chunk: (i + 1) * chunk + (k - 1)]
    return out


def put_on(devices, host: tuple) -> dict:
    """{device: the host tensors on it}, once per distinct device of
    `devices` (pinned copies to a card, behind the stream's work)."""
    pinned = None
    out = {}
    for d in devices:
        if d in out:
            continue
        if d.type == "cpu":
            out[d] = host
            continue
        if pinned is None:
            pinned = tuple(t.pin_memory() for t in host)
        out[d] = tuple(t.to(d, non_blocking=True) for t in pinned)
    return out


class ShardedDepthCounter(DepthCounter):
    """The flat DepthCounter over a data x dict mesh of devices: its
    batching, tail flush and stream checkpoint, with the device step and
    the depth state of the mesh."""

    layout = "sharded"

    def __init__(self, dictionary, mesh, batch_bases: int = 1 << 24):
        self.dict = dictionary
        self.mesh = mesh
        self.k = dictionary.kmer_size
        self.batch_bases = batch_bases
        self.dp = mesh.shape["data"]
        self.ds = mesh.shape["dict"]
        packed = PackedTable.from_dictionary(dictionary)
        if packed.n_buckets % self.ds:
            raise ValueError(f"dict_devices={self.ds} does not divide the "
                             f"table's {packed.n_buckets} buckets")
        self.n_buckets = packed.n_buckets
        bb = self.block_buckets = packed.n_buckets // self.ds
        blocks = packed.rows.reshape(self.ds, bb, ROW_WIDTH)
        self._rows, self._entries = {}, {}
        for i in range(self.dp):
            for j in range(self.ds):
                d = mesh[i, j]
                if (d, j) not in self._rows:
                    self._rows[d, j] = words(blocks[j], d)
                    self._entries[d, j] = packed_block_entries(
                        self._rows[d, j])
        self._zero_partials()
        # restored rank-space partials u32[dp, ds, n + 1], added to the
        # slot-space counts at snapshot and finish
        self._base = None
        self._carry = np.zeros(0, np.uint8)
        self._pending: list[np.ndarray] = []
        self._pending_len = 0
        self.total_kmer_windows = 0

    def _zero_partials(self) -> None:
        self.depth = [[torch.zeros(2 * self.block_buckets + 1,
                                   dtype=word_dtype(self.mesh[i, j]),
                                   device=self.mesh[i, j])
                       for j in range(self.ds)] for i in range(self.dp)]

    def _run(self, batch: np.ndarray) -> None:
        shards = split_codes_overlap(batch, self.dp, self.k)
        bb = self.block_buckets
        for i in range(self.dp):
            pk, bits = rowpack.pack_rows(shards[i][None])
            placed = put_on(self.mesh.devices[i], (torch.from_numpy(pk[0]),
                                                   torch.from_numpy(bits[0])))
            for j in range(self.ds):
                d = self.mesh[i, j]
                count_packed_block_step(
                    *placed[d], self._rows[d, j], self.depth[i][j], k=self.k,
                    n_buckets=self.n_buckets, blk_lo=j * bb,
                    block_buckets=bb, n_bases=shards.shape[1])
        self.total_kmer_windows += len(batch) - self.k + 1
        self._carry = batch[-(self.k - 1):].copy()

    def _rank_partials(self) -> np.ndarray:
        """The JAX counter's depth[dp, ds, n + 1], u32."""
        n = self.dict.n_kmers
        out = np.zeros((self.dp, self.ds, n + 1), np.uint32)
        for i in range(self.dp):
            for j in range(self.ds):
                d = self.mesh[i, j]
                out[i, j] = to_numpy_u32(block_slot_depth_to_rank(
                    self.depth[i][j], self._entries[d, j], n))
        if self._base is not None:
            out += self._base
        return out

    def _final_depth(self) -> np.ndarray:
        parts = self._rank_partials()
        total = np.zeros(parts.shape[-1], np.uint32)
        for i in range(self.dp):          # grid order; u32 wrap
            for j in range(self.ds):
                total += parts[i, j]
        return total[:-1]

    # -- checkpoint/resume: the JAX ShardedDepthCounter's keys ------------

    def _depth_state(self) -> dict:
        return {"depth": self._rank_partials()}

    def _put_depth_state(self, snap: dict) -> None:
        depth = np.asarray(snap["depth"], np.uint32)
        want = (self.dp, self.ds, self.dict.n_kmers + 1)
        if depth.shape != want:
            raise ValueError(
                f"checkpoint depth shape {depth.shape} != {want}; resume "
                f"with the same data_devices/dict_devices mesh")
        self._base = depth.copy()
        self._zero_partials()
