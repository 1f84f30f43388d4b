"""Multi-device anchored count, the port of
quickmer2_tpu/parallel/anchored_parallel.py: the fast path
(ops.anchored) data-parallel over the mesh's "data" axis, and with the
packed rows split into bucket blocks over its "dict" axis.

  * reads — each batch splits into dp contiguous slices of rows; device
            row i anchors and verifies slice i;
  * rows  — one bucket block a dict column (ds > 1; the escape for a
            table larger than one card: ~69 GB of rows at GRCh38 scale
            at load 0.5, a byte count of the layout), whole otherwise;
            each block is placed from the index's host rows where the
            index holds none on a device (AnchoredIndex place_rows off,
            as run_count builds it under ds > 1), so no card holds the
            whole table; tiles and dblock are on every device;
  * diff / exact_acc — a u32[n + 2] partial per device of the grid,
            merged by an integer sum in grid order at finish.

Under ds > 1 no block can vote on its anchors alone, so each data slice
takes K3a (kernels.anchored.anchor_probes) on every block, the blocks'
found and pos summed in block order (the JAX psum), then K3 on every
block with those sums (its dirty and tier-2 probes find the block's
entries only; the first block adds the clean runs). Every block decides
the same spill codes; they combine by a max, which keeps code 2 (the JAX
counter's bool pmax folds it into 1; the depth is the same).

As in the JAX counter the exact recount runs through the packed table
(K12, kernels.count_mono.count_packed_rows, on each block), so the
counter has no mono table (mono_spill off) and its snapshots carry
diff[dp, ds, n + 2] and exact_acc[dp, ds, n + 2]: a sharded checkpoint
resumes in either package with the same mesh shape. The spill codes come
back in host order (device slices are contiguous), so routing, tier 2
and the exact path run sharded as in the one-device counter.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from quickmer2_tpu_torch.device import (
    store, to_numpy_u32, u32, word_dtype, words)
from quickmer2_tpu_torch.kernels.anchored import anchor_probes, anchored_count
from quickmer2_tpu_torch.kernels.count_mono import count_packed_rows
from quickmer2_tpu_torch.ops import rowpack
from quickmer2_tpu_torch.ops.anchored import AnchoredDepthCounter
from quickmer2_tpu_torch.parallel.count_parallel import put_on


class ShardedAnchoredCounter(AnchoredDepthCounter):
    """AnchoredDepthCounter over a data x dict mesh of devices; the same
    feed_reads / finish / snapshot / restore interface and the same
    depth for every mesh shape."""

    def __init__(self, index, k: int, read_len: int, mesh,
                 batch_reads: int | None = None, **kw):
        self.mesh = mesh
        self.dp = mesh.shape["data"]
        self.ds = mesh.shape["dict"]
        if batch_reads is None:     # lanes-based default (see base class)
            batch_reads = max(1 << 12, (1 << 22) // read_len)
        batch_reads = -(-batch_reads // self.dp) * self.dp
        kw.setdefault("mono_spill", False)
        if kw["mono_spill"]:
            raise ValueError("mono_spill is not supported on the sharded "
                             "anchored counter")
        kw.setdefault("device", mesh[0, 0])
        if index.n_buckets % self.ds:
            raise ValueError(f"dict_devices={self.ds} does not divide the "
                             f"index's {index.n_buckets} buckets")
        self.block_buckets = index.n_buckets // self.ds
        super().__init__(index, k, read_len, batch_reads=batch_reads, **kw)
        bb = self.block_buckets
        self._rows, self._tiles, self._dblock = {}, {}, {}
        for i in range(self.dp):
            for j in range(self.ds):
                d = mesh[i, j]
                if d not in self._tiles:
                    self._tiles[d] = index.genome_tiles.to(d)
                    self._dblock[d] = index.dblock.to(d)
                if (d, j) not in self._rows:      # a view where it lies
                    self._rows[d, j] = (
                        words(index.host_rows[j * bb:(j + 1) * bb], d)
                        if index.rows is None
                        else index.rows[j * bb:(j + 1) * bb].to(d))

    # -- the device steps, over the grid ----------------------------------

    def _init_accumulators(self) -> None:
        n = self.index.n_kmers

        def partials():
            return [[torch.zeros(n + 2, dtype=word_dtype(self.mesh[i, j]),
                                 device=self.mesh[i, j])
                     for j in range(self.ds)] for i in range(self.dp)]
        self.diff, self.exact_acc = partials(), partials()

    def _pack_put(self, batch: np.ndarray):
        """Pack a batch, cut it into dp contiguous row slices and copy
        slice i to the devices of row i (None for an empty slice)."""
        t0 = time.time()
        fmt, pk, aux = rowpack.pack_batch(batch)
        per = -(-len(batch) // self.dp)
        shards = []
        for i in range(self.dp):
            lo, hi = i * per, min(len(batch), (i + 1) * per)
            shards.append(None if lo >= hi else put_on(
                self.mesh.devices[i],
                (torch.from_numpy(np.ascontiguousarray(pk[lo:hi])),
                 rowpack.aux_tensor(fmt, aux[lo:hi]))))
        self.phase_s["pack_put"] += time.time() - t0
        return fmt, shards

    def _kernel_step(self, put, tier) -> list:
        fmt, shards = put
        kw = dict(fmt=fmt, **self._tier_kw(tier))
        bb = self.block_buckets
        codes = []
        for i, shard in enumerate(shards):
            if shard is None:
                continue
            if self.ds == 1:
                d = self.mesh[i, 0]
                codes.append(anchored_count(
                    *shard[d], self._rows[d, 0],
                    self._tiles[d], self._dblock[d], self.diff[i][0], **kw))
                continue
            d0 = self.mesh[i, 0]
            f_sum = p_sum = None
            for j in range(self.ds):            # the psum, in block order
                d = self.mesh[i, j]
                f, p = anchor_probes(
                    *shard[d], self._rows[d, j], fmt=fmt,
                    k=kw["k"], read_len=kw["read_len"],
                    n_buckets=kw["n_buckets"],
                    anchor_offsets=kw["anchor_offsets"], blk_lo=j * bb,
                    block_buckets=bb)
                f, p = f.to(d0).to(torch.int32), u32(p.to(d0))
                f_sum = f if f_sum is None else f_sum + f
                p_sum = p if p_sum is None else p_sum + p
            found = (f_sum > 0).to(torch.uint8)
            pos = store(p_sum, word_dtype(d0))
            code = None
            for j in range(self.ds):
                d = self.mesh[i, j]
                c = anchored_count(
                    *shard[d], self._rows[d, j],
                    self._tiles[d], self._dblock[d], self.diff[i][j],
                    anchors=(found.to(d), pos.to(d)), blk_lo=j * bb,
                    block_buckets=bb, ranges=j == 0, **kw).to(d0)
                code = c if code is None else torch.maximum(code, c)
            codes.append(code)
        return codes

    def _exact_step(self, put) -> list:
        fmt, shards = put
        bb = self.block_buckets
        for i, shard in enumerate(shards):
            if shard is None:
                continue
            for j in range(self.ds):
                d = self.mesh[i, j]
                count_packed_rows(
                    *shard[d], self._rows[d, j],
                    self.exact_acc[i][j], fmt=fmt, k=self.k,
                    n_buckets=self.index.n_buckets, read_len=self.read_len,
                    blk_lo=j * bb, block_buckets=bb)
        return []

    def _partials(self):
        """Host diff and exact_acc partials, u32[dp, ds, n + 2] each."""
        return tuple(np.stack([np.stack([to_numpy_u32(t) for t in row])
                               for row in acc])
                     for acc in (self.diff, self.exact_acc))

    def _merged_accumulators(self):
        out = []
        for part in self._partials():
            total = np.zeros(part.shape[-1], np.uint32)
            for i in range(self.dp):          # grid order; u32 wrap
                for j in range(self.ds):
                    total += part[i, j]
            out.append(total)
        return tuple(out)

    def _snapshot_accumulators(self):
        return self._partials()

    def _put_accumulators(self, diff: np.ndarray, acc: np.ndarray) -> None:
        """Checkpoint restore: each device's partials back in place; a
        snapshot of another mesh shape is refused."""
        if diff.shape != (self.dp, self.ds, self.index.n_kmers + 2):
            raise ValueError(
                f"checkpoint accumulator shape {diff.shape} does not match "
                f"dp={self.dp}, ds={self.ds}; resume with the same mesh")
        for i in range(self.dp):
            for j in range(self.ds):
                d = self.mesh[i, j]
                self.diff[i][j] = words(diff[i, j], d)
                self.exact_acc[i][j] = words(acc[i, j], d)
