"""The search's pass-2 membership scan on the card (`search
--emit-devices 1`), the port of quickmer2_tpu/parallel/emit_parallel.py.

Reference hot loop #3 (dump_kmer_list, QuicKmer.c:981-1021) walks each
chromosome probing the dictionary position by position. Here the
chromosome streams through fixed-size chunks of window starts, each
with a k - 1 code halo (no window lost at a seam) and SEP padding at
the tail; each chunk is packed to 2 bits a base on the host
(ops.rowpack.pack_rows), and K10 (kernels.emit_member.member_scan)
probes every window's canonical k-mer against the packed survivor
table, reading a key's h2 row only where the table's bitmap of keys at
h2 (kernels.block_probe.block_displaced_filter, built once a device)
allows. Only the bit-packed hit mask comes back: G / 8 bytes for G
windows. The emitter's other work (GC bins, window rows, control flags)
stays on the host, over hit positions only.

With data_devices = dp above 1 each chunk is split over the devices of a
dp x 1 mesh (parallel.mesh) with the k - 1 halo of
parallel.count_parallel.split_codes_overlap; K10 runs once a shard, on
the shard's device, and the shards' masks are concatenated.

Output is bit-identical to the host scan (tests/test_torch_emit.py
compares the artifacts with the JAX package's, byte for byte).
"""

from __future__ import annotations

import numpy as np
import torch

from quickmer2_tpu_torch.device import resolve_device
from quickmer2_tpu_torch.kernels.block_probe import block_displaced_filter
from quickmer2_tpu_torch.kernels.emit_member import member_scan, unpack_mask
from quickmer2_tpu_torch.ops import rowpack
from quickmer2_tpu_torch.ops.codec import SEP
from quickmer2_tpu_torch.parallel.count_parallel import split_codes_overlap
from quickmer2_tpu_torch.parallel.mesh import make_mesh

# window starts a chunk: K2's batch of 2^24 bases (the chunk size does
# not change the mask)
CHUNK = 1 << 24
# the last chunk of a chromosome is padded to a multiple of this many
# windows, not to a whole chunk
TAIL_ROUND = 1 << 12


class DeviceMembershipScanner:
    """Membership of each genome position's canonical k-mer in a packed
    survivor table, computed on `device` chunk by chunk."""

    def __init__(self, packed_table, k: int, data_devices: int = 1,
                 chunk: int = CHUNK, device: str | torch.device = "cuda",
                 devices=None):
        """data_devices above 1 shards each chunk over a data_devices x 1
        mesh of `device`'s type (or of the explicit `devices` list)."""
        self.k = k
        self.chunk = chunk
        self.n_buckets = packed_table.n_buckets
        self.device = resolve_device(device)
        self.dp = max(int(data_devices or 1), 1)
        self.mesh = None
        if self.dp > 1:
            self.mesh = make_mesh(self.dp, 1, devices=devices,
                                  device=self.device)
            self.device = self.mesh[0, 0]
            self._rows = {d: packed_table.device_rows(d)
                          for d in self.mesh.distinct()}
            self.rows = self._rows[self.device]
        else:
            self.rows = packed_table.device_rows(self.device)
            self._rows = {self.device: self.rows}
        # K10 reads h2 only where this bitmap of the keys at h2 allows:
        # one a device that holds rows
        self._displaced = {d: block_displaced_filter(r, self.n_buckets, 0)
                           for d, r in self._rows.items()}
        self.displaced = self._displaced[self.device]

    def chunks(self, codes: np.ndarray):
        """(offset, windows taken, padded codes) of each chunk: the
        codes of `chunk` window starts (fewer, rounded up to TAIL_ROUND,
        at the tail) and their k - 1 halo, SEP past the end."""
        W = len(codes) - self.k + 1
        for off in range(0, W, self.chunk):
            take = min(self.chunk, W - off)
            n_win = min(self.chunk, -(-take // TAIL_ROUND) * TAIL_ROUND)
            seg = codes[off: off + n_win + self.k - 1]
            pad = n_win + self.k - 1 - len(seg)
            if pad > 0:
                seg = np.pad(seg, (0, pad), constant_values=SEP)
            yield off, take, seg

    def scan_chunk(self, seg: np.ndarray, device=None) -> torch.Tensor:
        """K10 on one chunk of codes: its bit-packed hit mask on the
        device (default: the scanner's), against that device's rows."""
        device = device or self.device
        pk, bits = rowpack.pack_rows(seg[None])
        return member_scan(torch.from_numpy(pk[0]).to(device),
                           torch.from_numpy(bits[0]).to(device),
                           self._rows[device], k=self.k,
                           n_buckets=self.n_buckets, n_bases=len(seg),
                           displaced=self._displaced[device])

    def scan_sharded(self, seg: np.ndarray) -> np.ndarray:
        """The hit mask of a chunk's windows, the chunk split over the
        mesh's data axis (dp shards of `per` windows each, halo k - 1):
        bool[dp * per]."""
        shards = split_codes_overlap(seg, self.dp, self.k)
        per = shards.shape[1] - self.k + 1
        masks = []
        for i in range(self.dp):
            d = self.mesh[i, 0]
            masks.append(self.scan_chunk(shards[i], d))
        return np.concatenate([unpack_mask(m, per) for m in masks])

    def scan(self, codes: np.ndarray) -> np.ndarray:
        """bool[len(codes) - k + 1]: the canonical k-mer at each window
        start is a (nonzero, valid) member of the survivor table."""
        W = len(codes) - self.k + 1
        out = np.zeros(max(W, 0), bool)
        for off, take, seg in self.chunks(codes):
            if self.mesh is None:
                out[off: off + take] = unpack_mask(self.scan_chunk(seg), take)
            else:
                out[off: off + take] = self.scan_sharded(seg)[:take]
        return out
