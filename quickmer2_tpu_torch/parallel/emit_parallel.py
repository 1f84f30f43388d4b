"""The search's pass-2 membership scan on the card (`search
--emit-devices 1`), the port of quickmer2_tpu/parallel/emit_parallel.py.

Reference hot loop #3 (dump_kmer_list, QuicKmer.c:981-1021) walks each
chromosome probing the dictionary position by position. Here the
chromosome streams through fixed-size chunks of window starts, each
with a k - 1 code halo (no window lost at a seam) and SEP padding at
the tail; each chunk is packed to 2 bits a base on the host
(ops.rowpack.pack_rows), and K10 (kernels.emit_member.member_scan)
probes every window's canonical k-mer against the packed survivor
table. Only the bit-packed hit mask comes back: G / 8 bytes for G
windows. The emitter's other work (GC bins, window rows, control flags)
stays on the host, over hit positions only.

Output is bit-identical to the host scan (tests/test_torch_emit.py
compares the artifacts with the JAX package's, byte for byte).
"""

from __future__ import annotations

import numpy as np
import torch

from quickmer2_tpu_torch.device import resolve_device
from quickmer2_tpu_torch.kernels.emit_member import member_scan, unpack_mask
from quickmer2_tpu_torch.ops import rowpack
from quickmer2_tpu_torch.ops.codec import SEP

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
                 chunk: int = CHUNK, device: str | torch.device = "cuda"):
        if int(data_devices or 1) > 1:
            raise NotImplementedError(
                f"DeviceMembershipScanner: data_devices={data_devices} is "
                "not yet ported to quickmer2_tpu_torch (multi-GPU, ROADMAP "
                "Queue 1 item 9)")
        self.k = k
        self.chunk = chunk
        self.n_buckets = packed_table.n_buckets
        self.device = resolve_device(device)
        self.rows = packed_table.device_rows(self.device)

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

    def scan_chunk(self, seg: np.ndarray) -> torch.Tensor:
        """K10 on one chunk of codes: its bit-packed hit mask on the
        device."""
        pk, bits = rowpack.pack_rows(seg[None])
        return member_scan(torch.from_numpy(pk[0]).to(self.device),
                           torch.from_numpy(bits[0]).to(self.device),
                           self.rows, k=self.k, n_buckets=self.n_buckets,
                           n_bases=len(seg))

    def scan(self, codes: np.ndarray) -> np.ndarray:
        """bool[len(codes) - k + 1]: the canonical k-mer at each window
        start is a (nonzero, valid) member of the survivor table."""
        W = len(codes) - self.k + 1
        out = np.zeros(max(W, 0), bool)
        for off, take, seg in self.chunks(codes):
            out[off: off + take] = unpack_mask(self.scan_chunk(seg), take)
        return out
