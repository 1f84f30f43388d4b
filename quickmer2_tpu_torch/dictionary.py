"""The k-mer dictionary: the central data structure of the framework.

Reference representation (QuicKmer.c, SURVEY.md L1): an open-addressing
u64 hash table with a circular genome-order chain threaded through it.
That layout is pointer-chasing — fine for one CPU thread, hostile to a
GPU. The host keeps the reference table (same DJB + bidirectional-probe
placement, so .qm files interoperate both directions) plus

  chain_slots : i64[n_kmers], slot order = genome (chain) order
  rank        : i32[H], slot → position in genome order, or n_kmers
                for empty/unchained slots

and the count path derives its device table from the genome-ordered
k-mers (ops.monotable), accumulating depth so that `.bin`
serialization is a plain dump (the reference instead walks the chain
at dump time, QuicKmer.c:494-516).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from quickmer2_tpu_torch.io import formats
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.utils import native


@dataclasses.dataclass
class Dictionary:
    header: formats.QmHeader
    table: np.ndarray          # u64[H] host copy (memmap ok)
    chain_slots: np.ndarray    # i64[n_kmers] slot order = genome order
    rank: np.ndarray           # i32[H] slot → rank, n_kmers if unchained

    @property
    def kmer_size(self) -> int:
        return self.header.kmer_size

    @property
    def hash_size(self) -> int:
        return self.header.hash_size

    @property
    def n_kmers(self) -> int:
        return len(self.chain_slots)

    @property
    def kmers_in_order(self) -> np.ndarray:
        """Canonical codes in genome order (u64[n_kmers])."""
        return np.asarray(self.table)[self.chain_slots]

    @property
    def fingerprint(self) -> int:
        """Content hash of (k, the ordered k-mer set) — identifies the
        dictionary regardless of slot placement history. Used to detect
        stale derived artifacts (.qai) built for a different dictionary
        over the same genome (e.g. rebuilt with different -d)."""
        return content_fingerprint(self.kmers_in_order, self.kmer_size)

    # -- construction ----------------------------------------------------

    @classmethod
    def from_qm(cls, path: str) -> "Dictionary":
        header, table, chain = formats.read_qm(path)
        chain_slots = formats.chain_order(chain, header.first_index)
        rank = make_rank(header.hash_size, chain_slots)
        return cls(header, table, chain_slots, rank)

    @classmethod
    def from_kmers_in_order(cls, kmers: np.ndarray, hash_size: int,
                            kmer_size: int, edit_distance: int = 0,
                            edit_depth_threshold: int = 0,
                            byte7: int | None = None) -> "Dictionary":
        """Build a fresh dictionary from canonical codes in genome order.

        Placement inserts keys in chain order with the reference probe
        rule, so the exported .qm is readable by the reference binary.
        (Slot placement may differ from a reference-built .qm whose
        placement embeds its pass-1 insert + resize + compact history —
        SURVEY.md section 3.1; all chain-ordered outputs are unaffected.)
        Raises ValueError when the keys would fill the table: the
        reference probe walks without wrapping and runs off a full one.
        """
        kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
        if len(kmers) >= hash_size:
            raise ValueError(
                f"Dictionary.from_kmers_in_order: {len(kmers)} keys do not "
                f"fit a table of {hash_size} slots")
        table = np.zeros(hash_size, dtype=np.uint64)
        if native.available():
            slots = native.insert_keys(table, kmers, return_slots=True)
        else:
            from quickmer2_tpu_torch.ops import hash as qhash
            slots = qhash.probe_insert_np(table, kmers, hash_size)
        first = int(slots[0]) if len(slots) else 0
        header = formats.QmHeader(
            kmer_size, edit_distance, edit_depth_threshold,
            edit_depth_threshold if byte7 is None else byte7,
            hash_size, first)
        rank = make_rank(hash_size, slots)
        return cls(header, table, np.asarray(slots, np.int64), rank)

    # -- export ----------------------------------------------------------

    def chain_array(self) -> np.ndarray:
        """Rebuild the circular u32 chain array from chain_slots."""
        chain = np.zeros(self.hash_size, dtype=np.uint32)
        if self.n_kmers:
            nxt = np.roll(self.chain_slots, -1)
            chain[self.chain_slots] = nxt.astype(np.uint32)
        return chain

    def to_qm(self, path: str) -> None:
        formats.write_qm(path, self.header, np.ascontiguousarray(self.table),
                         self.chain_array())

    # -- device views ----------------------------------------------------

    def device_arrays(self):
        """(table_hi, table_lo, rank) as host numpy: the reference table's
        u32 halves and the slot → rank map (the linear-probe count's
        inputs, kernels.count_flat)."""
        hi, lo = codec.split_u64(np.asarray(self.table))
        return hi, lo, np.asarray(self.rank, dtype=np.int32)


def content_fingerprint(kmers_in_order: np.ndarray, kmer_size: int) -> int:
    """64-bit content hash of a dictionary: blake2b over k plus the
    genome-ordered canonical codes. Order-sensitive by design (the rank
    coordinate system is part of the contract)."""
    import hashlib
    h = hashlib.blake2b(digest_size=8)
    h.update(bytes([kmer_size]))
    h.update(np.ascontiguousarray(kmers_in_order, "<u8").tobytes())
    return int.from_bytes(h.digest(), "little")


def make_rank(hash_size: int, chain_slots: np.ndarray) -> np.ndarray:
    n = len(chain_slots)
    rank = np.full(hash_size, n, dtype=np.int32)
    rank[np.asarray(chain_slots)] = np.arange(n, dtype=np.int32)
    return rank
