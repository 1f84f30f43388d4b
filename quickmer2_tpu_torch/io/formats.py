"""Byte-level readers/writers for the reference's on-disk formats.

All layouts empirically verified in SURVEY.md section 4 (little-endian):

  .qm/.rqm  dictionary  — 24 B header ("QM11", k, e, d, d|thin, H u64,
             first_index u64) + u64 hash table[H] + u32 chain[H]
             (QuicKmer.c:1284-1299 writer, 345-359 reader)
  .qgc      per-k-mer GC annotation, u16 in chain order; bits 0-8 GC bin,
             bit 15 control-region flag (QuicKmer.c:1023-1047)
  .bed      window definitions, 5 text columns (QuicKmer.c:1054-1058)
  .bin      per-k-mer u16 depth in chain order (QuicKmer.c:498-517)
  .txt      401-line depth-vs-GC curve (QuicKmer.c:529-537)
  CN bed    4 text columns, CN printed with %f (QuicKmer.c:668-671)
  .qai      anchored-index companion (no reference counterpart; layout
             below, byte-identical to the JAX package's)
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

QM_MAGIC = b"QM11"
GC_BINS = 401
GC_BIN_MASK = 0x1FF   # bits 0-8 of a .qgc entry (QuicKmer.c:676)
CTRL_FLAG = 0x8000    # bit 15: inside control region


@dataclasses.dataclass
class QmHeader:
    kmer_size: int
    edit_distance: int
    edit_depth_threshold: int
    byte7: int            # d again (search/index) or thin factor low byte (sparse)
    hash_size: int
    first_index: int

    def pack(self) -> bytes:
        return QM_MAGIC + struct.pack(
            "<BBBBQQ", self.kmer_size, self.edit_distance,
            self.edit_depth_threshold, self.byte7, self.hash_size, self.first_index)

    @classmethod
    def unpack(cls, buf: bytes) -> "QmHeader":
        if buf[:4] != QM_MAGIC:
            # The reference never validates magic on read (QuicKmer.c:345-351);
            # we do, but only warn-level semantics: raise with a clear message.
            raise ValueError(f"not a .qm file (magic {buf[:4]!r})")
        k, e, d, b7, h, first = struct.unpack("<BBBBQQ", buf[4:24])
        return cls(k, e, d, b7, h, first)


def write_qm(path: str, header: QmHeader, table: np.ndarray, chain: np.ndarray) -> None:
    assert table.dtype == np.uint64 and chain.dtype == np.uint32
    assert len(table) == header.hash_size and len(chain) == header.hash_size
    with open(path, "wb") as f:
        f.write(header.pack())
        table.tofile(f)
        chain.tofile(f)


def read_qm_header(path: str) -> QmHeader:
    with open(path, "rb") as f:
        return QmHeader.unpack(f.read(24))


def read_qm(path: str, mmap: bool = True):
    """Returns (header, table u64[H], chain u32[H])."""
    header = read_qm_header(path)
    h = header.hash_size
    if mmap:
        table = np.memmap(path, dtype=np.uint64, mode="r", offset=24, shape=(h,))
        chain = np.memmap(path, dtype=np.uint32, mode="r", offset=24 + 8 * h, shape=(h,))
    else:
        with open(path, "rb") as f:
            f.seek(24)
            table = np.fromfile(f, dtype=np.uint64, count=h)
            chain = np.fromfile(f, dtype=np.uint32, count=h)
    return header, table, chain


def chain_order(chain: np.ndarray, first_index: int, n_kmers: int | None = None) -> np.ndarray:
    """Walk the circular genome-order chain from first_index; returns the
    slot sequence (the serialization order of .qgc/.bin — QuicKmer.c:494-516).

    The chain is a circular singly-linked list threaded through the table
    (built at QuicKmer.c:1048-1052): chain[slot] = next slot; the walk of
    the reference stops when it returns to first_index.
    """
    chain = np.asarray(chain)
    cap = len(chain) if n_kmers is None else n_kmers
    from quickmer2_tpu_torch.utils import native
    if native.available():
        return native.chain_walk(chain, first_index, cap)
    out = np.empty(cap, dtype=np.int64)
    idx = first_index
    n = 0
    for n in range(cap):
        out[n] = idx
        idx = int(chain[idx])
        if idx == first_index:
            n += 1
            break
    return out[:n]


def write_u16(path: str, values: np.ndarray) -> None:
    np.asarray(values, dtype="<u2").tofile(path)


def read_u16(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<u2")


def write_windows_bed(path: str, rows) -> None:
    """rows: iterable of (chrom, start_bp, end_bp, kmer_start, kmer_end)."""
    with open(path, "w") as f:
        for chrom, s, e, ks, ke in rows:
            f.write(f"{chrom}\t{s}\t{e}\t{ks}\t{ke}\n")


def read_windows_bed(path: str):
    """Returns (chroms list[str], arr i64[n,4] of start,end,kstart,kend)."""
    chroms, vals = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            chroms.append(parts[0])
            vals.append([int(parts[1]), int(parts[2]), int(parts[3]), int(parts[4])])
    return chroms, np.array(vals, dtype=np.int64).reshape(-1, 4)


def write_gc_curve(path: str, mean: np.ndarray, count: np.ndarray, var: np.ndarray) -> None:
    """401-line depth-vs-GC curve, matching the reference's printf formats
    `%.2f\\t%f\\t%i\\t%f\\n` (QuicKmer.c:529-537)."""
    with open(path, "w") as f:
        for i in range(GC_BINS):
            f.write("%.2f\t%f\t%i\t%f\n" % (i / 4.0, mean[i], int(count[i]), var[i]))


def read_gc_curve(path: str):
    mean = np.zeros(GC_BINS)
    count = np.zeros(GC_BINS, dtype=np.int64)
    var = np.zeros(GC_BINS)
    with open(path) as f:
        for i, line in enumerate(f):
            if i >= GC_BINS:
                break
            parts = line.split("\t")
            mean[i] = float(parts[1])
            count[i] = int(parts[2])
            var[i] = float(parts[3])
    return mean, count, var


def write_cn_bed(path: str, rows) -> None:
    """rows: iterable of (chrom, begin, end, cn). `%f` CN format
    (QuicKmer.c:668-671)."""
    with open(path, "w") as f:
        for chrom, b, e, cn in rows:
            f.write("%s\t%i\t%i\t%f\n" % (chrom, b, e, cn))


def read_cn_bed(path: str):
    chroms, vals = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 4:
                chroms.append(p[0])
                vals.append([int(p[1]), int(p[2]), float(p[3])])
    return chroms, np.array(vals, dtype=np.float64).reshape(-1, 3)


# -- .qai anchored-index companion -----------------------------------------
#
# Persists the two expensive products of ops.anchored.AnchoredIndex so a
# count never re-scans the reference FASTA or rebuilds the neighbor-hit
# bitmap:
#   * genome tiles  u8[T, 64] — code stream in bits 0-2, neighbor-hit
#     flags in bits 3-6 (ops.anchored.genome_tiles_np layout);
#   * dict_end_pos  u32[n]    — global genome END position of each
#     dictionary k-mer in rank order.
# The cheap derivations (dblock, packed-table rows) are rebuilt at load.
#
#   offset size  field
#   0      4     magic "QAI2"
#   4      1     kmer_size
#   5      1     flags (bit 0: neighbor bits present)
#   6      2     reserved (0)
#   8      8     genome_len G (bases incl. inter-chromosome separators)
#   16     8     n_kmers n
#   24     8     n_tiles T (= ceil(G/64))
#   32     8     dictionary content fingerprint
#                (dictionary.content_fingerprint)
#   40     64*T  tiles
#   40+64T 4*n   dict_end_pos

QAI_MAGIC = b"QAI2"
_QAI_HEADER = 40


def write_qai(path: str, k: int, genome_len: int, tiles: np.ndarray,
              dict_end_pos: np.ndarray, has_neighbor_bits: bool,
              fingerprint: int) -> None:
    tiles = np.ascontiguousarray(tiles, np.uint8)
    pos = np.ascontiguousarray(dict_end_pos, np.uint32)
    header = (QAI_MAGIC
              + struct.pack("<BBH", k, int(bool(has_neighbor_bits)), 0)
              + struct.pack("<QQQQ", genome_len, len(pos), tiles.shape[0],
                            fingerprint))
    # process-unique tmp + atomic rename: racing builders each land a
    # complete file, and readers never see a torn one
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(header)
        tiles.tofile(f)
        pos.tofile(f)
    os.replace(tmp, path)


def read_qai(path: str):
    """Returns (k, genome_len, tiles u8[T,64], dict_end_pos u32[n],
    has_neighbor_bits, fingerprint); tiles and pos are memory-mapped."""
    with open(path, "rb") as f:
        head = f.read(_QAI_HEADER)
    if head[:4] != QAI_MAGIC:
        raise ValueError(f"{path}: bad magic {head[:4]!r}, expected QAI2")
    k, flags, _ = struct.unpack("<BBH", head[4:8])
    genome_len, n, n_tiles, fingerprint = struct.unpack("<QQQQ", head[8:40])
    off = _QAI_HEADER
    tiles = np.memmap(path, np.uint8, "r", offset=off, shape=(n_tiles, 64))
    pos = np.memmap(path, np.uint32, "r", offset=off + 64 * n_tiles,
                    shape=(n,))
    return k, genome_len, tiles, pos, bool(flags & 1), fingerprint
