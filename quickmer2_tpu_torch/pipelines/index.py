"""index — build a .qm dictionary from a precomputed k-mer BED list (the
port of quickmer2_tpu/pipelines/index.py; host code).

Reference: main_hash (QuicKmer.c:127-254). Parity semantics:
  * rows are whitespace-separated (chrom, start, end, kmer); the k-mer
    size comes from the FIRST row's string length, overriding any -k
    (QuicKmer.c:201-202);
  * encoding uses Kmer_encode's fixed <<60 reverse-complement register
    (exact only at k=30 — SURVEY.md Q1); we reproduce that bit-for-bit
    via codec rc-register emulation so k<30 indexes interoperate;
  * insertion scans to the first EMPTY slot even past an existing copy
    of the key (QuicKmer.c:208-213) — duplicate bed rows occupy
    multiple slots and multiple chain positions;
  * chain order = input row order; header bytes e/d keep the global
    defaults 2/100 (QuicKmer.c:243-246); no .bed/.qgc are produced.
"""

from __future__ import annotations

import numpy as np

from quickmer2_tpu_torch.device import resolve_device
from quickmer2_tpu_torch.dictionary import Dictionary, make_rank
from quickmer2_tpu_torch.io import formats
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.utils import native


def encode_kmer_ref(s: str) -> int:
    """Reference Kmer_encode parity (QuicKmer.c:48-64): canonical =
    min(fwd, rc_register) where the rc register accumulates at bit 60,
    leaving the rc in bits (60-2k)..59 — exact only for k=30."""
    codes = codec.encode_bases(s.encode())
    fwd = 0
    rc = 0
    for c in codes:
        fwd = (fwd << 2) | int(c & 3)
        rc |= (((int(c) - 2) & 3) << 60)
        rc >>= 2
    return min(fwd, rc)


def run_index(bed_path: str, out_qm: str, hash_size: int = 0x2000000,
              verbose: bool = True, device: str = "cuda") -> Dictionary:
    """Writes out_qm. The work is host code; `device` is resolved like
    every entry point's ("cuda" raises without a card)."""
    resolve_device(device)
    kmers = []
    k = None
    with open(bed_path) as f:
        for line in f:
            p = line.split()
            if len(p) < 4:
                continue
            if k is None:
                k = len(p[3])
            kmers.append(encode_kmer_ref(p[3]))
    if k is None:
        raise ValueError(f"no k-mer rows in {bed_path}")
    keys = np.array(kmers, dtype=np.uint64)

    table = np.zeros(hash_size, dtype=np.uint64)
    if native.available():
        slots = native.insert_keys_dup(table, keys, return_slots=True)
    else:
        slots = _insert_dup_np(table, keys, hash_size)
    header = formats.QmHeader(k, 2, 100, 100, hash_size,
                              int(slots[0]) if len(slots) else 0)
    dic = Dictionary(header, table, np.asarray(slots, np.int64),
                     make_rank(hash_size, slots))
    dic.to_qm(out_qm)
    if verbose:
        print(f"index: {len(keys)} k-mers (k={k}) → {out_qm}")
    return dic


def _insert_dup_np(table, keys, hash_size):
    from quickmer2_tpu_torch.ops.hash import djb_u64_np, scan_direction_np
    idx0 = djb_u64_np(keys) & np.uint32(hash_size - 1)
    step = scan_direction_np(idx0, hash_size)
    out = np.empty(len(keys), dtype=np.int64)
    for i in range(len(keys)):
        j = int(idx0[i])
        while table[j]:
            j += int(step[i])
        table[j] = keys[i]
        out[i] = j
    return out
