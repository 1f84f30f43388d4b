"""Edit-distance neighbor enumeration table (port of the host half of
quickmer2_tpu/ops/editdist.py).

Reference: Recurse_edit/Permute_kmer (QuicKmer.c:78-88, 687-736). For
every k-mer with occurrence count 1, the reference sums the occurrence
counts of all substitution neighbors at edit distance <= e
(distance-2 pairs restricted to pos2 < pos1, each pair enumerated once).
The table below lists those edits as (pos1, delta1, pos2, delta2)
tuples: M = 3k single edits plus 9*k*(k-1)/2 double edits (4005 at
k=30). The search's host slow path (ops.hamming_join) applies them.
"""

from __future__ import annotations

import numpy as np


def edit_table(k: int, edit_distance: int):
    """Static neighbor-edit table: arrays pos1, delta1 (1..3), pos2,
    delta2, with pos2 = -1 rows for single edits. A delta is applied as
    newbase = (base + delta) & 3, which is not an XOR, so callers
    compute the XOR per element."""
    p1, d1, p2, d2 = [], [], [], []
    for a in range(k):
        for va in (1, 2, 3):
            p1.append(a); d1.append(va); p2.append(-1); d2.append(0)
            if edit_distance >= 2:
                for b in range(a):
                    for vb in (1, 2, 3):
                        p1.append(a); d1.append(va); p2.append(b); d2.append(vb)
    return (np.array(p1, np.int32), np.array(d1, np.uint32),
            np.array(p2, np.int32), np.array(d2, np.uint32))
