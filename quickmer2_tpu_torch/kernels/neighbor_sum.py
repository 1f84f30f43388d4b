"""Per-neighbor packed-table sum: the CUDA kernel csrc/neighbor_sum.cu
(K6) and its plain PyTorch version.

`neighbor_sum` replaces quickmer2_tpu/ops/editdist.py::
neighbor_occr_sum_packed: for each query (canonical code and its exact
reverse complement) it sums, over the M substitution neighbors of
ops.editdist.edit_table(k, e), the pos field of the neighbors found in
the packed table (ops.packed_table), which the search fills with
occurrence counts. It carries the search's edit filter where the join
sends a query to its slow path, and the whole `probe` filter. The kernel
reads the table only for the neighbors that pass the table's key filter
(kernels.neighbor_bits.key_filter, no false negatives), so the sums are
the unfiltered probe's.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quickmer2_tpu_torch.device import store, u32, word_dtype
from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.kernels.neighbor_bits import (
    filter_pass, filter_slots)
from quickmer2_tpu_torch.ops.editdist import (
    _neighbor_canon, edit_table, edit_table_t)
from quickmer2_tpu_torch.ops.hash import djb_pair
from quickmer2_tpu_torch.ops.packed_table import (
    ROW_WIDTH, bucket_hashes_t, probe_packed)

_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
_edit_words: dict = {}


def edit_words(k: int, e: int) -> np.ndarray:
    """The edit table packed one u32 an edit, as the kernel reads it:
    p1 in bits 0-5, d1 in 6-7, p2 in 8-13, d2 in 14-15 (p2 = d2 = 0 for
    a single edit, which then applies a no-op)."""
    p1, d1, p2, d2 = edit_table(k, e)
    return (p1.astype(np.uint32) | (d1 << 6)
            | (np.maximum(p2, 0).astype(np.uint32) << 8) | (d2 << 14))


def neighbor_sum_plain(qhi, qlo, rhi, rlo, rows, filt, *, k: int, e: int,
                       n_buckets: int, slab_pairs: int = 1 << 22,
                       trace: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version: _neighbor_canon, probe_packed and a row
    sum, in slabs of at most slab_pairs (query, edit) pairs. It probes
    every neighbor; `filt` is read only with a `trace` dict, which
    records the probes, how many pass the filter, the table rows those
    name and the filter sectors (8 words) all probes name (for bounds
    and pass rates), and the hits the filter would drop (`missed`, 0
    for a filter without false negatives)."""
    tables = edit_table_t(k, e, qhi.device)
    m = tables[0].shape[0]
    n = qhi.shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=qhi.device)
    if trace is not None:
        touched = torch.zeros(n_buckets, dtype=torch.bool, device=qhi.device)
        sectors = torch.zeros(max(1, filt.shape[0] // 8), dtype=torch.bool,
                              device=qhi.device)
        trace.update(probes=n * m, passed=0, missed=0)
    step = max(1, slab_pairs // m)
    for s in range(0, n, step):
        part = [u32(t[s:s + step]) for t in (qhi, qlo, rhi, rlo)]
        chi, clo = _neighbor_canon(*part, *tables, k)
        found, _, pos = probe_packed(rows, chi, clo, n_buckets, 0)
        out[s:s + step] = torch.where(found, pos, 0).view(-1, m).sum(1)
        if trace is not None:
            h = djb_pair(chi, clo)
            passed = filter_pass(filt, h)
            for b in bucket_hashes_t(h[passed], n_buckets):
                touched[b] = True
            sectors[filter_slots(h, filt.shape[0])[0] >> 3] = True
            trace["passed"] += int(passed.sum())
            trace["missed"] += int((found & ~passed).sum())
    if trace is not None:
        trace.update(rows_touched=int(touched.sum()),
                     filter_sectors=int(sectors.sum()))
    return store(out, word_dtype(qhi.device))


def neighbor_sum(qhi: torch.Tensor, qlo: torch.Tensor, rhi: torch.Tensor,
                 rlo: torch.Tensor, rows: torch.Tensor, filt: torch.Tensor,
                 *, k: int, e: int, n_buckets: int) -> torch.Tensor:
    """Neighbor-occurrence sums, u32 word tensor [N]. qhi/qlo: canonical
    codes, rhi/rlo: their exact reverse complements (word tensors [N]);
    rows: the packed table [n_buckets, 8] with counts in pos; filt:
    key_filter(rows), u32 words [2^w]."""
    if qhi.device.type == "cpu":
        return neighbor_sum_plain(qhi, qlo, rhi, rlo, rows, filt, k=k, e=e,
                                  n_buckets=n_buckets)
    n, n_words = qhi.shape[0], filt.shape[0]
    build.check_tensors("neighbor_sum", qhi.device, [
        ("qhi", qhi, torch.int32, (n,)), ("qlo", qlo, torch.int32, (n,)),
        ("rhi", rhi, torch.int32, (n,)), ("rlo", rlo, torch.int32, (n,)),
        ("rows", rows, torch.int32, (n_buckets, ROW_WIDTH)),
        ("filt", filt, torch.int32, (n_words,))])
    if not (1 <= k <= 32 and 1 <= e <= 2):
        raise ValueError(f"neighbor_sum: bad k={k} or e={e}")
    if n_words not in [1 << b for b in range(5, 24)]:
        raise ValueError(f"neighbor_sum: bad filter size {n_words} words")
    key = (k, e, qhi.device)
    if key not in _edit_words:
        _edit_words[key] = torch.from_numpy(
            edit_words(k, e).view(np.int32)).to(qhi.device)
    edits = _edit_words[key]
    out = torch.empty(n, dtype=torch.int32, device=qhi.device)
    if n == 0:
        return out
    lib = build.load("neighbor_sum", {"qm2t_neighbor_sum": _ARGTYPES})
    with torch.cuda.device(qhi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_neighbor_sum(
            qhi.data_ptr(), qlo.data_ptr(), rhi.data_ptr(), rlo.data_ptr(),
            edits.data_ptr(), edits.shape[0], rows.data_ptr(), n_buckets,
            filt.data_ptr(), n_words.bit_length() - 1, k, n, out.data_ptr(),
            stream)
    build.check(lib, rc, "neighbor_sum")
    neighbor_sum.launches += 1
    return out


neighbor_sum.launches = 0
