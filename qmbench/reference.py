"""The plain reference of a count: k-mer depth of a FASTQ byte stream.

It reads the same FASTQ bytes and the same dictionary keys that the
benchmark hands the program, decodes and counts on its own, and imports
nothing of the program: plain PyTorch (on the card or the CPU) and NumPy.

Semantics (QuicK-mer2's `count`, which the configurations state):
  - a base is A, C, G or T in either case; A0 C1 T2 G3 (code = (ascii >>
    1) & 3), any other byte ends the k-mers that would span it;
  - a window is k consecutive bases of one sequence line; its k-mer is
    the smaller of its forward code and its reverse complement's, the
    bases packed two bits each, first base highest;
  - depth[i] counts the windows whose k-mer is key i, over every byte of
    the stream, u32 (the program's finish() width).

The stream is a FASTQ pool replayed from its start: stream[0:T] is the
pool q times, then its first r bytes (q, r = divmod(T, len(pool))). A
record cut inside its sequence line counts the windows of the bases
before the cut, as a streaming counter that ends there does.
"""

from __future__ import annotations

import numpy as np
import torch

# byte -> code; 4 for anything that is not a base
_LUT = np.full(256, 4, np.uint8)
for _b in b"ACGTacgt":
    _LUT[_b] = (_b >> 1) & 3

# read this many bases at a time through the card (or the CPU)
BLOCK_BASES = 1 << 24


def encode(buf: np.ndarray) -> np.ndarray:
    """ASCII bytes -> codes 0..3, 4 for a non-base."""
    return _LUT[np.asarray(buf, np.uint8)]


def kmers(codes: torch.Tensor, k: int, forward_only: bool = False):
    """codes int64[R, L] (4 = not a base) -> (k-mer int64[R, L - k + 1],
    valid bool[R, L - k + 1]). forward_only skips the reverse complement
    (a control, not the count's semantics)."""
    if not 1 <= k <= 31:
        raise ValueError(f"k = {k}: the reference packs a k-mer into 62 bits")
    bad = codes >= 4
    c = torch.where(bad, torch.zeros_like(codes), codes)
    fwd = _pack(c, k)
    # windows whose k bases hold no non-base: a running count of non-bases
    zero = torch.zeros((codes.shape[0], 1), dtype=torch.int64,
                       device=codes.device)
    run = torch.cat([zero, torch.cumsum(bad.to(torch.int64), 1)], 1)
    valid = (run[:, k:] - run[:, :-k]) == 0
    if forward_only:
        return fwd, valid
    # reverse complement: complement (c ^ 2: A<->T, C<->G), reverse the
    # line, pack, and reverse the windows back
    rc = _pack(torch.flip(c ^ 2, (1,)), k).flip((1,))
    return torch.minimum(fwd, rc), valid


def _pack(c: torch.Tensor, k: int) -> torch.Tensor:
    """Forward codes of every k-window of c by doubling: the codes of
    the 2^j-windows, then k's binary digits, highest first."""
    pw = {1: c}
    j = 1
    while 2 * j <= k:
        p = pw[j]
        pw[2 * j] = (p[:, :-j] << (2 * j)) | p[:, j:]
        j *= 2
    w = c.shape[1] - k + 1
    out, done = None, 0
    for size in sorted(pw, reverse=True):
        if done + size > k:
            continue
        part = pw[size][:, done:done + w]
        out = part if out is None else (out << (2 * size)) | part
        done += size
    return out


class Keys:
    """The dictionary's keys (u64 in rank order) sorted on `device`, for
    rank lookups by binary search."""

    def __init__(self, keys: np.ndarray, device: torch.device):
        k = torch.from_numpy(np.ascontiguousarray(keys).view(np.int64))
        self.sorted, self.rank = torch.sort(k.to(device))
        self.n = len(keys)

    def ranks(self, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The rank of each code's key, or n where none matches."""
        if self.n == 0:
            return torch.full_like(codes, self.n)
        i = torch.searchsorted(self.sorted, codes).clamp_(max=self.n - 1)
        hit = valid & (self.sorted[i] == codes)
        return torch.where(hit, self.rank[i], torch.full_like(i, self.n))


def parse_fastq(buf: np.ndarray):
    """Sequence lines of a FASTQ buffer of whole four-line records:
    (start, length) int64 arrays, one a record."""
    buf = np.asarray(buf, np.uint8)
    nl = np.flatnonzero(buf == 10)
    if len(nl) % 4 or (len(buf) and buf[-1] != 10):
        raise ValueError("the pool is not whole four-line FASTQ records")
    line_start = np.concatenate([[0], nl[:-1] + 1])
    if len(nl) and not ((buf[line_start[0::4]] == ord("@")).all()
                        and (buf[line_start[2::4]] == ord("+")).all()):
        raise ValueError("a record lacks its '@' or '+' line")
    start = line_start[1::4].astype(np.int64)
    return start, nl[1::4].astype(np.int64) - start


def count_stream(pool: np.ndarray, keys: np.ndarray, k: int,
                 lengths, device: torch.device,
                 forward_only: bool = False) -> list[np.ndarray]:
    """depth u32[n_keys] of stream[0:T] for each T in `lengths`, the
    stream being `pool` replayed (see the module's docstring)."""
    pool = np.asarray(pool, np.uint8)
    size = len(pool)
    start, length = parse_fastq(pool)
    ix = Keys(keys, device)
    cuts = [divmod(int(t), size) for t in lengths]
    total = torch.zeros(ix.n + 1, dtype=torch.int64, device=device)
    prefix = [torch.zeros_like(total) for _ in cuts]
    # records wholly inside each cut's first r bytes, and the one it cuts
    whole = [int(np.searchsorted(start + length, r, side="right"))
             for _, r in cuts]
    for lo, hi, width in _blocks(length):
        rk = _ranks(_rows(pool, start[lo:hi], length[lo:hi], width), k,
                    ix, device, forward_only)
        total += torch.bincount(rk.flatten(), minlength=ix.n + 1)
        for j, w in enumerate(whole):
            if w > lo:
                prefix[j] += torch.bincount(rk[: min(w, hi) - lo].flatten(),
                                            minlength=ix.n + 1)
    out = []
    for (q, r), w, p in zip(cuts, whole, prefix):
        if w < len(start) and start[w] < r:          # the cut record
            part = int(r - start[w])
            cut = _ranks(_rows(pool, start[w:w + 1], np.array([part]), part),
                         k, ix, device, forward_only)
            p = p + torch.bincount(cut.flatten(), minlength=ix.n + 1)
        depth = total * q + p
        out.append((depth[: ix.n] & 0xFFFFFFFF).cpu().numpy()
                   .astype(np.uint32))
    return out


def _blocks(length: np.ndarray):
    """Runs of records of one sequence length, at most BLOCK_BASES
    bases each: (first, end, length)."""
    n = len(length)
    lo = 0
    while lo < n:
        width = int(length[lo])
        per = max(1, BLOCK_BASES // max(width, 1))
        hi = lo + 1
        while hi < n and hi - lo < per and length[hi] == width:
            hi += 1
        yield lo, hi, width
        lo = hi


def _rows(pool: np.ndarray, start: np.ndarray, length: np.ndarray,
          width: int) -> np.ndarray:
    """Codes of the records' sequence lines, u8[R, width] (each line
    `width` long but the cut one, padded with non-bases)."""
    idx = start[:, None] + np.arange(width)[None, :]
    inside = np.arange(width)[None, :] < length[:, None]
    codes = encode(pool[np.minimum(idx, len(pool) - 1)])
    return np.where(inside, codes, np.uint8(4)).astype(np.uint8)


def _ranks(rows: np.ndarray, k: int, ix: Keys, device: torch.device,
           forward_only: bool) -> torch.Tensor:
    """The key rank of every window of the rows (n where none), int64."""
    codes = torch.from_numpy(rows).to(device).to(torch.int64)
    if codes.shape[1] < k:
        return torch.zeros(0, dtype=torch.int64, device=device)
    code, valid = kmers(codes, k, forward_only)
    return ix.ranks(code, valid)
