"""The one traffic generator: a pool of FASTQ reads drawn from a genome,
from a mix's parameters (traffic/<name>.json) and the run's seed.

The record layout and the read model are a copy of bench.py::make_fastq
at commit 0be96d5, without its module globals: reads start uniformly
over the genome, carry substitutions at a fixed rate per base, and a
share of them is reverse-complemented; a record is "@<header>\\n" +
bases + "\\n+\\n" + one quality letter per base + "\\n". Every record of
a pool has one length, so the stream's layout is known without parsing.

A mix's parameters:
  read_len       bases a read
  n_reads        reads in the pool (the stream replays it from its start)
  sub_rate       substitutions a base
  revcomp_share  share of reads given as their reverse complement
  header, qual   the record's name and its quality letter
"""

from __future__ import annotations

import dataclasses

import numpy as np

# codec order A0 C1 T2 G3 -> ASCII
_BASES = np.frombuffer(b"ACTG", np.uint8)

# reads drawn a block at a time, to keep the index arrays small
_BLOCK_BASES = 1 << 24


@dataclasses.dataclass
class Pool:
    """A FASTQ pool and its layout, replayed as one endless stream."""
    data: np.ndarray        # u8[n_reads * record_len]
    read_len: int
    record_len: int
    seq_offset: int         # a record's first base, from its start
    k: int

    @property
    def n_reads(self) -> int:
        return len(self.data) // self.record_len

    def chunk(self, at: int, size: int) -> np.ndarray:
        """stream[at:at + size] (a view unless it wraps the pool)."""
        p = len(self.data)
        lo = at % p
        if lo + size <= p:
            return self.data[lo:lo + size]
        parts, left = [], size
        while left:
            take = min(left, p - lo)
            parts.append(self.data[lo:lo + take])
            left -= take
            lo = 0
        return np.concatenate(parts)

    def _bases(self, offset: int) -> np.ndarray:
        """Bases of the record cut at `offset` (0..record_len) fed."""
        return np.clip(offset - self.seq_offset, 0, self.read_len)

    def reads_started(self, n: int) -> int:
        """Reads with at least one base in stream[0:n]."""
        whole, rest = divmod(n, self.record_len)
        return whole + int(self._bases(rest) > 0)

    def bases_fed(self, n: int) -> int:
        """Read bases in stream[0:n]."""
        whole, rest = divmod(n, self.record_len)
        return whole * self.read_len + int(self._bases(rest))

    def windows_fed(self, n: int) -> int:
        """k-mer windows of the reads in stream[0:n]: a window is fed
        when its last base is."""
        whole, rest = divmod(n, self.record_len)
        per = max(self.read_len - self.k + 1, 0)
        return whole * per + max(int(self._bases(rest)) - self.k + 1, 0)


def make_pool(rng: np.random.Generator, genome: np.ndarray, mix: dict,
              k: int) -> Pool:
    """The mix's pool of reads of `genome` (codec codes), from `rng`."""
    L, n = int(mix["read_len"]), int(mix["n_reads"])
    header = b"@" + mix["header"].encode() + b"\n"
    qual = ord(mix["qual"])
    seq_at = len(header)
    rec = seq_at + L + 3 + L + 1
    blob = np.empty((n, rec), np.uint8)
    blob[:, :seq_at] = np.frombuffer(header, np.uint8)
    blob[:, seq_at + L:seq_at + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    blob[:, seq_at + L + 3:rec - 1] = qual
    blob[:, rec - 1] = ord("\n")
    starts = rng.integers(0, len(genome) - L, size=n)
    n_err = rng.binomial(n * L, float(mix["sub_rate"]))
    er = rng.integers(0, n, size=n_err)
    ec = rng.integers(0, L, size=n_err)
    shift = rng.integers(1, 4, size=n_err).astype(np.uint8)
    flip = rng.random(n) < float(mix["revcomp_share"])
    order = np.argsort(er, kind="stable")
    er, ec, shift = er[order], ec[order], shift[order]
    per = max(1, _BLOCK_BASES // L)
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        reads = genome[starts[lo:hi, None] + np.arange(L)[None, :]]
        a, b = np.searchsorted(er, [lo, hi])
        r, c = er[a:b] - lo, ec[a:b]
        reads[r, c] = (reads[r, c] + shift[a:b]) % 4
        f = flip[lo:hi]
        reads[f] = (reads[f, ::-1] + 2) % 4
        blob[lo:hi, seq_at:seq_at + L] = _BASES[reads]
    return Pool(blob.reshape(-1), L, rec, seq_at, k)
