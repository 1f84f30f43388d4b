"""Frozen copy of tools/realistic_genome.py at commit 0be96d5 (make_genome
and its helpers).

The benchmark's genomes come from this copy, so a later change to the
repository's generator cannot move a configuration's reference.

Synthetic genome with the structure that drives the count's costs:
interspersed repeat families with per-copy divergence (non-unique
k-mers, dense one- and two-substitution neighborhoods), GC isochores,
microsatellite and low-complexity tracts (anchor ambiguity, crowded
hash buckets), and an optional segmental duplication at a known copy
number.

Composition targets loosely follow mammalian statistics: ~45%
interspersed repeats (SINE ~300 bp / LINE ~6 kb / LTR ~1.5 kb with
5-20% divergence), ~3% microsatellite, GC 35-55% varying over ~100 kb
isochores. The code below the docstring is the original's, unchanged.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def _markov_seq(rng, n, gc):
    """Base stream with the target GC; light order-1 structure (CpG
    depletion-ish) via a transition bias."""
    p = np.array([(1 - gc) / 2, gc / 2, (1 - gc) / 2, gc / 2])
    out = rng.choice(4, size=n, p=p).astype(np.uint8)
    # deplete CG dinucleotides ~5x (the classic mammalian signal)
    cg = np.flatnonzero((out[:-1] == 1) & (out[1:] == 3))
    kill = cg[rng.random(len(cg)) < 0.8]
    out[kill + 1] = 0  # C followed by A instead of G
    return out


def _mutate(rng, seq, rate):
    m = seq.copy()
    pos = np.flatnonzero(rng.random(len(m)) < rate)
    m[pos] = (m[pos] + rng.integers(1, 4, size=len(pos))) % 4
    return m


def make_genome(rng, n_bases: int, dup_len: int = 0, dup_copies: int = 0):
    """Returns (codes u8[~n_bases], dup_start, dup_len). The segmental
    duplication (if requested) appears dup_copies EXTRA times, so its
    true copy number is 2*(1+dup_copies) in a diploid interpretation."""
    # repeat family consensi
    sine = _markov_seq(rng, 300, 0.52)
    line = _markov_seq(rng, 6000, 0.40)
    ltr = _markov_seq(rng, 1500, 0.47)
    micro_units = [b"A", b"AT", b"CA", b"AAG", b"GATA"]

    parts = []
    total = 0
    iso_gc = 0.45
    while total < n_bases:
        r = rng.random()
        if r < 0.28:                       # SINE copy, 5-20% diverged
            parts.append(_mutate(rng, sine, rng.uniform(0.05, 0.20)))
        elif r < 0.36:                     # LINE (often truncated)
            ln = int(rng.integers(500, 6000))
            parts.append(_mutate(rng, line[:ln], rng.uniform(0.05, 0.20)))
        elif r < 0.42:                     # LTR
            parts.append(_mutate(rng, ltr, rng.uniform(0.03, 0.15)))
        elif r < 0.45:                     # microsatellite tract
            u = micro_units[rng.integers(0, len(micro_units))]
            unit = np.frombuffer(u, np.uint8)
            unit = np.searchsorted(BASES, unit)  # ACGT -> 0..3? (A0 C1 G2 T3)
            unit = np.array([{0: 0, 1: 1, 2: 3, 3: 2}[int(x)] for x in unit],
                            np.uint8)  # to codec order A0 C1 T2 G3
            reps = int(rng.integers(20, 200))
            parts.append(np.tile(unit, reps))
        else:                              # unique sequence, isochore GC
            iso_gc = float(np.clip(iso_gc + rng.normal(0, 0.02), 0.35, 0.55))
            ln = int(rng.integers(2000, 20000))
            parts.append(_markov_seq(rng, ln, iso_gc))
        total += len(parts[-1])
    g = np.concatenate(parts)[:n_bases]

    dup_start = 0
    if dup_len and dup_copies:
        dup_start = n_bases // 3
        dup = g[dup_start:dup_start + dup_len].copy()
        tail_at = 2 * n_bases // 3
        insert = [g[:tail_at]]
        for _ in range(dup_copies):
            insert.append(dup)
        insert.append(g[tail_at:])
        g = np.concatenate(insert)
    return g, dup_start, dup_len

