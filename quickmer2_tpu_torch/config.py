"""Configuration dataclasses for the three pipeline phases.

Defaults mirror the reference CLI defaults (QuicKmer.c:14-25 and the
per-mode getopt blocks at 137-174, 314-333, 1103-1160, 1319-1341).
"""

from __future__ import annotations

import dataclasses


def round_up_pow2(n: int) -> int:
    """Round up to the next power of two (reference: QuicKmer.c:164, 1134)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def parse_size_suffix(s: str) -> int:
    """Parse a hash-size argument with optional K/M/G suffix, rounding up to a
    power of two — reference `-s` semantics (QuicKmer.c:1125-1136)."""
    s = s.strip()
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[s[-1].lower()]
        s = s[:-1]
    return round_up_pow2(int(s) * mult)


@dataclasses.dataclass
class SearchConfig:
    """Options of `search` (reference getopt: QuicKmer.c:1103-1160)."""

    kmer_size: int = 30            # -k
    threads: int = 1               # -t (unused; kept for CLI parity)
    hash_size: int = 0x2000000     # -s (power of 2; auto-grows in reference)
    edit_distance: int = 2         # -e in {0,1,2}
    edit_depth_threshold: int = 100  # -d
    window_size: int = 1000        # -w (k-mers per window)
    control_bed: str | None = None   # -c
    gc_window_bp: int = 400        # fixed in reference (QuicKmer.c:1280)
    # Emulate the reference's 32-bit-shift UB in the edit-distance filter
    # (SURVEY.md Q2) for bit-identical dictionary parity.
    quirk_mod32_editdist: bool = False

    def __post_init__(self):
        if not (3 <= self.kmer_size <= 32):
            raise ValueError("kmer_size must be in [3, 32]")
        if self.edit_distance not in (0, 1, 2):
            raise ValueError("edit_distance must be 0, 1, or 2")
        self.hash_size = round_up_pow2(self.hash_size)


@dataclasses.dataclass
class CountConfig:
    """Options of `count` (reference getopt: QuicKmer.c:314-333)."""

    threads: int = 1               # -t (host parser workers here)
    batch_bases: int = 1 << 24     # bases per device batch (fixed shape)
    # Reference depth counters are uint16 and wrap mod 65536 (SURVEY.md Q8).
    # We accumulate in uint32 on device; serialization wraps for parity.
    depth_dtype_bits: int = 32


@dataclasses.dataclass
class EstConfig:
    """Options of `est` (reference: QuicKmer.c:555-685)."""

    lowess_frac: float = 0.15      # smooth_GC_mrsfast.py:37
    lowess_iters: int = 3
    gc_fit_lo: int = 100           # bins 100..300 fitted (GC 25%..75%)
    gc_fit_hi: int = 300
    corr_clip_lo: float = 1.0 / 3.0  # smooth_GC_mrsfast.py:46-53
    corr_clip_hi: float = 3.0
    make_plot: bool = False
