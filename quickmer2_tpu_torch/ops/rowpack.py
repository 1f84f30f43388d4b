"""2-bit row packing for host→device read transfer.

The count path moves every read byte across PCIe once. Read rows are u8
codes in {0..3, SEP}; their information content is 2 bits/base plus a
sparse validity mask, so packing before the copy cuts link traffic
~2.7x. The unpack reproduces the row matrix exactly, so counting results
are bit-identical with packing on or off.

Layout per batch of rows u8[R, L] (the JAX package's, so packed batches
interoperate):
  codes  u8[R, ceil(L/4)] — 4 bases/byte, little-endian 2-bit lanes
                            (SEP positions carry 0; restored from mask)
  invalid u8[R, ceil(L/8)] — bit i of byte j = 1 where row[8j+i] is
                            not an ACGT code (SEP padding / N bases)

A second, narrower format ("lens") serves suffix-padded rows, the
shape uniform-length FASTQ gives: a u16 length per row replaces the
bitmask. `pack_batch` picks the narrowest exact format for a batch.

On the card the kernels (csrc/count_mono.cu, csrc/anchored.cu) unpack
these lanes in their own loads; `unpack_rows`, `unpack_rows_lens` and
`unpack_batch` are the plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from quickmer2_tpu_torch.ops.codec import SEP


def pack_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side pack: u8[R, L] codes → (codes u8[R, ceil(L/4)],
    invalid u8[R, ceil(L/8)])."""
    rows = np.asarray(rows, np.uint8)
    R, L = rows.shape
    L8 = -(-L // 8) * 8
    inval = rows >= 4
    packed = pack_codes(rows)
    iv = inval
    if L8 != L:
        # padding beyond L is invalid by definition
        iv = np.pad(inval, ((0, 0), (0, L8 - L)), constant_values=True)
    bits = np.zeros((R, L8 // 8), np.uint8)
    for i in range(8):
        bits |= iv[:, i::8].astype(np.uint8) << i
    return packed, bits


def pack_codes(rows: np.ndarray) -> np.ndarray:
    """u8[R, ceil(L/4)] 2-bit code lanes (invalid positions carry 0)."""
    rows = np.asarray(rows, np.uint8)
    L = rows.shape[1]
    L4 = -(-L // 4) * 4
    c = np.where(rows >= 4, 0, rows).astype(np.uint8)
    if L4 != L:
        c = np.pad(c, ((0, 0), (0, L4 - L)))
    return (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
            | (c[:, 3::4] << 6))


def unpack_rows(packed: torch.Tensor, invalid: torch.Tensor, *,
                read_len: int) -> torch.Tensor:
    """Plain PyTorch unpack: exact inverse of pack_rows (SEP restored at
    invalid positions). Returns u8[R, read_len]."""
    j = torch.arange(read_len, device=packed.device)
    codes = (packed[:, j >> 2].to(torch.int64) >> ((j & 3) * 2)) & 3
    inval = (invalid[:, j >> 3].to(torch.int64) >> (j & 7)) & 1
    return torch.where(inval != 0, int(SEP), codes).to(torch.uint8)


def row_suffix_lens(rows: np.ndarray) -> np.ndarray | None:
    """u16 lengths if every row's invalid set is a pure suffix, else
    None (some row has an interior invalid code)."""
    rows = np.asarray(rows, np.uint8)
    R, L = rows.shape
    inval = rows >= 4
    n_inval = inval.sum(axis=1)
    first = np.where(n_inval > 0, np.argmax(inval, axis=1), L)
    if not (n_inval == L - first).all():
        return None
    return first.astype(np.uint16)


def unpack_rows_lens(packed: torch.Tensor, lens: torch.Tensor, *,
                     read_len: int) -> torch.Tensor:
    """Plain PyTorch unpack of the lens format: SEP at positions >= len.
    lens: the u16 lengths as an int16 or wider integer tensor."""
    j = torch.arange(read_len, device=packed.device)
    codes = (packed[:, j >> 2].to(torch.int64) >> ((j & 3) * 2)) & 3
    n = lens.to(torch.int64) & 0xFFFF
    return torch.where(j[None, :] >= n[:, None], int(SEP),
                       codes).to(torch.uint8)


def pack_batch(rows: np.ndarray):
    """Choose the narrowest exact format for a batch: ("lens", codes,
    lens u16[R]) when every row is suffix-padded, else ("mask", codes,
    invalid_bits)."""
    lens = row_suffix_lens(rows)
    if lens is not None:
        return "lens", pack_codes(rows), lens
    packed, bits = pack_rows(rows)
    return "mask", packed, bits


def aux_layout(fmt: str, n_rows: int, read_len: int):
    """(shape, dtype) of the aux tensor of a packed batch: u16 lengths
    ride as int16, bitmasks as u8 rows of ceil(read_len/8) bytes."""
    if fmt == "lens":
        return (n_rows,), torch.int16
    return (n_rows, -(-read_len // 8)), torch.uint8


def aux_tensor(fmt: str, aux: np.ndarray) -> torch.Tensor:
    """Host aux array of pack_batch → CPU tensor: u16 lengths ride as
    int16 (torch has no uint16 arithmetic on the CPU), bitmasks as u8."""
    if fmt == "lens":
        return torch.from_numpy(np.ascontiguousarray(aux, np.uint16)
                                .view(np.int16))
    return torch.from_numpy(np.ascontiguousarray(aux, np.uint8))


def unpack_batch(fmt: str, packed: torch.Tensor, aux: torch.Tensor, *,
                 read_len: int) -> torch.Tensor:
    """Plain PyTorch dispatcher for pack_batch output."""
    if fmt == "lens":
        return unpack_rows_lens(packed, aux, read_len=read_len)
    return unpack_rows(packed, aux, read_len=read_len)
