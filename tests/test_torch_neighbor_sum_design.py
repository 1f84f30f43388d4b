"""The arithmetic of K6's design (csrc/neighbor_sum.cu), pinned to the JAX
package on the CPU.

The kernel never hashes a neighbor's bytes. It hashes the query's two
strands once; for an edit it builds both strands' codes by XOR, takes
the canonical one, and gets that code's DJB hash as the chosen strand's
hash plus one delta per substituted 2-bit field: (new - old) times the
weight of the field's byte, 33^(7 - byte) (csrc/packed_probe.cuh
kDjbWeight), shifted by the field's place in its byte. A single edit's
second field is a no-op (p2 = d2 = 0) with a zero delta. Written here in
numpy over the kernel's packed edit words, the codes equal
quickmer2_tpu.ops.editdist._neighbor_canon and the hashes
quickmer2_tpu.ops.hash.djb_pair of them, for every edit of
edit_table(k, e), at every k the byte and word seams can cut, on queries
that include code 1 and near-all-A codes. Integer outputs: exact
equality.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import editdist as jed
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu.ops import hash as jhash
from quickmer2_tpu_torch.kernels.neighbor_sum import edit_words

HEADER = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "quickmer2_tpu_torch", "csrc", "packed_probe.cuh")
U32 = np.uint64(0xFFFFFFFF)


def djb_weights() -> np.ndarray:
    """kDjbWeight as the header writes it (products of 33u), u64[8]."""
    with open(HEADER) as f:
        body = re.search(r"kDjbWeight\[8\]\s*=\s*\{([^}]*)\}",
                         f.read()).group(1)
    out = []
    for term in body.split(","):
        factors = [int(x.strip().rstrip("u")) for x in term.split("*")]
        out.append(int(np.prod(factors, dtype=object)) & 0xFFFFFFFF)
    return np.array(out, np.uint64)


def djb_np(code: np.ndarray) -> np.ndarray:
    """DJB2 mod 2^32 over the 8 little-endian bytes of u64 codes."""
    h = np.full(code.shape, 5381, np.uint64)
    for i in range(8):
        h = (h * np.uint64(33) + ((code >> np.uint64(8 * i))
                                  & np.uint64(0xFF))) & U32
    return h


def kernel_neighbors(f0: np.ndarray, r0: np.ndarray, ew: np.ndarray, k: int):
    """(canonical code, DJB hash) u64[N, M] of every (query, edit) pair,
    by the kernel's steps (csrc/neighbor_sum.cu::edit_canon)."""
    w = djb_weights()
    f0, r0 = f0[:, None], r0[:, None]
    hf, hr = djb_np(f0), djb_np(r0)
    ew = ew.astype(np.uint64)[None, :]
    p1, d1 = ew & np.uint64(63), (ew >> np.uint64(6)) & np.uint64(3)
    p2, d2 = (ew >> np.uint64(8)) & np.uint64(63), (ew >> np.uint64(14)) & 3
    two, kk = np.uint64(2), np.uint64(k - 1)
    b1, b2 = (f0 >> (two * p1)) & 3, (f0 >> (two * p2)) & 3
    n1, n2 = (b1 + d1) & np.uint64(3), (b2 + d2) & np.uint64(3)
    s1, s2 = two * (kk - p1), two * (kk - p2)
    x1, x2 = b1 ^ n1, b2 ^ n2
    f = f0 ^ (x1 << (two * p1)) ^ (x2 << (two * p2))
    r = r0 ^ (x1 << s1) ^ (x2 << s2)
    use_f = f <= r
    c = np.where(use_f, np.uint64(0), two)

    def delta(sh, old, new):
        weight = (w[(sh >> np.uint64(3)).astype(np.int64)]
                  << (sh & np.uint64(7))) & U32
        return ((new - old) & U32) * weight & U32

    h = (np.where(use_f, hf, hr)
         + delta(np.where(use_f, two * p1, s1), b1 ^ c, n1 ^ c)
         + delta(np.where(use_f, two * p2, s2), b2 ^ c, n2 ^ c)) & U32
    return np.where(use_f, f, r), h


def _queries(k: int, seed: int) -> np.ndarray:
    """Canonical codes: random ones, code 1, and near-all-A codes (one or
    two non-A bases, at the ends and at the byte and word seams)."""
    rng = np.random.default_rng(seed)
    top = np.uint64((1 << (2 * k)) - 1)
    rand = (rng.integers(0, 1 << 62, 24, dtype=np.int64).astype(np.uint64)
            & top)
    spots = sorted({0, 1, 3, 4, 15, 16, k // 2, k - 2, k - 1} & set(range(k)))
    near_a = [np.uint64(b) << np.uint64(2 * p) for p in spots
              for b in (1, 2, 3)]
    near_a += [(np.uint64(1) << np.uint64(2 * p)) | np.uint64(3)
               for p in spots if p]
    q = np.concatenate([rand, np.array([1], np.uint64),
                        np.array(near_a, np.uint64)])
    return np.unique(np.minimum(q, jhj._rc_np(q, k)))


def _jax_neighbors(*args, k: int):
    """JAX: every (query, edit) pair's canonical code and its DJB hash."""
    chi, clo = jed._neighbor_canon(*args, k)
    return chi, clo, jhash.djb_pair(chi, clo)


_jax_neighbors = jax.jit(_jax_neighbors, static_argnames="k")


@pytest.mark.parametrize("e", [1, 2])
@pytest.mark.parametrize("k", [3, 15, 16, 17, 30, 31, 32])
def test_hash_by_deltas_matches_jax(k, e):
    q = _queries(k, 700 + k)
    rc = jhj._rc_np(q, k)
    code, h = kernel_neighbors(q, rc, edit_words(k, e), k)
    halves = jcodec.split_u64(q) + jcodec.split_u64(rc)
    chi, clo, want_h = (np.asarray(a) for a in _jax_neighbors(
        *(jnp.asarray(a) for a in halves + jed.edit_table(k, e)), k=k))
    want_code = jcodec.join_u64(chi, clo)
    np.testing.assert_array_equal(code.reshape(-1), want_code)
    np.testing.assert_array_equal(h.reshape(-1),
                                  want_h.astype(np.uint64))
    assert 1 in q and (code == 0).any()      # code 1's neighbor 0
