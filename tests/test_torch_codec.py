"""Port codec and hash against the JAX package: sliding forward/rc and
canonical (hi, lo) codes with validity, and DJB2 over (hi, lo) pairs.
Integer results, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import hash as jhash
from quickmer2_tpu_torch.device import to_numpy_u32
from quickmer2_tpu_torch.ops import codec as tcodec
from quickmer2_tpu_torch.ops import hash as thash


def _stream(seed: int, n: int) -> np.ndarray:
    """Code stream with N bases, lowercase bases and record separators."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, n)].copy()
    seq[rng.random(n) < 0.01] = ord("N")
    seq[rng.random(n) < 0.005] = ord(">")
    seq[100:140] = ord("A")            # poly-A: canonical code 0 windows
    return jcodec.encode_bases(seq)


@pytest.mark.parametrize("k", [3, 15, 16, 17, 30, 31, 32])
def test_sliding_codes_match_jax(k):
    codes = _stream(k, 1500)
    want = [np.asarray(a) for a in jcodec.sliding_fwd_rc(jnp.asarray(codes), k)]
    got = tcodec.sliding_fwd_rc(torch.from_numpy(codes), k)
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(to_numpy_u32(g), w)
    np.testing.assert_array_equal(got[4].numpy(), want[4])

    want_c = [np.asarray(a) for a in jcodec.sliding_kmers(jnp.asarray(codes), k)]
    got_c = tcodec.sliding_kmers(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(to_numpy_u32(got_c[0]), want_c[0])
    np.testing.assert_array_equal(to_numpy_u32(got_c[1]), want_c[1])
    np.testing.assert_array_equal(got_c[2].numpy(), want_c[2])
    # the host half is a copy: same canonical codes as the JAX host half
    canon, valid = tcodec.sliding_kmers_np(codes, k)
    jcanon, jvalid = jcodec.sliding_kmers_np(codes, k)
    np.testing.assert_array_equal(canon, jcanon)
    np.testing.assert_array_equal(valid, jvalid)


def test_djb_pair_matches_jax():
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    hi[:4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    lo[:4] = [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]
    want = np.asarray(jhash.djb_pair(jnp.asarray(hi), jnp.asarray(lo)))
    got = thash.djb_pair(torch.from_numpy(hi.astype(np.int64)),
                         torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(thash.djb_pair_np(hi, lo), want)
