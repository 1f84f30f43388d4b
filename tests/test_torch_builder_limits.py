"""The port's host builders refuse the inputs they cannot place, instead
of doubling without end (PackedTable.build, five or more keys sharing one
DJB hash) or running the reference probe off a full table
(Dictionary.from_kmers_in_order). Tables that built before build the
same, as the JAX package's do."""

import numpy as np
import pytest

from quickmer2_tpu import dictionary as jdict
from quickmer2_tpu.ops import packed_table as jpacked
from quickmer2_tpu_torch import dictionary as tdict
from quickmer2_tpu_torch.ops import packed_table as tpacked
from quickmer2_tpu_torch.ops.hash import djb_pair_np
from quickmer2_tpu_torch.utils import native
from tests.torch_threads import few_threads  # noqa: F401


def _shared_hash_keys(n: int, k: int = 16):
    """n distinct k-mer codes (k < 17, so hi = 0) with one DJB value. DJB
    is linear in the key's bytes, lo byte 0 first: raising byte 0 by 1
    and lowering byte 1 by 33 keeps the hash."""
    b0 = 10 + np.arange(n)
    b1 = 200 - 33 * np.arange(n)
    lo = (b0 | (b1 << 8) | (0x21 << 16) | (0x05 << 24)).astype(np.uint32)
    lo &= np.uint32((1 << (2 * k)) - 1)
    hi = np.zeros(n, np.uint32)
    h = djb_pair_np(hi, lo)
    assert len(np.unique(lo)) == n and (h == h[0]).all()
    return hi, lo


def _spread_keys(n: int, seed: int):
    rng = np.random.default_rng(seed)
    codes = np.unique(rng.integers(1, 1 << 60, 2 * n, dtype=np.int64))
    codes = codes[:n].astype(np.uint64)
    return ((codes >> np.uint64(32)).astype(np.uint32),
            codes.astype(np.uint32))


@pytest.mark.parametrize("n_shared", [5, 7])
def test_packed_table_rejects_shared_hash(n_shared):
    hi, lo = _shared_hash_keys(n_shared)
    shi, slo = _spread_keys(300, n_shared)
    hi, lo = np.concatenate([hi, shi]), np.concatenate([lo, slo])
    with pytest.raises(ValueError, match=f"{n_shared} keys share one DJB"):
        tpacked.PackedTable.build(hi, lo, np.arange(len(hi), dtype=np.uint32))


def test_packed_table_places_four_shared_keys_as_jax():
    """Four keys on one hash fill both candidate buckets: the limit
    builds, and equals the JAX package's table."""
    hi, lo = _shared_hash_keys(4)
    shi, slo = _spread_keys(300, 4)
    hi, lo = np.concatenate([hi, shi]), np.concatenate([lo, slo])
    rank = np.arange(len(hi), dtype=np.uint32)
    got = tpacked.PackedTable.build(hi, lo, rank)
    want = jpacked.PackedTable.build(hi, lo, rank)
    np.testing.assert_array_equal(got.rows, want.rows)
    assert got.n_buckets == want.n_buckets
    assert tpacked.probe_packed_np(got.rows, hi, lo, got.n_buckets).all()


def test_packed_table_stops_doubling(monkeypatch):
    """Past MAX_DOUBLINGS the build raises: eight keys at load 4 start
    in two buckets of two entries and need a doubling the cap of 0
    forbids."""
    monkeypatch.setattr(tpacked, "MAX_DOUBLINGS", 0)
    hi, lo = _spread_keys(8, 1)
    with pytest.raises(ValueError, match="not placed after 0 doublings"):
        tpacked.PackedTable.build(hi, lo, np.arange(8, dtype=np.uint32),
                                  load=4.0)


@pytest.mark.parametrize("n_keys", [64, 65, 200])
def test_dictionary_rejects_full_table(monkeypatch, n_keys):
    """As many keys as slots, or more, raise before the native insert."""
    def no_insert(*args, **kwargs):
        raise AssertionError("the insert ran")
    monkeypatch.setattr(native, "insert_keys", no_insert)
    kmers = np.arange(1, n_keys + 1, dtype=np.uint64)
    with pytest.raises(ValueError, match=f"{n_keys} keys do not fit"):
        tdict.Dictionary.from_kmers_in_order(kmers, 64, 25)


def test_dictionary_below_capacity_matches_jax():
    kmers = np.arange(1, 33, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    kmers &= np.uint64((1 << 50) - 1)
    got = tdict.Dictionary.from_kmers_in_order(kmers, 64, 25)
    want = jdict.Dictionary.from_kmers_in_order(kmers, 64, 25)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.chain_slots, want.chain_slots)


@pytest.mark.parametrize("n_keys,load", [(3000, 0.5), (4000, 0.98)])
def test_packed_table_puts_keys_at_h2_only_behind_a_full_h1(monkeypatch,
                                                           n_keys, load):
    """The block probe reads h2's row only where h1's is full: every key
    the build puts in its h2 bucket has a full h1 bucket, at the usual
    load and at one near 1, cuckoo walks included (both run some)."""
    walks = []
    evict = tpacked._cuckoo_evict

    def counted(pending, *args):
        walks.append(len(pending))
        return evict(pending, *args)
    monkeypatch.setattr(tpacked, "_cuckoo_evict", counted)
    hi, lo = _spread_keys(n_keys, n_keys)
    t = tpacked.PackedTable.build(hi, lo, np.arange(n_keys, dtype=np.uint32),
                                  load=load)
    e = t.rows.reshape(-1, 4)
    live = (e[:, 0] | e[:, 1]) != 0
    h1, _ = tpacked.bucket_hashes(djb_pair_np(e[:, 0], e[:, 1]), t.n_buckets)
    at_h2 = live & (h1 != np.arange(len(e)) // 2)
    full = live.reshape(-1, 2).all(1)
    assert at_h2.any()
    assert full[h1[at_h2].astype(np.int64)].all()
    assert sum(walks) > 0
