"""The linear (K7) and packed (K8) engines' slot-space depth against the
JAX package's rank-space depth.

The card kernels count where the probe stops (the .qm slot, or bucket *
2 + entry), with a trash counter last, and probe a table larger than L2
slice by slice. Their plain versions take the same slot-space contract
without slicing; `slot_depth_to_rank` and `rank_depth_to_slot` carry a
depth to and from the JAX counter's rank order. Here, on the CPU:
* the slice counts at the shapes the kernels branch on (P = 1, 2, 4 and
  the smoke's), and the plain steps on tables of those shapes against
  JAX's count_step and count_step_packed_pk;
* a small max_steps that stops scans on live slots, on tables whose
  scans wrap or clamp, translated, against JAX's count_step, and a
  rank-space depth carried to slot space and back unchanged;
* a JAX DepthCounter's snapshot restored in the port and snapshot again
  (the trash lane's empty-slot stops and misses included) equal to the
  JAX snapshot, then both counters run to the same finish.
Integer outputs: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu import dictionary as jdict
from quickmer2_tpu.io import formats as jformats
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import packed_table as jpacked
from quickmer2_tpu.ops import rowpack as jrowpack
from quickmer2_tpu.pipelines import count as jcount
from quickmer2_tpu_torch import dictionary as tdict
from quickmer2_tpu_torch.device import words
from quickmer2_tpu_torch.io import formats as tformats
from quickmer2_tpu_torch.kernels import count_flat
from quickmer2_tpu_torch.ops import hash as thash
from quickmer2_tpu_torch.ops import packed_table as tpacked
from quickmer2_tpu_torch.pipelines import count as tcount
from tests.test_torch_engines import _TABLES, _dict_kmers, _packed, _reads, \
    _scan_world

CPU = torch.device("cpu")


@pytest.mark.parametrize("units,linear,packed", [
    (2, 1, 1), (1 << 19, 1, 1), (1 << 20, 1, 2), (1 << 21, 1, 4),
    (1 << 22, 2, 8), (1 << 23, 4, 16), (1 << 25, 16, 64), (1 << 31, 256, 256)])
def test_partitions_for(units, linear, packed):
    """The least power of two P whose slice of table and depth bytes (12
    B a .qm slot, 40 B a packed bucket) fits 24 MiB, at most 256."""
    assert count_flat.linear_partitions_for(units) == linear
    assert count_flat.packed_partitions_for(units) == packed


def _branch_world(k: int, seed: int):
    """A genome's k-mers as a dictionary, and a batch of reads over it
    with separators and N bases whose length is no multiple of 64."""
    g = np.random.default_rng(seed).integers(0, 4, 6000).astype(np.uint8)
    kmers = _dict_kmers(g, k)
    codes = _reads(g, seed, 60, 150)[:9013]
    return kmers, codes


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_linear_plain_matches_jax_at_branch_shapes(parts):
    """K7's plain version, translated to rank order, equals JAX's
    count_step on a .qm table of 2^21, 2^22 or 2^23 slots (P slices on
    the card)."""
    k = 31
    hash_size = 1 << (20 + parts.bit_length())
    assert count_flat.linear_partitions_for(hash_size) == parts
    kmers, codes = _branch_world(k, 300 + parts)
    jd = jdict.Dictionary.from_kmers_in_order(kmers, hash_size, k)
    td = tdict.Dictionary.from_kmers_in_order(kmers, hash_size, k)
    hi, lo, rank = jd.device_arrays()
    want = np.asarray(jcount.count_step(
        jnp.asarray(codes), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(rank), jnp.zeros(jd.n_kmers + 1, jnp.uint32), k=k,
        hash_size=hash_size))
    table = count_flat.linear_table(td, CPU)
    slots = torch.zeros(hash_size + 1, dtype=torch.int64)
    pk, bits = _packed(codes)
    count_flat.count_linear_step(pk, bits, table, slots, k=k,
                                 hash_size=hash_size, n_bases=len(codes))
    got = count_flat.slot_depth_to_rank(
        slots, count_flat.linear_rank_slots(td, CPU), td.n_kmers)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert want[:-1].sum() > 0 and want[-1] > 0


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_packed_plain_matches_jax_at_branch_shapes(parts):
    """K8's plain version, translated to rank order, equals JAX's
    count_step_packed_pk on a packed table of 2^19, 2^20 or 2^21
    buckets (P slices on the card)."""
    k = 30
    kmers, codes = _branch_world(k, 400 + parts)
    n_buckets = 1 << (18 + parts.bit_length())
    load = len(kmers) / (2 * n_buckets) * 1.01
    jd = jdict.Dictionary.from_kmers_in_order(kmers, 1 << 16, k)
    td = tdict.Dictionary.from_kmers_in_order(kmers, 1 << 16, k)
    jt = jpacked.PackedTable.from_dictionary(jd, load=load)
    tt = tpacked.PackedTable.from_dictionary(td, load=load)
    assert jt.n_buckets == tt.n_buckets == n_buckets
    assert count_flat.packed_partitions_for(n_buckets) == parts
    pk, bits = jrowpack.pack_rows(codes[None, :])
    want = np.asarray(jcount.count_step_packed_pk(
        jnp.asarray(pk), jnp.asarray(bits), jnp.asarray(jt.rows),
        jnp.zeros(jd.n_kmers + 1, jnp.uint32), k=k, n_buckets=n_buckets,
        n_bases=len(codes)))
    rows = tt.device_rows(CPU)
    slots = torch.zeros(2 * n_buckets + 1, dtype=torch.int64)
    count_flat.count_packed_step(torch.from_numpy(pk[0]),
                                 torch.from_numpy(bits[0]), rows, slots, k=k,
                                 n_buckets=n_buckets, n_bases=len(codes))
    got = count_flat.slot_depth_to_rank(
        slots, count_flat.packed_rank_slots(rows, td.n_kmers), td.n_kmers)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert want[:-1].sum() > 0 and want[-1] > 0


def _scan_dictionaries(case: str, k: int = 15):
    """The JAX and port Dictionary of a _scan_world table (chain order
    the world's rank map), and reads over its genome."""
    g, table, rank, _, _, hash_size = _scan_world(case, k)
    chain = np.argsort(rank)[:int(np.count_nonzero(table))]
    out = []
    for mod, fmt in ((jdict, jformats), (tdict, tformats)):
        out.append(mod.Dictionary(
            fmt.QmHeader(k, 0, 0, 0, hash_size, int(chain[0])), table,
            chain.astype(np.int64), rank))
    return g, out[0], out[1]


@pytest.mark.parametrize("case", sorted(_TABLES))
def test_linear_small_max_steps_round_trip(case):
    """Scans cut after 2 steps stop on live slots (every table) and on
    empty ones (the wrap and clamp tables): the plain step translated to
    rank order equals JAX's count_step at max_steps = 2, and that depth,
    carried to slot space and back, is unchanged."""
    k = 15
    g, jd, td = _scan_dictionaries(case, k)
    codes = _reads(g, 17, 60)
    H, n = td.hash_size, td.n_kmers
    hi, lo, rank = jd.device_arrays()
    want = np.asarray(jcount.count_step(
        jnp.asarray(codes), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(rank), jnp.zeros(n + 1, jnp.uint32), k=k, hash_size=H,
        max_steps=2))
    table = count_flat.linear_table(td, CPU)
    rank_slots = count_flat.linear_rank_slots(td, CPU)
    slots = torch.zeros(H + 1, dtype=torch.int64)
    pk, bits = _packed(codes)
    count_flat.count_linear_step(pk, bits, table, slots, k=k, hash_size=H,
                                 n_bases=len(codes), max_steps=2)
    got = count_flat.slot_depth_to_rank(slots, rank_slots, n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    back = count_flat.rank_depth_to_slot(words(want, CPU), rank_slots, H + 1)
    np.testing.assert_array_equal(back.numpy(), slots.numpy())
    np.testing.assert_array_equal(
        count_flat.slot_depth_to_rank(back, rank_slots, n).numpy(),
        want.astype(np.int64))
    canon, valid = jcodec.sliding_kmers_np(codes, k)
    qhi, qlo = jcodec.split_u64(canon[valid])
    idx, found = thash.probe_lookup(
        *(torch.from_numpy(a.astype(np.int64)) for a in (hi, lo, qhi, qlo)),
        H, 2)
    s = thash.slot_at(idx, H).numpy()
    assert (~found.numpy() & (jd.table[s] != 0)).any()   # cut on a live slot
    assert want[:-1].sum() > 0 and want[-1] > 0


def test_translation_wraps_u32():
    """Depth words near 2^32 translate and sum in the trash lane mod
    2^32, both ways, on a packed table with empty entries."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    td = tdict.Dictionary.from_kmers_in_order(_dict_kmers(g, 20), 1 << 14, 20)
    table = tpacked.PackedTable.from_dictionary(td)
    rows = table.device_rows(CPU)
    n, lanes = td.n_kmers, 2 * table.n_buckets + 1
    rank_slots = count_flat.packed_rank_slots(rows, n)
    depth = rng.integers(0, 1 << 32, n + 1, dtype=np.uint64).astype(np.uint32)
    depth[-1] = 0xFFFFFFF0
    slots = count_flat.rank_depth_to_slot(words(depth, CPU), rank_slots,
                                          lanes)
    assert int(slots[-1]) == 0xFFFFFFF0
    assert int((slots[:-1] != 0).sum()) == int((depth[:-1] != 0).sum())
    np.testing.assert_array_equal(
        count_flat.slot_depth_to_rank(slots, rank_slots, n).numpy(),
        depth.astype(np.int64))
    # a slot that holds no k-mer adds to the trash lane, mod 2^32
    live = torch.zeros(lanes, dtype=torch.bool)
    live[rank_slots] = True
    slots[int(torch.nonzero(~live)[0])] = 0x20
    got = count_flat.slot_depth_to_rank(slots, rank_slots, n)
    assert int(got[-1]) == 0x10


def _snapshot_round_trip(jd, td, codes, layout, batch):
    """A JAX counter's mid-stream snapshot restored in the port: the
    port's snapshot equals it, and both counters finish alike."""
    m = len(codes) // 2
    jc = jcount.DepthCounter(jd, batch_bases=batch, layout=layout)
    jc.feed_codes(codes[:m])
    js = jc.snapshot()
    tc = tcount.DepthCounter(td, batch_bases=batch, layout=layout,
                             device="cpu")
    tc.restore(js)
    ts = tc.snapshot()
    np.testing.assert_array_equal(ts["depth"], np.asarray(js["depth"]))
    np.testing.assert_array_equal(ts["residual"], js["residual"])
    assert (ts["windows"], ts["layout"]) == (js["windows"], js["layout"])
    jc.feed_codes(codes[m:])
    tc.feed_codes(codes[m:])
    np.testing.assert_array_equal(tc.finish(), jc.finish())
    return np.asarray(js["depth"])


@pytest.mark.parametrize("case", sorted(_TABLES))
def test_linear_snapshot_round_trip(case):
    """On tables whose scans wrap, clamp or run to max_steps on a live
    slot, with misses that stop on empty slots in the trash lane."""
    g, jd, td = _scan_dictionaries(case, 15)
    codes = _reads(g, 23, 120)
    depth = _snapshot_round_trip(jd, td, codes, "linear", 1 << 11)
    assert depth[:-1].sum() > 0 and depth[-1] > 0


@pytest.mark.parametrize("k", [15, 32])
def test_packed_snapshot_round_trip(k):
    g = np.random.default_rng(90 + k).integers(0, 4, 20000).astype(np.uint8)
    kmers = _dict_kmers(g, k)
    jd = jdict.Dictionary.from_kmers_in_order(kmers, 1 << 16, k)
    td = tdict.Dictionary.from_kmers_in_order(kmers, 1 << 16, k)
    depth = _snapshot_round_trip(jd, td, _reads(g, k, 400), "packed",
                                 10_007)
    assert depth[:-1].sum() > 0 and depth[-1] > 0
