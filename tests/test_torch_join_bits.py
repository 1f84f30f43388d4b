"""Port Hamming join over genome windows (the anchored index's neighbor
bitmap) against the JAX package: K5's plain version equals one
_part_chunk_join_bits call, and hamming_neighbor_bits equals the JAX
one, the JAX host builder and the port's K4 sweep across chunk seams,
low-complexity tracts, planted ED1 copies and a separator, with and
without the escalation re-join; the index built by the join writes the
JAX package's .qai. u8/u32 outputs: exact equality. k = 31 and 32 are
left to the card (the JAX layouts there are 16 M buckets a part)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu.ops import anchored as janch
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu.ops.packed_table import PackedTable as JPackedTable
from quickmer2_tpu_torch.device import to_numpy_u32
from quickmer2_tpu_torch.kernels.hamming_join import join_bits
from quickmer2_tpu_torch.ops import anchored as tanch
from quickmer2_tpu_torch.ops import hamming_join as thj


def _genome(seed: int, k: int, n: int):
    """Random codes with a poly-A tract and a dinucleotide repeat (bucket
    overflow), one-substitution copies of random windows planted
    elsewhere (neighbor hits) and a separator; the dictionary is its
    once-occurring canonical k-mers in genome order."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=n).astype(np.uint8)
    g[n // 8: n // 8 + 300] = 0
    g[n // 4: n // 4 + 200] = np.tile([0, 1], 100)
    for _ in range(n // 400):
        src, dst = (int(x) for x in rng.integers(0, n - k, 2))
        win = g[src:src + k].copy()
        p = int(rng.integers(0, k))
        win[p] = (win[p] + int(rng.integers(1, 4))) % 4
        g[dst:dst + k] = win
    g[n // 2] = jcodec.SEP
    canon, valid = jcodec.sliding_kmers_np(g, k)
    valid &= canon != 0
    km = canon[valid]
    u, c = np.unique(km, return_counts=True)
    keep = ~np.isin(km, u[c > 1])
    return g, km[keep], (np.flatnonzero(valid)[keep] + k - 1).astype(np.uint32)


@pytest.mark.parametrize("k,part,cpad,cpad_q", [(15, 0, 8, 4), (16, 1, 16, 8),
                                                (17, 2, 8, 8), (15, 2, 40, 36)])
def test_join_bits_plain_matches_part_chunk_join_bits(k, part, cpad, cpad_q):
    g, dk, _ = _genome(k, k, 6000)
    rc = jhj._rc_np(dk, k)
    w = np.concatenate([dk, rc])
    live = np.concatenate([np.ones(len(dk), bool), rc != dk])
    fwd, rcw, valid = jcodec.sliding_fwd_rc_np(g, k)
    q = np.minimum(fwd, rcw)
    qf = fwd <= rcw
    whi, wlo = jcodec.split_u64(w)
    qhi, qlo = jcodec.split_u64(q)
    s, t = jhj.part_ranges(k)[part]
    wslot = np.full(len(w), 255, np.uint8)
    wslot[live] = jhj._slots_u8(jhj._extract_part_np(whi, wlo, s, t)[live])
    qslot = np.full(len(q), 255, np.uint8)
    qslot[valid] = jhj._slots_u8(jhj._extract_part_np(qhi, qlo, s, t)[valid])
    B = 1 << (2 * (t - s))
    want = np.asarray(jhj._part_chunk_join_bits(
        jnp.asarray(whi), jnp.asarray(wlo), jnp.asarray(wslot),
        jnp.asarray(qhi), jnp.asarray(qlo), jnp.asarray(qf),
        jnp.asarray(qslot), jnp.zeros((len(q) + 1, 4), jnp.uint32),
        jnp.uint32(2 * s), B=B, cpad=cpad, cpad_q=cpad_q, slab=min(B, 64),
        k=k, width=2 * (t - s)))

    def i64(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))
    dh, dl, dlive, qh, ql, qidx, qfw = thj._bucket_layouts(
        i64(whi), i64(wlo), torch.from_numpy(live.astype(np.uint8)),
        torch.from_numpy(wslot), i64(qhi), i64(qlo), torch.from_numpy(qslot),
        lo_bit=2 * s, width=2 * (t - s), n_buckets=B, cpad=cpad,
        cpad_q=cpad_q, qfwd=torch.from_numpy(qf))
    planes = torch.zeros((len(q) + 1, 4), dtype=torch.int64)
    join_bits(dh, dl, dlive, qh, ql, qfw, qidx, planes, k=k, n_buckets=B,
              cpad=cpad, cpad_q=cpad_q)
    got = to_numpy_u32(planes)
    # row nq is the trash row: JAX adds hole lanes there, the port not
    np.testing.assert_array_equal(got[:-1], want[:-1])
    assert want[:-1].any()


@pytest.mark.parametrize("k,cpad,cpad_q,chunk_q", [(15, 64, 32, 5_000),
                                                   (15, 6, 3, 2_500),
                                                   (30, 8, 4, 7_000)])
def test_neighbor_bits_join_matches_jax_and_builders(k, cpad, cpad_q,
                                                     chunk_q):
    """Tiles smaller than the genome put chunk seams inside it; the small
    pads send whole tracts to the host enumeration."""
    g, dk, _ = _genome(100 + k, k, 12_000)
    want = jhj.hamming_neighbor_bits(g, dk, k, cpad=cpad, cpad_q=cpad_q,
                                     chunk_q=chunk_q, escalate=False)
    stats = {}
    got = thj.hamming_neighbor_bits(g, dk, k, cpad=cpad, cpad_q=cpad_q,
                                    chunk_q=chunk_q, escalate=False,
                                    device="cpu", stats=stats)
    np.testing.assert_array_equal(got, want)
    khi, klo = jcodec.split_u64(dk)
    table = JPackedTable.build(khi, klo, np.arange(len(dk), dtype=np.uint32))
    np.testing.assert_array_equal(
        want, janch.build_neighbor_bits(g, table.rows, table.n_buckets, k))
    rows = torch.from_numpy(table.rows.astype(np.int64))
    np.testing.assert_array_equal(got, tanch.build_neighbor_bits_device(
        g, rows, table.n_buckets, k, chunk=3_000))
    assert (got != 0).sum() > 50
    assert stats["n_slow"] > 0 and stats["n_host"] == stats["n_slow"]


@pytest.mark.parametrize("escalate_min", [0, 10 ** 9])
def test_neighbor_bits_escalation(escalate_min):
    """At k = 15 the 240-wide re-join is small enough for the CPU: with it
    (escalate_min 0) and without it the bytes equal the JAX package's."""
    k = 15
    g, dk, _ = _genome(7, k, 6_000)
    kw = dict(cpad=4, cpad_q=2, chunk_q=6_000, escalate=True,
              escalate_min=escalate_min)
    want = jhj.hamming_neighbor_bits(g, dk, k, **kw)
    stats = {}
    got = thj.hamming_neighbor_bits(g, dk, k, device="cpu", stats=stats, **kw)
    np.testing.assert_array_equal(got, want)
    if escalate_min == 0:
        assert stats["n_escalated"] == stats["n_slow"] > stats["n_host"]
    else:
        assert stats["n_escalated"] == 0


def test_index_built_by_join_writes_jax_qai(tmp_path, monkeypatch):
    """AnchoredIndex.build with the join (K5's plain version, taken where
    the device type is in JOIN_BITS_DEVICES) writes the .qai of the JAX
    package's join build, byte for byte, and the same tiles as the
    port's host and sweep builders."""
    k = 15
    g, dk, pos = _genome(3, k, 12_000)
    jq = str(tmp_path / "jax.qai")
    janch.AnchoredIndex.build(g, pos, dk, k, device_build=True, cache_path=jq)
    joins = []
    real = thj.hamming_neighbor_bits
    monkeypatch.setattr(thj, "hamming_neighbor_bits",
                        lambda *a, **kw: joins.append(1) or real(*a, **kw))
    tiles = {}
    for builder, join_on in (("join", ("cpu",)), ("host", ()),
                             ("sweep", ())):
        monkeypatch.setattr(tanch, "JOIN_BITS_DEVICES", join_on)
        tq = str(tmp_path / f"{builder}.qai")
        idx = tanch.AnchoredIndex.build(g, pos, dk, k,
                                        device_build=builder != "host",
                                        cache_path=tq, device="cpu")
        tiles[builder] = idx.genome_tiles.numpy()
        with open(tq, "rb") as f, open(jq, "rb") as h:
            assert f.read() == h.read(), builder
    assert len(joins) == 1
    assert (tiles["join"] >> 3).any()
