"""Port Hamming join over genome windows (the anchored index's neighbor
bitmap) against the JAX package: K5's plain version on bucket runs
(its counting sort's plain version) equals one _part_chunk_join_bits
call at k = 15-17, 30 and 32, pads 4 to 240, and the cached word runs
serve every genome tile; hamming_neighbor_bits equals the JAX
one, the JAX host builder and the port's K4 sweep across chunk seams,
low-complexity tracts, planted ED1 copies and a separator, with and
without the escalation re-join; the index built by the join writes the
JAX package's .qai. u8/u32 outputs: exact equality. The whole join at
k = 31 and 32 is left to the card (the JAX layouts there are 16 M
buckets a part)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu.ops import anchored as janch
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu.ops.packed_table import PackedTable as JPackedTable
from quickmer2_tpu_torch.device import to_numpy_u32
from quickmer2_tpu_torch.kernels.hamming_join import bucket_runs, join_bits
from quickmer2_tpu_torch.ops import anchored as tanch
from quickmer2_tpu_torch.ops import hamming_join as thj
from tests.torch_threads import few_threads  # noqa: F401


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


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("k,part,cpad,cpad_q", [
    (15, 0, 8, 4), (16, 1, 16, 8), (17, 2, 8, 8), (15, 2, 40, 36),
    (15, 1, 64, 32), (16, 0, 240, 240), (30, 1, 8, 4), (30, 2, 16, 8),
    (32, 1, 8, 4), (32, 2, 16, 8)])
def test_join_bits_plain_matches_part_chunk_join_bits(k, part, cpad, cpad_q):
    """K5's plain version on bucket runs (bucket_runs' plain counting
    sort of each side) equals one _part_chunk_join_bits call on padded
    layouts. cpad + 3 words planted in a query's bucket, ahead of the
    dictionary, overrun the word pad: cpad - 2 two substitutions from
    the query, then five one substitution from it, of which the slot cap
    keeps two, in both."""
    g, dk, _ = _genome(k, k, 6000)
    rc = jhj._rc_np(dk, k)
    fwd, rcw, valid = jcodec.sliding_fwd_rc_np(g, k)
    q = np.minimum(fwd, rcw)
    qf = fwd <= rcw
    s, t = jhj.part_ranges(k)[part]
    qhi, qlo = jcodec.split_u64(q)
    qslot = np.full(len(q), 255, np.uint8)
    qslot[valid] = jhj._slots_u8(jhj._extract_part_np(qhi, qlo, s, t)[valid])
    i0 = np.flatnonzero(valid & (qslot == 0))[7]
    q0 = int(q[i0])
    outside = [p for p in range(k) if not s <= p < t]
    far = [q0 ^ (d << (2 * a)) ^ (e << (2 * b)) for a in outside
           for b in outside if a < b for d in (1, 2, 3) for e in (1, 2, 3)]
    near = [q0 ^ (d << (2 * p)) for p in outside for d in (1, 2, 3)]
    planted = np.array(far[:cpad - 2] + near[:5], np.uint64)
    w = np.concatenate([planted, dk, rc])
    live = np.concatenate([np.ones(len(planted), bool),
                           np.ones(len(dk), bool), rc != dk])
    whi, wlo = jcodec.split_u64(w)
    wkey = jhj._extract_part_np(whi, wlo, s, t)
    wslot = np.full(len(w), 255, np.uint8)
    wslot[live] = jhj._slots_u8(wkey[live])
    assert (np.bincount(wkey[live]) > cpad).any()
    B = 1 << (2 * (t - s))
    want = np.asarray(jhj._part_chunk_join_bits(
        jnp.asarray(whi), jnp.asarray(wlo), jnp.asarray(wslot),
        jnp.asarray(qhi), jnp.asarray(qlo), jnp.asarray(qf),
        jnp.asarray(qslot), jnp.zeros((len(q) + 1, 4), jnp.uint32),
        jnp.uint32(2 * s), B=B, cpad=cpad, cpad_q=cpad_q,
        slab=min(B, 4096), k=k, width=2 * (t - s)))
    part = dict(lo_bit=2 * s, width=2 * (t - s))
    runs_w = bucket_runs(_i64(whi), _i64(wlo), torch.from_numpy(wslot),
                         cap=cpad, **part)
    runs_q = bucket_runs(_i64(qhi), _i64(qlo), torch.from_numpy(qslot),
                         cap=cpad_q, fwd=torch.from_numpy(qf), **part)
    planes = torch.zeros((len(q) + 1, 4), dtype=torch.int64)
    join_bits(*runs_w, *runs_q, planes, k=k, **part)
    got = to_numpy_u32(planes)
    # row nq is the trash row: JAX adds hole lanes there, the port not
    np.testing.assert_array_equal(got[:-1], want[:-1])
    assert want[:-1].any()
    assert np.unpackbits(got[i0].view(np.uint8)).sum() == 2


def test_bucket_runs_hold_the_padded_lanes():
    """The runs are the padded layout's live lanes in lane order: entry
    i sits at offsets[key] + slot iff its slot is below the cap."""
    rng = np.random.default_rng(11)
    n, width, cap = 5000, 6, 5
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    key = (lo >> 4) & ((1 << width) - 1)
    live = rng.random(n) < 0.9
    slot = np.full(n, 255, np.uint8)
    slot[live] = jhj._slots_u8(key[live])
    fwd = rng.random(n) < 0.5
    codes, tags, off = bucket_runs(_i64(hi), _i64(lo), torch.from_numpy(slot),
                                   lo_bit=4, width=width, cap=cap,
                                   fwd=torch.from_numpy(fwd))
    off, codes, tags = (to_numpy_u32(x) for x in (off, codes, tags))
    enter = slot < cap
    assert off[-1] == enter.sum()
    np.testing.assert_array_equal(np.diff(off), np.bincount(
        key[enter], minlength=1 << width))
    at = off[key[enter]] + slot[enter]
    np.testing.assert_array_equal(codes[at, 0], hi[enter])
    np.testing.assert_array_equal(codes[at, 1], lo[enter])
    np.testing.assert_array_equal(
        tags[at], np.flatnonzero(enter) | (fwd[enter].astype(np.uint32) << 31))


def test_cached_word_runs_serve_two_tiles():
    """A _BitsWords joins two genome tiles with the word runs it built
    for the first (cached: the same tensors), and each tile's planes
    equal those of a fresh _BitsWords."""
    k = 15
    g, dk, _ = _genome(21, k, 8000)
    w = thj._BitsWords(dk, k, 6000, torch.device("cpu"))
    got, runs = [], None
    for t0 in (0, 4000):
        seg = np.ascontiguousarray(g[t0:t0 + 3000 + k - 1])
        planes = []
        for ww in (w, thj._BitsWords(dk, k, 6000, torch.device("cpu"))):
            canon, valid, is_fwd, keys_q, active, _ = ww.route_tile(seg, 8, 4)
            chi, clo, fwd = thj._device_kmerize(torch.from_numpy(seg), k)
            p = torch.zeros((len(canon) + 1, 4), dtype=torch.int64)
            ww.join(chi, clo, fwd, keys_q, active, p, 8, 4)
            planes.append(to_numpy_u32(p))
        np.testing.assert_array_equal(planes[0], planes[1])
        got.append(planes[0])
        if runs is None:
            runs = dict(w._runs)
            assert len(runs) == 3 * len(w.chunks) > 3
    assert all(w._runs[key] is v for key, v in runs.items())
    assert all(p.any() for p in got)


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
