"""The plain reference against a brute-force count on tiny inputs."""

import numpy as np
import pytest
import torch

from qmbench import reference, traffic


def brute_kmer(window):
    """Canonical code of a window of codes 0..3, base by base."""
    f = r = 0
    for j, c in enumerate(window):
        f = (f << 2) | c
        r |= (c ^ 2) << (2 * j)
    return min(f, r)


def brute_depth(stream: bytes, keys: np.ndarray, k: int) -> np.ndarray:
    """Depth of every key over the sequence lines (line 2 of each four)
    of a FASTQ stream, possibly cut anywhere."""
    at = {int(x): i for i, x in enumerate(keys)}
    depth = np.zeros(len(keys), np.int64)
    for li, line in enumerate(stream.split(b"\n")):
        if li % 4 != 1:
            continue
        codes = [(b >> 1) & 3 if b in b"ACGTacgt" else 4 for b in line]
        for i in range(len(codes) - k + 1):
            w = codes[i:i + k]
            if max(w) < 4 and brute_kmer(w) in at:
                depth[at[brute_kmer(w)]] += 1
    return depth


def random_pool(rng, n):
    recs = []
    for i in range(n):
        length = int(rng.integers(0, 24))
        seq = bytes(rng.choice(list(b"ACGTacgtN"), size=length,
                               p=[.2, .2, .2, .2, .04, .04, .04, .04, .04]))
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * length))
    return b"".join(recs)


@pytest.mark.parametrize("seed", range(6))
def test_count_stream_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    k = 7
    pool = random_pool(rng, int(rng.integers(1, 14)))
    seen = set()
    for line in pool.split(b"\n")[1::4]:
        codes = [(b >> 1) & 3 if b in b"ACGTacgt" else 4 for b in line]
        for i in range(len(codes) - k + 1):
            if max(codes[i:i + k]) < 4:
                seen.add(brute_kmer(codes[i:i + k]))
    keys = sorted(x for x in seen if rng.random() < 0.6)
    keys += [int(x) for x in rng.integers(0, 4 ** k, 5)]
    keys = np.array(sorted(set(keys)), np.uint64)
    rng.shuffle(keys)
    lengths = [int(x) for x in rng.integers(0, 4 * len(pool) + 1, 5)]
    lengths += [len(pool), 3 * len(pool)]
    got = reference.count_stream(np.frombuffer(pool, np.uint8), keys, k,
                                 lengths, torch.device("cpu"))
    for t, depth in zip(lengths, got):
        stream = (pool * (t // len(pool) + 1))[:t]
        assert (depth == brute_depth(stream, keys, k)).all(), t


@pytest.mark.parametrize("k", [1, 2, 5, 16, 30, 31])
def test_kmers_match_brute_force(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, size=(3, 40))
    got, valid = reference.kmers(torch.from_numpy(codes), k)
    for r in range(3):
        for i in range(40 - k + 1):
            w = [int(c) for c in codes[r, i:i + k]]
            assert bool(valid[r, i]) == (max(w) < 4)
            if max(w) < 4:
                assert int(got[r, i]) == brute_kmer(w)


def test_generated_pool_parses_to_its_layout():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 5000).astype(np.uint8)
    mix = {"read_len": 150, "n_reads": 40, "sub_rate": 0.01,
           "revcomp_share": 0.5, "header": "r", "qual": "I"}
    pool = traffic.make_pool(rng, g, mix, k=30)
    start, length = reference.parse_fastq(pool.data)
    assert (length == 150).all()
    assert (start == np.arange(40) * pool.record_len + pool.seq_offset).all()
    assert pool.windows_fed(len(pool.data)) == 40 * 121
    cut = 3 * pool.record_len + pool.seq_offset + 40
    assert pool.windows_fed(cut) == 3 * 121 + 11
    assert pool.reads_started(cut) == 4
    assert pool.bases_fed(cut) == 3 * 150 + 40


def test_pool_is_the_seeds():
    g = np.random.default_rng(0).integers(0, 4, 5000).astype(np.uint8)
    mix = {"read_len": 150, "n_reads": 30, "sub_rate": 0.003,
           "revcomp_share": 0.5, "header": "r", "qual": "I"}
    a = traffic.make_pool(np.random.default_rng(2**31 + 9), g, mix, 30)
    b = traffic.make_pool(np.random.default_rng(2**31 + 9), g, mix, 30)
    c = traffic.make_pool(np.random.default_rng(2**31 + 10), g, mix, 30)
    assert (a.data == b.data).all() and not (a.data == c.data).all()
