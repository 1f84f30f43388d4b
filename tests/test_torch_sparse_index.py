"""The port's host subcommands against the JAX package, byte for byte:
`sparse` (thin 1 and 50: .rqm, regenerated .bed and .qgc), `index`
(k = 30, the k = 15 rc-register quirk, duplicate rows), `colortrack`,
`colorkey` and `est --plot`'s PNG name, each package on its own copy of
the inputs."""

import os
import shutil

import numpy as np
import pytest

from quickmer2_tpu.analytics import colortrack as jcolortrack
from quickmer2_tpu.config import SearchConfig as JaxSearchConfig
from quickmer2_tpu.pipelines import index as jindex
from quickmer2_tpu.pipelines import search as jsearch
from quickmer2_tpu.pipelines import sparse as jsparse
from quickmer2_tpu_torch.analytics import colortrack
from quickmer2_tpu_torch.pipelines import index, sparse
from quickmer2_tpu_torch.utils import native
from tests import helpers

K = 30


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    """A two-chromosome genome with an N run, its dictionary (the JAX
    search at -e 0) and a control bed that ends on another chromosome."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("sparse")
    chr1 = (helpers.random_genome(rng, 12000) + "N" * 30
            + helpers.random_genome(rng, 6000))
    chr2 = helpers.random_genome(rng, 5000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1, "c2": chr2})
    ctrl = str(d / "ctrl.bed")
    with open(ctrl, "w") as f:
        f.write("c1\t100\t15000\nc2\t0\t4000\nc9\t0\t10\n")
    jsearch.run_search(fa, JaxSearchConfig(
        kmer_size=K, hash_size=1 << 16, edit_distance=0, window_size=100,
        control_bed=ctrl), verbose=False)
    return {"fa": fa, "ctrl": ctrl}


def _copy(g, d):
    os.makedirs(d)
    for ext in (".qm", ""):
        shutil.copy(g["fa"] + ext, os.path.join(d, "g.fa" + ext))
    return os.path.join(d, "g.fa")


@pytest.mark.parametrize("thin", [1, 50])
def test_sparse_matches_jax(searched, thin, tmp_path):
    outs = []
    for name, run in (("jax", jsparse.run_sparse),
                      ("port", sparse.run_sparse)):
        fa = _copy(searched, str(tmp_path / name))
        kw = {"device": "cpu"} if name == "port" else {}
        dic = run(fa, thin, window_size=40, control_bed=searched["ctrl"],
                  verbose=False, **kw)
        outs.append((fa, dic))
    (jfa, jdic), (pfa, pdic) = outs
    assert vars(pdic.header) == vars(jdic.header)
    np.testing.assert_array_equal(pdic.kmers_in_order, jdic.kmers_in_order)
    for ext in (".rqm", ".bed", ".qgc"):
        with open(jfa + ext, "rb") as a, open(pfa + ext, "rb") as b:
            assert a.read() == b.read(), ext
    n_qm = len(jdic.kmers_in_order)
    assert (n_qm > 5000) if thin == 1 else (0 < n_qm < 800)


def test_thin_hits_matches_host_fallback():
    rng = np.random.default_rng(2)
    bp = np.cumsum(rng.integers(0, 90, 5000)).astype(np.uint32)
    for thin in (1, 50, 333):
        np.testing.assert_array_equal(native.thin_hits(bp, thin),
                                      sparse.thin_keep_mask_np(bp, thin))


def _kmer_bed(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"c1\t{i}\t{i + len(s)}\t{s}\n")


@pytest.mark.parametrize("k,dups", [(30, False), (15, False), (30, True)])
def test_index_matches_jax(tmp_path, k, dups):
    """run_index with -s 64K: the .qm bytes of the JAX package's, at
    k = 30, at k = 15 (the <<60 rc-register quirk) and with duplicate
    rows (each its own slot and chain position)."""
    rng = np.random.default_rng(k + dups)
    seqs = [helpers.random_genome(rng, k) for _ in range(300)]
    if dups:
        seqs += [seqs[5], seqs[17], seqs[5]]
    bed = str(tmp_path / "kmers.bed")
    _kmer_bed(bed, seqs)
    jdic = jindex.run_index(bed, str(tmp_path / "jax.qm"),
                            hash_size=1 << 16, verbose=False)
    pdic = index.run_index(bed, str(tmp_path / "port.qm"),
                           hash_size=1 << 16, verbose=False, device="cpu")
    with open(str(tmp_path / "jax.qm"), "rb") as a, \
            open(str(tmp_path / "port.qm"), "rb") as b:
        assert a.read() == b.read()
    assert pdic.n_kmers == jdic.n_kmers == len(seqs)
    assert pdic.kmer_size == k
    # the host fallback places the keys in the same slots
    table = np.zeros(1 << 16, np.uint64)
    keys = np.array([index.encode_kmer_ref(s) for s in seqs], np.uint64)
    np.testing.assert_array_equal(index._insert_dup_np(table, keys, 1 << 16),
                                  pdic.chain_slots)


def test_encode_kmer_ref_matches_jax():
    rng = np.random.default_rng(4)
    for k in (3, 15, 29, 30, 31, 32):
        for _ in range(20):
            s = helpers.random_genome(rng, k)
            assert index.encode_kmer_ref(s) == jindex.encode_kmer_ref(s)


def _cn_bed(path):
    """CN values across every color, halves for banker's rounding, runs
    of one color to merge, a gap and a chromosome change."""
    cns = [0.2, 0.5, 1.5, 2.5, 2.4, 2.6, 3.49, 3.5, 4.5, 5.5, 6.5, 7.5, 8.5,
           9.5, 10.5, 42.0, -1.0, 2.0, 2.0]
    rows, b = [], 0
    for i, cn in enumerate(cns):
        e = b + 1000
        chrom = "chr1" if i < 12 else "chr2"
        rows.append(f"{chrom}\t{b}\t{e}\t{cn}\n")
        b = e + (500 if i == 6 else 0)
    with open(path, "w") as f:
        f.writelines(rows)


def test_colortrack_and_colorkey_match_jax(tmp_path):
    bed = str(tmp_path / "s.CN.bed")
    _cn_bed(bed)
    jout = jcolortrack.make_colortrack(bed, "smp", str(tmp_path / "j.bed9"))
    pout = colortrack.make_colortrack(bed, "smp", str(tmp_path / "p.bed9"))
    with open(jout, "rb") as a, open(pout, "rb") as b:
        assert a.read() == b.read()
    assert colortrack.make_colortrack(bed, "smp") == bed + ".bedColor"
    jkey = jcolortrack.write_color_key(str(tmp_path / "jkey.bed"))
    pkey = colortrack.write_color_key(str(tmp_path / "pkey.bed"))
    with open(jkey, "rb") as a, open(pkey, "rb") as b:
        assert a.read() == b.read()


def test_est_plot_writes_jax_png_name(tmp_path):
    """`est --plot --device cpu` writes the PNG that the JAX CLI writes,
    under the same name."""
    pytest.importorskip("matplotlib")
    from quickmer2_tpu.cli import main as jax_main
    from quickmer2_tpu_torch.cli import main
    from tests.test_torch_est_device import _est_files
    names = []
    for name, run, extra in (("jax", jax_main, []),
                             ("port", main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        os.makedirs(d)
        prefix, smp = _est_files(d, np.random.default_rng(9))
        assert run(["est", "--plot", "--json", *extra, prefix, smp,
                    os.path.join(d, "cn.bed")]) == 0
        names.append(sorted(f for f in os.listdir(d) if f.endswith(".png")))
    assert names[0] == names[1] == ["smp.png"]
