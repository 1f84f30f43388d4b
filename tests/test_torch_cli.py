"""The port's CLI for the subcommands and options of its last one-card
slice, against the JAX CLI on the same inputs: `search --emit-devices
1`, `sparse`, `index`, `colortrack` and `colorkey` write the JAX CLI's
bytes (run with `--device cpu` where they take it), and so do the
multi-device options (`--emit-devices 2`, `--data-devices`,
`--dict-devices`) on a mesh of CPU copies, and `search --profile` (each
CLI writing its trace beside them)."""

import glob
import os
import shutil

import numpy as np
import pytest

from quickmer2_tpu.cli import main as jax_main
from quickmer2_tpu_torch.cli import main
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    rng = np.random.default_rng(21)
    d = tmp_path_factory.mktemp("cli")
    rep = helpers.random_genome(rng, 600)
    chroms = {"c1": helpers.random_genome(rng, 7000) + rep + "N" * 12
              + helpers.random_genome(rng, 3000) + rep,
              "c2": helpers.random_genome(rng, 4000)}
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, chroms)
    ctrl = str(d / "ctrl.bed")
    with open(ctrl, "w") as f:
        f.write("c1\t50\t6000\nc2\t0\t3000\nc7\t0\t10\n")
    return {"fa": fa, "ctrl": ctrl}


def _pair(tmp_path, g):
    """Two copies of the genome's FASTA: (the JAX CLI's, the port's)."""
    out = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        fa = str(d / "g.fa")
        shutil.copy(g["fa"], fa)
        out.append(fa)
    return out


def _same(a, b, exts):
    for ext in exts:
        with open(a + ext, "rb") as f, open(b + ext, "rb") as h:
            assert f.read() == h.read(), ext


def test_cli_search_emit_devices_and_sparse_match_jax(genome, tmp_path):
    """search --emit-devices 1 (the port's device emit on the CPU; the
    JAX CLI's host emit), then sparse 1 and sparse 25 on each result."""
    jfa, pfa = _pair(tmp_path, genome)
    args = ["search", "-k", "25", "-s", "32K", "-e", "0", "-w", "60",
            "-c", genome["ctrl"]]
    assert jax_main(args + [jfa]) == 0
    assert main(args + ["--emit-devices", "1", "--device", "cpu", pfa]) == 0
    _same(jfa, pfa, (".qm", ".bed", ".qgc"))
    for thin in ("1", "25"):
        sp = ["sparse", "-w", "40", "-c", genome["ctrl"], thin]
        assert jax_main(sp + [jfa]) == 0
        assert main(sp + ["--device", "cpu", pfa]) == 0
        _same(jfa, pfa, (".rqm", ".bed", ".qgc"))


def test_cli_index_matches_jax(tmp_path):
    rng = np.random.default_rng(22)
    seqs = [helpers.random_genome(rng, 30) for _ in range(120)]
    seqs.append(seqs[3])
    bed = str(tmp_path / "kmers.bed")
    with open(bed, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"c1\t{i}\t{i + 30}\t{s}\n")
    jqm, pqm = str(tmp_path / "j.qm"), str(tmp_path / "p.qm")
    assert jax_main(["index", "-s", "64K", bed, jqm]) == 0
    assert main(["index", "-s", "64K", "--device", "cpu", bed, pqm]) == 0
    _same(jqm, pqm, ("",))


def test_cli_colortrack_colorkey_match_jax(tmp_path, capsys):
    cn = str(tmp_path / "s.CN.bed")
    with open(cn, "w") as f:
        for i, v in enumerate((0.4, 1.5, 2.5, 2.2, 3.7, 8.5, 12.0)):
            f.write(f"chr1\t{1000 * i}\t{1000 * (i + 1)}\t{v}\n")
    assert jax_main(["colortrack", "--cn", cn, "--name", "smp"]) == 0
    with open(cn + ".bedColor", "rb") as f:
        want = f.read()
    os.remove(cn + ".bedColor")
    assert main(["colortrack", "--cn", cn, "--name", "smp"]) == 0
    with open(cn + ".bedColor", "rb") as f:
        assert f.read() == want
    jkey, pkey = str(tmp_path / "jkey.bed"), str(tmp_path / "pkey.bed")
    assert jax_main(["colorkey", jkey]) == 0
    assert main(["colorkey", pkey]) == 0
    _same(jkey, pkey, ("",))
    assert f"wrote {pkey}" in capsys.readouterr().out


def multi_device_cli_pair(args, tmp_path) -> None:
    """Run `args` (paths named g.fa, r.fq, o, r.fq:o and the profile
    directory prof) with the JAX CLI and with the port's (--device cpu:
    a mesh of copies of the CPU) in two directories that hold the same
    small genome, reads and (but for a search) dictionary; every file
    the two wrote has the same bytes, and with --profile each wrote its
    trace into prof."""
    from quickmer2_tpu.config import SearchConfig as JaxSearchConfig
    from quickmer2_tpu.pipelines import search as jsearch
    rng = np.random.default_rng(8)
    g = helpers.random_genome(rng, 6000)
    reads = helpers.mutate_reads(
        rng, helpers.simulate_reads(rng, g, 300, 100), 0.005)
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        helpers.write_fasta(str(d / "g.fa"), {"c1": g})
        helpers.write_fastq(str(d / "r.fq"), reads)
        if args[0] != "search":
            jsearch.run_search(str(d / "g.fa"), JaxSearchConfig(
                kmer_size=25, hash_size=1 << 14, edit_distance=0,
                window_size=50), verbose=False)
        dirs.append(d)
    inputs = {n: sorted(os.listdir(d)) for n, d in zip("jp", dirs)}

    def paths(d):
        out = list(args[:1])
        if args[0] == "search":
            out += ["-k", "25", "-s", "16K", "-e", "0", "-w", "50"]
        else:
            out += ["--batch-bases", "16384"]
        for a in args[1:]:
            if a in ("g.fa", "r.fq", "o", "prof"):
                a = str(d / a)
            elif a == "r.fq:o":
                a = f"{d / 'r.fq'}:{d / 'o'}"
            out.append(a)
        return out
    assert jax_main(paths(dirs[0])) == 0
    assert main(paths(dirs[1]) + ["--device", "cpu"]) == 0
    made = [sorted(set(os.listdir(d)) - set(inputs[n]) - {"prof"})
            for n, d in zip("jp", dirs)]
    if "--profile" in args:
        assert glob.glob(str(dirs[0] / "prof" / "plugins" / "profile" / "*"
                             / "*.trace.json.gz"))
        assert len(glob.glob(str(dirs[1] / "prof" / "*.pt.trace.json"))) == 1
    assert made[0] == made[1] and made[0], made
    for f in made[0]:
        with open(dirs[0] / f, "rb") as a, open(dirs[1] / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("args", [
    ["search", "--emit-devices", "2", "g.fa"],
    ["search", "--profile", "prof", "g.fa"],
    ["count", "--data-devices", "2", "g.fa", "r.fq", "o"],
    ["cohort", "--dict-devices", "2", "g.fa", "r.fq:o"]])
def test_cli_multi_device_and_profile_not_ported(args, tmp_path):
    """--profile and the multi-device options, each once refused, run
    and write the JAX CLI's bytes."""
    multi_device_cli_pair(args, tmp_path)


def test_cli_est_plot_without_matplotlib(tmp_path, capsys, monkeypatch):
    """est --plot where matplotlib is missing: the JAX CLI's stderr line,
    the CN bed all the same."""
    from quickmer2_tpu_torch.analytics import plots
    from tests.test_torch_est_device import _est_files
    monkeypatch.setattr(plots, "_HAVE_MPL", False)
    prefix, smp = _est_files(str(tmp_path), np.random.default_rng(9))
    out = str(tmp_path / "cn.bed")
    assert main(["est", "--plot", "--device", "cpu", prefix, smp, out]) == 0
    assert "matplotlib unavailable; skipping QC plot" in \
        capsys.readouterr().err
    assert os.path.getsize(out) > 0
    assert not [f for f in os.listdir(str(tmp_path)) if f.endswith(".png")]
