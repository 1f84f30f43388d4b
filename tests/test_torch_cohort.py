"""Cohort runs and the CLI paths of this slice against the JAX package:
run_cohort's .bin, .txt and .CN.bed equal the JAX cohort's and the
port's own single-sample count + est, in flat and anchored mode; the
`cohort` subcommand and `count --engine ... --checkpoint ...` write the
JAX CLI's bytes; the sharded cohort (data_devices, dict_devices) writes
the JAX sharded cohort's."""

import os

import numpy as np
import pytest

from quickmer2_tpu.cli import main as jax_main
from quickmer2_tpu.config import SearchConfig
from quickmer2_tpu.pipelines import search as search_pipe
from quickmer2_tpu.pipelines.cohort import run_cohort as jax_run_cohort
from quickmer2_tpu_torch.cli import main
from quickmer2_tpu_torch.pipelines.cohort import run_cohort
from quickmer2_tpu_torch.pipelines.count import run_count
from quickmer2_tpu_torch.pipelines.est import run_est
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

_EXTS = (".bin", ".txt", ".CN.bed")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(21)
    d = tmp_path_factory.mktemp("tcohort")
    chr1 = helpers.random_genome(rng, 20000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    ctrl = str(d / "ctrl.bed")
    with open(ctrl, "w") as f:
        f.write("c1\t0\t20000\n")
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=30, hash_size=1 << 16, edit_distance=0,
                         window_size=100, control_bed=ctrl), verbose=False)
    samples = []
    for i in range(2):
        srng = np.random.default_rng(100 + i)
        # 100 and 150 bp reads and a few 2000 bp reads, which the
        # anchored path cuts into segments
        reads = helpers.simulate_reads(srng, chr1, 1200 + 300 * i, 100)
        reads += helpers.simulate_reads(srng, chr1, 300, 150)
        reads += helpers.simulate_reads(srng, chr1, 5 + i, 2000)
        reads = helpers.mutate_reads(srng, reads, 0.003)
        p = str(d / f"s{i}.fq")
        helpers.write_fastq(p, reads)
        samples.append(p)
    return {"dir": str(d), "fa": fa, "samples": samples}


def _same_files(a: str, b: str) -> None:
    for ext in _EXTS:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


@pytest.mark.parametrize("mode", ["flat", "anchored"])
def test_cohort_matches_jax_and_single_runs(world, tmp_path, mode):
    d = str(tmp_path)
    qm = world["fa"] + ".qm"
    port = [(s, os.path.join(d, f"c{i}"))
            for i, s in enumerate(world["samples"])]
    jax = [(s, os.path.join(d, f"j{i}"))
           for i, s in enumerate(world["samples"])]
    stats = run_cohort(qm, port, batch_bases=1 << 14, mode=mode,
                       ref_fasta=world["fa"], verbose=False, device="cpu")
    jax_run_cohort(qm, jax, batch_bases=1 << 14, mode=mode,
                   ref_fasta=world["fa"], verbose=False)
    assert [s["mode"] for s in stats] == [mode, mode]
    for i, s in enumerate(world["samples"]):
        _same_files(port[i][1], jax[i][1])
        out = os.path.join(d, f"i{i}")
        run_count(qm, s, out, batch_bases=1 << 14, mode=mode,
                  ref_fasta=world["fa"], verbose=False, device="cpu")
        run_est(world["fa"], out, out + ".CN.bed", verbose=False,
                device="cpu")
        _same_files(port[i][1], out)


@pytest.mark.parametrize("option", ["data_devices", "dict_devices"])
def test_cohort_sharding_not_ported(world, tmp_path, option):
    """Once a refusal, now the sharded cohort: each sample's count on two
    copies of the CPU (data_devices in flat mode, dict_devices in
    anchored mode) writes the JAX sharded cohort's .bin, .txt and
    .CN.bed."""
    mode = "flat" if option == "data_devices" else "anchored"
    d = str(tmp_path)
    port = [(s, os.path.join(d, f"c{i}"))
            for i, s in enumerate(world["samples"])]
    jax = [(s, os.path.join(d, f"j{i}"))
           for i, s in enumerate(world["samples"])]
    kw = dict(batch_bases=1 << 14, mode=mode, ref_fasta=world["fa"],
              verbose=False, **{option: 2})
    stats = run_cohort(world["fa"] + ".qm", port, device="cpu", **kw)
    jax_run_cohort(world["fa"] + ".qm", jax, **kw)
    assert [s["mode"] for s in stats] == [mode, mode]
    for (_, p), (_, j) in zip(port, jax):
        _same_files(p, j)


def test_cli_cohort_matches_jax_cli(world, tmp_path):
    d = str(tmp_path)
    pairs = [f"{s}:{os.path.join(d, 'p%d' % i)}"
             for i, s in enumerate(world["samples"])]
    jpairs = [f"{s}:{os.path.join(d, 'j%d' % i)}"
              for i, s in enumerate(world["samples"])]
    args = ["cohort", "--batch-bases", "16384", "--json"]
    jax_main(args + [world["fa"]] + jpairs)
    main(args + ["--device", "cpu", world["fa"]] + pairs)
    for i in range(2):
        _same_files(os.path.join(d, f"p{i}"), os.path.join(d, f"j{i}"))


@pytest.mark.parametrize("engine", ["packed", "sortjoin", "linear", "auto"])
def test_cli_count_engine_checkpoint_matches_jax_cli(world, tmp_path,
                                                     engine):
    """`count --engine E --checkpoint P --checkpoint-every 64K` writes
    the JAX CLI's mono .bin and removes its checkpoint."""
    d = str(tmp_path)
    sample = world["samples"][1]
    jax_main(["count", "--batch-bases", "16384", "--json", world["fa"],
              sample, os.path.join(d, "j")])
    ckpt = os.path.join(d, "ck")
    main(["count", "--batch-bases", "16384", "--engine", engine,
          "--checkpoint", ckpt, "--checkpoint-every", "64K", "--json",
          "--device", "cpu", world["fa"], sample, os.path.join(d, "p")])
    assert not os.path.exists(ckpt)
    for ext in (".bin", ".txt"):
        with open(os.path.join(d, "p" + ext), "rb") as a, \
                open(os.path.join(d, "j" + ext), "rb") as b:
            assert a.read() == b.read(), ext
