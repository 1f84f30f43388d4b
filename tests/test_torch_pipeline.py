"""The slice end to end: `python -m quickmer2_tpu search/count/est` and
`python -m quickmer2_tpu_torch ... --device cpu` on the same genome,
control bed and reads write byte-identical .qm, .qgc, .bed, .bin, .txt
and CN bed files."""

import os
import subprocess
import sys

import numpy as np
import pytest

from quickmer2_tpu.cli import main as jax_main
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "quickmer2_tpu_torch"]
                          + args + ["--device", "cpu"], cwd=cwd, env=env,
                          check=True, capture_output=True, text=True)


def _inputs(d, seed, fmt):
    rng = np.random.default_rng(seed)
    chr1 = helpers.random_genome(rng, 24000)
    mutated = list(chr1[:8000])
    for pos in rng.integers(0, 8000, size=200):
        mutated[pos] = "ACGT"[rng.integers(0, 4)]
    chr1 += "".join(mutated) + "A" * 200 + "ACACAC" * 60
    chr2 = helpers.random_genome(rng, 12000)
    helpers.write_fasta(os.path.join(d, "g.fa"), {"c1": chr1, "c2": chr2})
    # control bed terminated by a row of another chromosome
    # (the reference's stuck-last-row quirk)
    with open(os.path.join(d, "ctrl.bed"), "w") as f:
        f.write(f"c1\t0\t{len(chr1)}\nc2\t0\t12000\nc9\t0\t100\n")
    reads = helpers.simulate_reads(np.random.default_rng(seed + 1),
                                   chr1 + chr2, 9000, 100)
    reads = helpers.mutate_reads(np.random.default_rng(seed + 2), reads, 0.005)
    reads[::40] = [r[:50] + "N" + r[51:] for r in reads[::40]]
    path = os.path.join(d, "reads." + fmt)
    (helpers.write_fastq if fmt == "fq" else helpers.write_reads_fasta)(path, reads)
    return path


@pytest.mark.parametrize("k,e,fmt", [("15", "2", "fq"), ("30", "0", "fa")])
def test_port_pipeline_byte_identical(tmp_path, k, e, fmt):
    outs = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        reads = os.path.basename(_inputs(d, 11, fmt))
        search = ["search", "-k", k, "-s", "64K", "-e", e, "-w", "100",
                  "-c", "ctrl.bed", "g.fa"]
        count = ["count", "--batch-bases", "16384", "g.fa", reads, "smp"]
        est = ["est", "g.fa", "smp", "smp.CN.bed"]
        for args in (search, count, est):
            if pkg == "port":
                _port(args, d)
            else:
                cwd = os.getcwd()
                os.chdir(d)
                try:
                    assert jax_main(args) == 0
                finally:
                    os.chdir(cwd)
        outs[pkg] = d
    for name in ("g.fa.qm", "g.fa.qgc", "g.fa.bed", "smp.bin", "smp.txt",
                 "smp.CN.bed"):
        with open(os.path.join(outs["jax"], name), "rb") as f:
            want = f.read()
        with open(os.path.join(outs["port"], name), "rb") as f:
            got = f.read()
        assert got == want, name
        assert len(want) > 0, name
