"""Nothing the benchmark runs loads JAX, the JAX package, bench.py,
chip_smoke.py or chip_compare.py; the reference loads nothing of the
port; and without a card or without the program a run prints no
result."""

import os
import shutil
import subprocess
import sys
import types

from qmbench import run

from qmbench_tiny import QM, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "quickmer2_tpu", "bench",
             "chip_smoke", "chip_compare"}

SCRIPT = r"""
import json, os, sys, time
sys.path.insert(0, {qm!r})
sys.path.insert(0, os.path.join({qm!r}, "qmbench", "tests"))
from qmbench_tiny import tiny_bench
from qmbench import run
root = {root!r}
bench = tiny_bench(root)
for cell in ("f", "g"):
    res, _ = run.run_cell(bench, cell, 5, 0.1, cell == "g", device="cpu",
                          t_start=time.perf_counter(),
                          registry=run.Registry(root),
                          cache_dir=os.path.join(root, "cache"))
    assert res["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(tmp_path, snippet):
    out = subprocess.run([sys.executable, "-c", snippet], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    mods = top_level_modules(tmp_path, SCRIPT.format(
        qm=os.path.dirname(QM), root=str(tmp_path)))
    assert "quickmer2_tpu_torch" in mods        # the port ran
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port(tmp_path):
    mods = top_level_modules(tmp_path, (
        "import json, sys\n"
        "from qmbench import reference, traffic, world, trace, roofline\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"))
    assert not mods & (FORBIDDEN | {"quickmer2_tpu_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "quickmer2_tpu_torch_x",
                        types.ModuleType("quickmer2_tpu_torch_x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    """On a machine without a card the command fails and prints nothing
    on standard output (it never falls back to the CPU)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "qmbench", "--workload",
         "flat-mono.il150-e0.3", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and qmbench/, a run
    cannot load the program and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(QM, tmp_path / "qmbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    snippet = SCRIPT.format(qm=str(tmp_path), root=str(tmp_path / "r"))
    out = subprocess.run([sys.executable, "-c", snippet], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""
    assert "quickmer2_tpu_torch" in out.stderr
