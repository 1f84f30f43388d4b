"""On a card: one short run of each one-card cell, correct, with its
metrics; and the control's readings at the flat cell's size."""

import json
import subprocess
import sys

import pytest
import torch

from qmbench import control

from qmbench_tiny import ROOT, load_bench

CELLS = [w["name"] for w in load_bench()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "qmbench", "--workload", cell, "--seed",
         "2147483651", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["count_kmers_per_s"]["value"] > 0


@pytest.mark.card
def test_control_fails_on_the_card(card):
    got = control.readings(CELLS[0], 11, 8, torch.device("cuda"))
    assert got["forward_only"] > 0 and got["tail_dropped"] > 0
