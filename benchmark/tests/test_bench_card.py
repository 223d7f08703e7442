"""On the card only: one short run of each cell through run.py, as the
benchmark's command runs it, prints a correct result line. Skips where
torch finds no CUDA device (the decision is made inside the test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the cells run the port's CUDA "
                    "kernels, which have no CPU mode)")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", "2147483801", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line["check"]
