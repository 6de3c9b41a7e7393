"""On the card: every cell of BENCHMARK.json, run as the driver runs it
for a short window, is correct and prints the contract's last line. Run
on the chip with ``python -m pytest portbench/tests -m gpu``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import cell


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cell.manifest()["workloads"]])
def test_cell_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell runs on the chip only")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483999", "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "wdmpnn_h2400_d6.train_b50", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
