"""The comparison fails what it should: each fault a cell can have, planted
in the timed path, turns ``correct`` false; the control (the reference at
TF32 in the program's place) reads above a limit."""

from __future__ import annotations

import sys
import time

import pytest
import torch

from conftest import cells_of_kind
from portbench import faults
from portbench.harness import cell

CPU = torch.device("cpu")


def _run(tiny, manifest, name, seed):
    # long enough for a screening window to finish its first chunk
    return cell.run(name, seed, 2.0, False, CPU, time.perf_counter(),
                    man=manifest, bench_dir=tiny)[1]


@pytest.mark.parametrize("cell_name", cells_of_kind("train"))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_fault_is_caught(tiny, manifest, cell_name, fault):
    with faults.FAULTS[fault]():
        line = _run(tiny, manifest, cell_name, 21)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell_name", cells_of_kind("train"))
def test_fault_that_starts_in_the_window_is_caught(tiny, manifest,
                                                   cell_name):
    """A fault that switches on only after the set-up's steps passes the
    first steps' comparison and fails the window's."""
    with faults.FAULTS["half_batch_in_window"]():
        line = _run(tiny, manifest, cell_name, 25)
    checks = line["checks"]
    assert not line["correct"], checks
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if not k.startswith("window_")), checks
    assert any(c["value"] > c["limit"] for k, c in checks.items()
               if k.startswith("window_")), checks


@pytest.mark.parametrize("cell_name", cells_of_kind("screen"))
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_served"])
def test_served_fault_is_caught(tiny, manifest, cell_name, fault):
    with faults.FAULTS[fault]():
        line = _run(tiny, manifest, cell_name, 22)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell_name", ["wdmpnn_h2400_d6.train_b50",
                                       "wdmpnn_h2400_d6.screen_ens5_b256"])
def test_sound_run_is_correct(tiny, manifest, cell_name):
    line = _run(tiny, manifest, cell_name, 23)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell_name", [w["name"] for w in
                                       cell.manifest()["workloads"]])
def test_control_fails_a_limit(tiny, manifest, cell_name):
    """The control at the test's size reads above one of the cell's
    limits (on the chip it is read at the cell's own size, PERF.md)."""
    sys.path.insert(0, cell.ROOT)
    from portbench.calibrate import readings
    from portbench.harness import checks
    r = readings(cell_name, 24, 2.0, CPU, control=True, bench_dir=tiny,
                 man=manifest)
    lim = checks.limits(cell_name)
    assert any(r["numbers"][k] > lim[k] for k in lim), (r, lim)
