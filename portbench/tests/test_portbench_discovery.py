"""A configuration, a traffic mix, its limits and a per-layer metric added
as files, under names that nothing else mentions, are found and run
without an edit to any file the benchmark has."""

from __future__ import annotations

import json
import os
import time

import torch

from portbench.harness import cell


def test_new_cell_from_files_alone(tiny):
    with open(os.path.join(tiny, "configs", "dmpnn_h2400_d6.json")) as f:
        cfg = json.load(f)
    cfg.update(name="dmpnn_h48_d2", hidden_size=48, ffn_hidden_size=48,
               depth=2, ffn_num_layers=2)
    with open(os.path.join(tiny, "configs", "dmpnn_h48_d2.json"), "w") as f:
        json.dump(cfg, f)
    traffic = {"kind": "train", "batch_size": 25, "checked_steps": 3,
               "trace_seconds": 10}
    with open(os.path.join(tiny, "traffic", "train_b25.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(tiny, "limits", "dmpnn_h48_d2.train_b25.json"),
              "w") as f:
        json.dump({"limits": {"loss_gap": 1e-3, "grad_gap": 1e-3,
                              "change_gap": 1e-2}}, f)
    folder = os.path.join(tiny, "metrics", "steps_per_s.train")
    os.makedirs(folder)
    with open(os.path.join(folder, "reader.py"), "w") as f:
        f.write("def read(rec):\n"
                "    return len(rec.units) / rec.window_s\n")
    man = {"workloads": [{"name": "dmpnn_h48_d2.train_b25",
                          "config": "dmpnn_h48_d2", "traffic": "train_b25",
                          "chips": 1, "why": "a test"}],
           "end_to_end": [{"name": "train_mol_per_s", "unit": "mol/s"},
                          {"name": "setup_s", "unit": "s"}],
           "per_layer": [{"name": "steps_per_s.train", "unit": "1/s"}]}
    t0 = time.perf_counter()
    rec, line = cell.run("dmpnn_h48_d2.train_b25", 7, 1.0, False,
                         torch.device("cpu"), t0, man=man, bench_dir=tiny)
    assert line["correct"], line["checks"]
    assert rec.cfg["hidden_size"] == 48 and rec.units.counts[0][0] == 25
    assert set(line["metrics"]) == {"train_mol_per_s", "setup_s"}
    assert cell.reader("steps_per_s.train", tiny)(rec) > 0


def test_metrics_of_a_cell(manifest):
    e2e, per = cell.cell_metrics(manifest, "dmpnn_h2400_d6.screen_ens5_b256")
    assert {m["name"] for m in e2e} == {"screen_mol_per_s", "setup_s"}
    assert all(m["name"].endswith(".screen") for m in per)
