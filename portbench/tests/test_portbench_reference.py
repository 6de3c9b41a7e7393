"""The plain reference against the port on the CPU at a tiny width: the
serving forward of both configurations and the first training steps."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import cells_of_kind
from portbench.harness import cell, data
from portbench.reference import model as ref
from portbench.reference.features.config import ATOM_FDIM, BOND_FDIM


def _cfg(tiny, name):
    with open(os.path.join(tiny, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["wdmpnn_h2400_d6", "dmpnn_h2400_d6"])
def test_forward_matches_the_port(tiny, name):
    from portbench.harness import program
    cfg = _cfg(tiny, name)
    smiles, _ = data.pool(cfg, "library")
    smiles = smiles[:40]
    T = data.num_tasks(cfg)
    names = ref.leaf_names(cfg["ffn_num_layers"])
    leaves = data.make_weights(
        ref.leaf_shapes(cfg, ATOM_FDIM, ATOM_FDIM + BOND_FDIM, T), 5, 0,
        torch.device("cpu"))
    tcfg = program.train_config(cfg, 16)
    m = program.model(tcfg, T, leaves, names, "cpu")
    loader = program.loader(program.dataset(smiles), tcfg, 16)
    zeros, ones = np.zeros(T), np.ones(T)
    got = program.predict(m, loader, torch.device("cpu"), zeros, ones)
    want = ref.predict_blocks([leaves], smiles, cfg["polymer"],
                              cfg["depth"], "cpu")
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_featurizer_counts_match_the_port():
    from polymer_chemprop_tpu_torch.native_ext import count_native
    for polymer, name in ((True, "wdmpnn_h2400_d6"),
                          (False, "dmpnn_h2400_d6")):
        from conftest import BENCH
        with open(os.path.join(BENCH, "configs", name + ".json")) as f:
            cfg = json.load(f)
        smiles = data.pool(cfg, "library")[0][::37]
        atoms, bonds = count_native(smiles, n_threads=1, polymer=polymer)
        g = ref.featurize(smiles, polymer)
        assert int(np.sum(atoms)) == g["f_atoms"].shape[0]
        assert int(np.sum(bonds)) == g["f_bonds"].shape[0]


@pytest.mark.parametrize("cell_name", cells_of_kind("train"))
def test_training_steps_match_the_port(tiny, manifest, cell_name):
    rec, line = cell.run(cell_name, 2 ** 31 + 9, 0.5, False,
                         torch.device("cpu"), time.perf_counter(),
                         man=manifest, bench_dir=tiny)
    assert line["correct"], line["checks"]
    checks = line["checks"]
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_gap"]["value"] < 1e-4
    assert checks["batch_rows"]["value"] == 0.0


def test_screening_matches_the_port(tiny, manifest):
    rec, line = cell.run("wdmpnn_h2400_d6.screen_ens5_b256", 2 ** 31 + 10,
                         1.0, False, torch.device("cpu"),
                         time.perf_counter(), man=manifest, bench_dir=tiny)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 300
    assert line["checks"]["pred_gap"]["value"] < 1e-4
