"""Checkpoint prediction through the PyTorch port vs the JAX package.

A ``.ckpt`` is written with the JAX package's ``init_model`` +
``save_checkpoint`` (hidden 64); both packages' ``make_predictions`` read
it and write a preds CSV. The CSVs must agree cell for cell: numbers to
rtol 1e-5 (FP32 with a different summation order), text (SMILES, the
'Invalid SMILES' placeholders, the multiclass argmax) exactly. The port
runs with ``device="cpu"``, i.e. through its kernels' plain versions.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.config import PredictConfig as JaxPredictConfig
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.data.scaler import StandardScaler as JaxScaler
from polymer_chemprop_tpu.models import init_model
from polymer_chemprop_tpu.train.make_predictions import (
    make_predictions as jax_make_predictions,
)
from polymer_chemprop_tpu.train.trainer import build_model_config
from polymer_chemprop_tpu.utils.checkpoint import save_checkpoint
from polymer_chemprop_tpu_torch.config import PredictConfig
from polymer_chemprop_tpu_torch.train.make_predictions import make_predictions
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL, ATOL = 1e-5, 1e-6


def _polymer_csv(path, n=24, seed=0):
    """Copolymer ensemble strings as in tests/test_integration.py:71-82,
    with tidy (0.25/0.5/0.75) and untidy (0.3) fragment weights."""
    rng = np.random.default_rng(seed)
    mons = ["[*:1]CC[*:2]", "[*:1]c1ccc([*:2])cc1", "[*:1]CO[*:2]",
            "[*:1]C(C)C[*:2]", "[*:1]c1ccc([*:2])cc1C"]
    rows = ["smiles"]
    for _ in range(n):
        m1, m2 = rng.choice(mons, 2, replace=False)
        m2 = m2.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
        w = rng.choice([0.25, 0.5, 0.75, 0.3])
        rows.append(f'"{m1}.{m2}|{w}|{1 - w:g}|'
                    f'<1-3:0.5:0.5<2-4:0.5:0.5~{rng.integers(2, 200)}"')
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _two_mol_csv(path):
    with open(os.path.join(DATA, "regression_test_smiles.csv")) as f:
        smi = [r[0] for r in csv.reader(f)][1:]
    lines = ["solvent,solute"] + [f"{a},{b}" for a, b in
                                  zip(smi, smi[::-1])]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _write_ckpts(tmp_path, n_models, num_tasks, scaler, **train_kw):
    # band_precision "highest": the port's rev layer then computes FP32,
    # as the JAX package's CPU (XLA) path does at every setting
    tcfg = JaxTrainConfig(hidden_size=64, depth=3, ffn_num_layers=2,
                          target_columns=[f"t{i}" for i in range(num_tasks)],
                          band_precision="highest", **train_kw)
    mcfg = build_model_config(tcfg, num_tasks)
    ckpt_dir = tmp_path / "ckpts"
    for i in range(n_models):
        params = init_model(jax.random.PRNGKey(11 + i), mcfg)
        save_checkpoint(str(ckpt_dir / f"model_{i}" / "model.ckpt"), params,
                        tcfg.to_dict(), scalers={"data_scaler": scaler})
    return str(ckpt_dir)


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_csv_close(got_path, want_path):
    got, want = _read(got_path), _read(want_path)
    assert got[0] == want[0]
    assert len(got) == len(want)
    for g_row, w_row in zip(got[1:], want[1:]):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            try:
                gf, wf = float(g), float(w)
            except ValueError:
                assert g == w
                continue
            np.testing.assert_allclose(gf, wf, rtol=RTOL, atol=ATOL)


CASES = {
    # name: (train config, test csv builder, n_models, tasks, scaler,
    #        predict kwargs)
    "regression": (dict(), lambda p: os.path.join(
        DATA, "regression_test_smiles.csv"), 1, 1,
        JaxScaler(np.array([-3.0]), np.array([2.0])), {}),
    "polymer": (dict(polymer=True), _polymer_csv, 1, 1,
                JaxScaler(np.array([0.5]), np.array([1.5])), {}),
    "invalid_rows": (dict(), lambda p: (
        p.write_text("smiles,note\nCCO,a\nnot_a_smiles((,b\nc1ccccc1,c\n"),
        str(p))[1], 1, 1, None, {}),
    "classification_ensemble": (
        dict(dataset_type="classification"), lambda p: os.path.join(
            DATA, "classification_test_smiles.csv"), 2, 3, None,
        dict(ensemble_variance=True, individual_ensemble_predictions=True)),
    "multiclass": (dict(dataset_type="multiclass", multiclass_num_classes=3),
                   lambda p: os.path.join(DATA, "regression_test_smiles.csv"),
                   1, 2, None, {}),
    "spectra_ensemble": (dict(dataset_type="spectra"), lambda p: os.path.join(
        DATA, "regression_test_smiles.csv"), 2, 5, None,
        dict(ensemble_variance=True)),
    "two_molecules": (dict(number_of_molecules=2, activation="tanh"),
                      _two_mol_csv, 1, 1, None,
                      dict(number_of_molecules=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_preds_csv_matches_jax(tmp_path, case):
    train_kw, make_csv, n_models, tasks, scaler, pred_kw = CASES[case]
    test_path = make_csv(tmp_path / "test.csv")
    ckpt_dir = _write_ckpts(tmp_path, n_models, tasks, scaler, **train_kw)
    want_path = str(tmp_path / "jax_preds.csv")
    got_path = str(tmp_path / "torch_preds.csv")
    want = jax_make_predictions(JaxPredictConfig(
        test_path=test_path, preds_path=want_path, checkpoint_dir=ckpt_dir,
        num_workers=1, **pred_kw))
    got = make_predictions(PredictConfig(
        test_path=test_path, preds_path=got_path, checkpoint_dir=ckpt_dir,
        num_workers=1, device="cpu", **pred_kw))
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=RTOL, atol=ATOL)
    _assert_csv_close(got_path, want_path)
    if case == "invalid_rows":
        rows = _read(got_path)
        assert len(rows) == 4 and rows[2][:3] == ["not_a_smiles((", "b",
                                                  "Invalid SMILES"]


@pytest.mark.parametrize("case", ["regression", "polymer"])
def test_graph_embeddings_match_jax(tmp_path, case):
    """``save_graph_embeddings``: the ensemble-averaged molecule encodings
    (the FFN's input) written as .npy, against the JAX package's."""
    train_kw, make_csv, _, tasks, scaler, _ = CASES[case]
    test_path = make_csv(tmp_path / "test.csv")
    ckpt_dir = _write_ckpts(tmp_path, 2, tasks, scaler, **train_kw)
    paths = {k: str(tmp_path / f"{k}_emb.npy") for k in ("jax", "torch")}
    jax_make_predictions(JaxPredictConfig(
        test_path=test_path, preds_path=str(tmp_path / "jax_preds.csv"),
        checkpoint_dir=ckpt_dir, num_workers=1, save_graph_embeddings=True,
        graph_embeddings_path=paths["jax"]))
    make_predictions(PredictConfig(
        test_path=test_path, preds_path=str(tmp_path / "torch_preds.csv"),
        checkpoint_dir=ckpt_dir, num_workers=1, device="cpu",
        save_graph_embeddings=True, graph_embeddings_path=paths["torch"]))
    got, want = np.load(paths["torch"]), np.load(paths["jax"])
    assert got.shape == want.shape and got.shape[1] == 64
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
