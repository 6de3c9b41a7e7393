"""The fingerprint entry point of the PyTorch port vs the JAX package's.

``.ckpt`` files are written with the JAX package's ``init_model`` +
``save_checkpoint`` (hidden 64, ``band_precision="highest"`` so that the
port computes FP32 as JAX's CPU path does); both packages'
``molecule_fingerprint`` read them and write a CSV. Numbers agree to rtol
1e-5 (the predictions' tolerance: FP32 with another summation order);
the header, SMILES and 'Invalid SMILES' placeholders exactly. The port
runs with ``device="cpu"`` and its default (C++) featurizer.
"""

import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.models import init_model
from polymer_chemprop_tpu.train.molecule_fingerprint import (
    FingerprintConfig as JaxFingerprintConfig,
)
from polymer_chemprop_tpu.train.molecule_fingerprint import (
    molecule_fingerprint as jax_molecule_fingerprint,
)
from polymer_chemprop_tpu.train.trainer import build_model_config
from polymer_chemprop_tpu.utils.checkpoint import save_checkpoint
from polymer_chemprop_tpu_torch.train.molecule_fingerprint import (
    FingerprintConfig,
    molecule_fingerprint,
)
from test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
RTOL, ATOL = 1e-5, 1e-6


def _write_ckpts(tmp_path, n_models, **train_kw):
    tcfg = JaxTrainConfig(hidden_size=64, depth=3, ffn_num_layers=3,
                          ffn_hidden_size=48, target_columns=["t0"],
                          band_precision="highest", **train_kw)
    mcfg = build_model_config(tcfg, 1)
    ckpt_dir = tmp_path / "ckpts"
    for i in range(n_models):
        params = init_model(jax.random.PRNGKey(5 + i), mcfg)
        save_checkpoint(str(ckpt_dir / f"model_{i}" / "model.ckpt"), params,
                        tcfg.to_dict())
    return str(ckpt_dir)


def _test_csv(tmp_path, invalid: bool):
    with open(os.path.join(DATA, "regression.csv")) as f:
        smiles = [r[0] for r in csv.reader(f)][1:29]
    if invalid:
        smiles.insert(3, "not_a_smiles((")
    path = tmp_path / "test.csv"
    path.write_text("smiles\n" + "\n".join(smiles) + "\n")
    return str(path)


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_csv_close(got_path, want_path):
    got, want = _read(got_path), _read(want_path)
    assert got[0] == want[0]
    assert len(got) == len(want)
    for g_row, w_row in zip(got[1:], want[1:]):
        assert len(g_row) == len(w_row)
        assert g_row[0] == w_row[0]
        if w_row[1] == "Invalid SMILES":
            assert g_row[1:] == w_row[1:]
            continue
        np.testing.assert_allclose(np.asarray(g_row[1:], float),
                                   np.asarray(w_row[1:], float),
                                   rtol=RTOL, atol=ATOL)


def _both(tmp_path, test_path, ckpt_dir, fp_type, **kw):
    paths = {k: str(tmp_path / f"{k}_fp.csv") for k in ("jax", "torch")}
    want = jax_molecule_fingerprint(JaxFingerprintConfig(
        test_path=test_path, preds_path=paths["jax"],
        checkpoint_dir=ckpt_dir, fingerprint_type=fp_type, num_workers=1))
    got = molecule_fingerprint(FingerprintConfig(
        test_path=test_path, preds_path=paths["torch"],
        checkpoint_dir=ckpt_dir, fingerprint_type=fp_type, num_workers=1,
        device="cpu", **kw))
    return got, want, paths


@pytest.mark.parametrize("n_models", [1, 2])
@pytest.mark.parametrize("fp_type", ["MPN", "last_FFN"])
def test_fingerprint_matches_jax(tmp_path, fp_type, n_models):
    """One or two checkpoints stacked side by side, one invalid row."""
    test_path = _test_csv(tmp_path, invalid=True)
    ckpt_dir = _write_ckpts(tmp_path, n_models)
    got, want, paths = _both(tmp_path, test_path, ckpt_dir, fp_type)
    width = 64 if fp_type == "MPN" else 48
    assert got.shape == want.shape == (28, width * n_models)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    _assert_csv_close(paths["torch"], paths["jax"])
    rows = _read(paths["torch"])
    assert rows[0] == ["smiles"] + [f"fp_{i}" for i in range(width * n_models)]
    assert rows[4] == ["not_a_smiles(("] + ["Invalid SMILES"] * width * n_models


@pytest.mark.parametrize("native", [False, None], ids=["python", "cxx"])
def test_fingerprint_polymer_python_featurizer_matches_jax(tmp_path, native):
    """A polymer checkpoint, the port on its Python featurizer and on its
    default (C++) one."""
    mons = ["[*:1]CC[*:2]", "[*:1]c1ccc([*:2])cc1", "[*:1]CO[*:2]"]
    rows = [f'"{a}.{b.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")}'
            f'|0.25|0.75|<1-3:0.5:0.5<2-4:0.5:0.5~{10 + i}"'
            for i, (a, b) in enumerate(zip(mons, mons[1:] + mons[:1]))]
    path = tmp_path / "poly.csv"
    path.write_text("smiles\n" + "\n".join(rows) + "\n")
    ckpt_dir = _write_ckpts(tmp_path, 1, polymer=True)
    got, want, paths = _both(tmp_path, str(path), ckpt_dir, "last_FFN",
                             use_native_featurizer=native)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    _assert_csv_close(paths["torch"], paths["jax"])


@pytest.mark.parametrize("fp_type", ["MPN", "last_FFN"])
def test_fingerprint_atom_messages_matches_jax(tmp_path, fp_type):
    """An ``atom_messages`` checkpoint with bias (W_h of hidden + 14 bond
    features in)."""
    test_path = _test_csv(tmp_path, invalid=True)
    ckpt_dir = _write_ckpts(tmp_path, 1, atom_messages=True, bias=True)
    got, want, paths = _both(tmp_path, test_path, ckpt_dir, fp_type)
    assert got.shape == want.shape == (28, 64 if fp_type == "MPN" else 48)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    _assert_csv_close(paths["torch"], paths["jax"])


def test_all_rows_invalid_writes_placeholders(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("smiles\nnot_a_smiles((\nC1CC\n")
    ckpt_dir = _write_ckpts(tmp_path, 2)
    for fp_type in ("MPN", "last_FFN"):
        got, want, paths = _both(tmp_path, str(path), ckpt_dir, fp_type)
        assert got.shape == want.shape
        assert _read(paths["torch"]) == _read(paths["jax"])


def test_unknown_fingerprint_type_raises(tmp_path):
    ckpt_dir = _write_ckpts(tmp_path, 1)
    with pytest.raises(ValueError, match="Unsupported fingerprint type"):
        molecule_fingerprint(FingerprintConfig(
            test_path=_test_csv(tmp_path, invalid=False),
            checkpoint_dir=ckpt_dir, fingerprint_type="bogus",
            device="cpu"))


def test_cli_fingerprint_subcommand(tmp_path):
    """``python -m polymer_chemprop_tpu_torch.cli fingerprint`` on the
    CPU writes what the function returns."""
    test_path = _test_csv(tmp_path, invalid=False)
    ckpt_dir = _write_ckpts(tmp_path, 1)
    out = tmp_path / "cli_fp.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "polymer_chemprop_tpu_torch.cli",
         "fingerprint", "--test_path", test_path, "--checkpoint_dir",
         ckpt_dir, "--preds_path", str(out), "--fingerprint_type",
         "last_FFN", "--device", "cpu", "--num_workers", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.asarray([r[1:] for r in _read(out)[1:]], float)
    want = molecule_fingerprint(FingerprintConfig(
        test_path=test_path, checkpoint_dir=ckpt_dir,
        fingerprint_type="last_FFN", device="cpu", num_workers=1))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
