"""Reference torch ``.pt`` checkpoints in the PyTorch port vs the JAX package.

The three reference shapes (inference with args and scalers, weights-only
``state_dict``, the SSL script's ``model_state_dict``) are written with
``torch.save`` as tests/test_torch_import.py writes them. Both packages
must import the same parameters, config and scalers bit for bit, serve the
same predictions and fingerprints from a ``.pt`` directory (rtol 1e-5:
FP32 with another summation order; ``band_precision="highest"`` in the
args, since JAX's CPU path computes FP32 at every setting), walk the same
files, warm-start ``checkpoint_frzn`` from a weights-only file, and read
each other's exports. The port runs with ``device="cpu"``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.config import PredictConfig as JaxPredictConfig
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.config import find_checkpoints as jax_find
from polymer_chemprop_tpu.models import init_model as jax_init_model
from polymer_chemprop_tpu.train.make_predictions import (
    make_predictions as jax_make_predictions,
)
from polymer_chemprop_tpu.train.molecule_fingerprint import (
    FingerprintConfig as JaxFingerprintConfig,
)
from polymer_chemprop_tpu.train.molecule_fingerprint import (
    molecule_fingerprint as jax_fingerprint,
)
from polymer_chemprop_tpu.train.trainer import (
    _load_frzn_into as jax_load_frzn,
)
from polymer_chemprop_tpu.train.trainer import build_model_config
from polymer_chemprop_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from polymer_chemprop_tpu.utils.checkpoint import save_checkpoint
from polymer_chemprop_tpu.utils.torch_import import (
    export_reference_checkpoint as jax_export,
)
from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
from polymer_chemprop_tpu_torch.config import find_checkpoints
from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
from polymer_chemprop_tpu_torch.train.make_predictions import make_predictions
from polymer_chemprop_tpu_torch.train.molecule_fingerprint import (
    FingerprintConfig,
    molecule_fingerprint,
)
from polymer_chemprop_tpu_torch.train.trainer import _load_frzn_into
from polymer_chemprop_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_opt_leaves,
)
from polymer_chemprop_tpu_torch.utils.torch_import import (
    export_reference_checkpoint,
)
from test_torch_threads import torch_threads  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
REGRESSION = os.path.join(DATA, "regression.csv")
ATOM_FDIM, BOND_FDIM = 133, 147
HIDDEN = 16
RTOL = 1e-5


def _state_dict(seed=0, hidden=HIDDEN, n_out=1):
    """Reference parameter naming (mpn.py:48-64, model.py:79-100)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g) * 0.2

    p = "encoder.encoder.0."
    return {p + "W_i.weight": rnd(hidden, BOND_FDIM),
            p + "W_h.weight": rnd(hidden, hidden),
            p + "W_o.weight": rnd(hidden, ATOM_FDIM + hidden),
            p + "W_o.bias": rnd(hidden),
            p + "cached_zero_vector": torch.zeros(hidden),
            "ffn.1.weight": rnd(hidden, hidden), "ffn.1.bias": rnd(hidden),
            "ffn.4.weight": rnd(n_out, hidden), "ffn.4.bias": rnd(n_out)}


def _args(**over):
    args = {"dataset_type": "regression", "hidden_size": HIDDEN, "depth": 3,
            "dropout": 0.0, "activation": "ReLU", "aggregation": "mean",
            "aggregation_norm": 100, "bias": False, "undirected": False,
            "atom_messages": False, "ffn_num_layers": 2,
            "ffn_hidden_size": HIDDEN, "number_of_molecules": 1,
            "polymer": False, "task_names": ["target"],
            "data_path": "/nonexistent/train.csv", "epochs": 10, "seed": 0,
            "band_precision": "highest"}
    args.update(over)
    return args


def _inference(path, seed=0):
    torch.save({"args": _args(), "state_dict": _state_dict(seed),
                "data_scaler": {"means": [1.5], "stds": [2.0]},
                "features_scaler": None, "atom_descriptor_scaler": None,
                "bond_feature_scaler": None}, path)
    return str(path)


def _ssl_script(path, seed=1):
    g = torch.Generator().manual_seed(seed)
    sd = {"W_initial.weight": torch.randn(HIDDEN, BOND_FDIM, generator=g),
          "W_message.weight": torch.randn(HIDDEN, HIDDEN, generator=g),
          "W_node.weight": torch.randn(HIDDEN, ATOM_FDIM + HIDDEN,
                                       generator=g),
          "W_node.bias": torch.randn(HIDDEN, generator=g),
          "node_head.0.weight": torch.randn(4, HIDDEN, generator=g)}
    torch.save({"model_state_dict": sd, "epoch": 7}, path)
    return str(path)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _leaves(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree)
                for k, v in _leaves(x, f"{prefix}{i}/").items()}
    return {prefix: np.asarray(tree)}


def _assert_same_params(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("shape", ["inference", "weights_only",
                                   "ssl_script", "legacy_pickle"])
def test_both_packages_import_the_same(tmp_path, shape):
    path = tmp_path / "ckpt.pt"
    if shape == "inference":
        _inference(path)
    elif shape == "weights_only":
        torch.save({"state_dict": _state_dict(2)}, path)
    elif shape == "ssl_script":
        _ssl_script(path)
    else:
        torch.save({"state_dict": _state_dict(3)}, path,
                   _use_new_zipfile_serialization=False)
    got, want = load_checkpoint(str(path)), jax_load_checkpoint(str(path))
    _assert_same_params(got[0], want[0])
    assert got[1] == want[1] and got[3] == want[3]
    assert got[2].keys() == want[2].keys()
    for k in got[2]:
        np.testing.assert_array_equal(got[2][k].means, want[2][k].means)
        np.testing.assert_array_equal(got[2][k].stds, want[2][k].stds)
    if shape == "inference":
        assert got[1]["target_columns"] == ["target"]
        assert set(got[2]) == {"data_scaler"}
    if shape == "ssl_script":
        assert got[1] is None and got[3] == 7
        assert set(got[0]["encoders"][0]) == {"W_i", "W_h", "W_o"}
    # a resume from any .pt starts a fresh optimizer
    assert load_opt_leaves(str(path)) is None


def test_corrupt_native_checkpoint_still_raises(tmp_path):
    import zipfile
    bad = tmp_path / "bad.ckpt"
    with zipfile.ZipFile(bad, "w") as zf:
        zf.writestr("meta.json", "{not json")
    with pytest.raises(ValueError):
        load_checkpoint(str(bad))


def test_find_checkpoints_walks_as_the_jax_package(tmp_path):
    def names(found):
        return sorted(os.path.relpath(p, tmp_path) for p in found)

    # only .pt files: best_model_full.pt alone
    (tmp_path / "fold_0").mkdir()
    _inference(tmp_path / "fold_0" / "best_model_full.pt")
    torch.save({"model_state_dict": _state_dict(9), "epoch": 3},
               tmp_path / "fold_0" / "model_0.pt")
    want = names(jax_find(checkpoint_dir=str(tmp_path)))
    assert names(find_checkpoints(checkpoint_dir=str(tmp_path))) == want \
        == [os.path.join("fold_0", "best_model_full.pt")]
    # .pt files without best_model_full.pt: every one
    os.remove(tmp_path / "fold_0" / "best_model_full.pt")
    _inference(tmp_path / "fold_0" / "other.pt")
    assert names(find_checkpoints(checkpoint_dir=str(tmp_path))) == \
        names(jax_find(checkpoint_dir=str(tmp_path))) == \
        [os.path.join("fold_0", f) for f in ("model_0.pt", "other.pt")]
    # a native file beside them: native files first
    (tmp_path / "fold_1").mkdir()
    (tmp_path / "fold_1" / "model.ckpt").write_bytes(b"")
    assert names(find_checkpoints(checkpoint_dir=str(tmp_path))) == \
        names(jax_find(checkpoint_dir=str(tmp_path))) == \
        [os.path.join("fold_1", "model.ckpt")]
    empty = tmp_path / "empty"
    empty.mkdir()
    for find in (find_checkpoints, jax_find):
        with pytest.raises(ValueError, match='".pt"'):
            find(checkpoint_dir=str(empty))


def test_predictions_and_fingerprints_from_a_pt_directory(tmp_path):
    """A reference fold directory: best_model_full.pt beside a stale
    args-less resume file, which the walk must skip."""
    ckpt_dir = tmp_path / "fold_0"
    ckpt_dir.mkdir()
    _inference(ckpt_dir / "best_model_full.pt")
    torch.save({"model_state_dict": _state_dict(9), "epoch": 3},
               ckpt_dir / "model_0.pt")
    test_csv = tmp_path / "test.csv"
    with open(REGRESSION) as f:
        test_csv.write_text("".join(f.readlines()[:41]))
    common = dict(test_path=str(test_csv), checkpoint_dir=str(tmp_path))
    got = np.asarray(make_predictions(PredictConfig(
        preds_path=str(tmp_path / "p.csv"), device="cpu", **common)))
    want = np.asarray(jax_make_predictions(JaxPredictConfig(
        preds_path=str(tmp_path / "pj.csv"), **common)))
    assert got.shape == (40, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    fp = molecule_fingerprint(FingerprintConfig(
        preds_path=str(tmp_path / "f.csv"), device="cpu", **common))
    fp_want = jax_fingerprint(JaxFingerprintConfig(
        preds_path=str(tmp_path / "fj.csv"), **common))
    np.testing.assert_allclose(fp, np.asarray(fp_want), rtol=RTOL,
                               atol=1e-6)


def test_checkpoint_frzn_from_a_weights_only_pt(tmp_path):
    """The SSL script's shape as ``checkpoint_frzn``: the same merge as the
    JAX package's, and a frozen encoder through ``cross_validate``."""
    frzn = _ssl_script(tmp_path / "ssl.pt")
    kw = dict(dataset_type="regression", hidden_size=HIDDEN,
              ffn_hidden_size=HIDDEN, checkpoint_frzn=frzn)
    jcfg = JaxTrainConfig(**kw)
    fresh = jax.tree_util.tree_map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), build_model_config(jcfg, 1)))
    _assert_same_params(_load_frzn_into(fresh, frzn, TrainConfig(**kw)),
                        jax.tree_util.tree_map(
                            np.asarray, jax_load_frzn(fresh, frzn, jcfg)))
    cfg = TrainConfig(data_path=REGRESSION, max_data_size=30, epochs=1,
                      depth=2, batch_size=10, frzn_encoder=True, quiet=True,
                      num_workers=1, device="cpu",
                      save_dir=str(tmp_path / "run"), **kw)
    assert np.isfinite(cross_validate(cfg)[0])
    trained = load_checkpoint(str(tmp_path / "run" / "fold_0" / "model_0" /
                                  "best_model.ckpt"))[0]
    _assert_same_params(trained["encoders"][0],
                        load_checkpoint(frzn)[0]["encoders"][0])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_export_crosses_between_packages(tmp_path, direction):
    tcfg = JaxTrainConfig(dataset_type="regression", hidden_size=HIDDEN,
                          ffn_hidden_size=HIDDEN)
    params = jax.tree_util.tree_map(np.asarray, jax_init_model(
        jax.random.PRNGKey(42), build_model_config(tcfg, num_tasks=2)))
    path = str(tmp_path / "exported.pt")
    export, load = (export_reference_checkpoint, jax_load_checkpoint) \
        if direction == "port_to_jax" else (jax_export, load_checkpoint)
    export(path, params, tcfg.to_dict())
    got, config, _, _ = load(path)
    _assert_same_params(got, params)
    assert config["hidden_size"] == HIDDEN
    # the native format of the same parameters agrees too
    save_checkpoint(str(tmp_path / "n.ckpt"), params, tcfg.to_dict())
    _assert_same_params(load_checkpoint(str(tmp_path / "n.ckpt"))[0], got)


def test_resume_from_a_pt_starts_a_fresh_optimizer(tmp_path):
    """``resume_from_checkpoint`` on an inference ``.pt`` (no epoch, no
    optimizer state): its weights, then epoch 1 of 2 with a fresh Adam."""
    pt = _inference(tmp_path / "best_model_full.pt")
    cfg = TrainConfig(data_path=REGRESSION, max_data_size=30, epochs=2,
                      hidden_size=HIDDEN, ffn_hidden_size=HIDDEN,
                      band_precision="highest", batch_size=10, quiet=True,
                      num_workers=1, device="cpu", resume_from_checkpoint=pt,
                      save_dir=str(tmp_path / "run"))
    assert np.isfinite(cross_validate(cfg)[0])
    model_dir = tmp_path / "run" / "fold_0" / "model_0"
    with open(model_dir / "train_val_loss_log.csv") as f:
        rows = f.read().splitlines()           # no header on a resume
    assert len(rows) == 1 and rows[0].startswith("1,")
    params, _, _, epoch = load_checkpoint(str(model_dir / "model.ckpt"))
    assert epoch == 1 and load_opt_leaves(str(model_dir / "model.ckpt"))
    with open(tmp_path / "run" / "verbose.log") as f:
        assert f"Resumed from {pt} at epoch 1" in f.read()
