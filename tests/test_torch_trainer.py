"""Training end to end through the port vs the JAX package, on the CPU.

* the same split indices per split type and the same shuffled batches per
  epoch for the same seed;
* ``cross_validate`` in both packages on 60 molecules of
  tests/data/regression.csv (hidden 32, 2 epochs, dropout 0,
  reference-stream init): per-epoch train loss, validation score and test
  score agree to rtol 1e-3 (FP32 training over ten optimizer steps, sums
  in another order on each side);
* checkpoints cross in both directions: the port's ``best_model.ckpt``
  predicts the same through either package's ``make_predictions``; each
  package resumes from the other's ``model.ckpt`` with the optimizer state
  and continues at the right epoch;
* classification with missing targets, multiclass, ensembles, warm start
  and frozen parameters; what is not ported raises, and the plain-band
  options ported since train.

The port runs with ``device="cpu"``, i.e. its kernels' plain versions and
the hand-written backward.
"""

import csv
import json
import os
import pickle

import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.config import PredictConfig as JaxPredictConfig
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.data import MoleculeDataLoader as JaxLoader
from polymer_chemprop_tpu.data import get_data as jax_get_data
from polymer_chemprop_tpu.data import split_data as jax_split_data
from polymer_chemprop_tpu.features import FeaturizationConfig as JaxFcfg
from polymer_chemprop_tpu.train.cross_validate import (
    cross_validate as jax_cross_validate,
)
from polymer_chemprop_tpu.train.make_predictions import (
    make_predictions as jax_make_predictions,
)
from polymer_chemprop_tpu.train.trainer import _merge_matching as jax_merge
from polymer_chemprop_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from polymer_chemprop_tpu_torch import cli
from polymer_chemprop_tpu_torch.config import (
    PredictConfig,
    TrainConfig,
    parse_train_args,
)
from polymer_chemprop_tpu_torch.data import (
    MoleculeDataLoader,
    get_data,
    get_data_weights,
    split_data,
    validate_dataset_type,
)
from polymer_chemprop_tpu_torch.features import FeaturizationConfig
from polymer_chemprop_tpu_torch.models.init import reference_init_model
from polymer_chemprop_tpu_torch.models.model import build_model_config
from polymer_chemprop_tpu_torch.models.convert import params_to_jax
from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
from polymer_chemprop_tpu_torch.train.make_predictions import make_predictions
from polymer_chemprop_tpu_torch.train.trainer import _merge_matching
from polymer_chemprop_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_opt_leaves,
)
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DATA = os.path.join(os.path.dirname(__file__), "data")
REGRESSION = os.path.join(DATA, "regression.csv")
CLASSIFICATION = os.path.join(DATA, "classification.csv")
RTOL = 1e-3
SMALL = dict(hidden_size=32, depth=3, ffn_num_layers=2, epochs=2,
             batch_size=10, max_data_size=60, num_workers=1, quiet=True)


# -- splits and loader order -------------------------------------------------

def _both_datasets(n=80):
    return (get_data(REGRESSION, max_data_size=n),
            jax_get_data(REGRESSION, max_data_size=n))


def _smiles(splits):
    return [[d.smiles[0] for d in part] for part in splits]


@pytest.mark.parametrize("split_type,kw", [
    ("random", dict(seed=3)),
    ("scaffold_balanced", dict(seed=1)),
    ("random_with_repeated_smiles", dict(seed=2)),
    ("cv", dict(seed=1, num_folds=4)),
    ("cv-no-test", dict(seed=2, num_folds=4)),
    ("index_predetermined", dict(seed=0)),
    ("predetermined", dict(seed=5)),
    ("crossval", dict(seed=0)),
])
def test_split_matches_jax_package(tmp_path, split_type, kw):
    data, jdata = _both_datasets()
    sizes = (0.8, 0.1, 0.1)
    if split_type == "index_predetermined":
        kw["crossval_index_sets"] = [[list(range(0, 50)), list(range(50, 65)),
                                      list(range(65, 80))]]
    if split_type == "predetermined":
        folds = tmp_path / "folds.pkl"
        folds.write_bytes(pickle.dumps([list(range(i, 80, 4))
                                        for i in range(4)]))
        kw.update(folds_file=str(folds), test_fold_index=1)
        sizes = (0.8, 0.2, 0.0)
    if split_type == "crossval":
        for i in range(4):
            (tmp_path / f"{i}.pkl").write_bytes(
                pickle.dumps(list(range(i * 20, i * 20 + 20))))
        kw.update(crossval_index_sets=[[[0, 1], [2], [3]]],
                  crossval_index_dir=str(tmp_path))
    got = _smiles(split_data(data, split_type, sizes, **kw))
    want = _smiles(jax_split_data(jdata, split_type, sizes, **kw))
    assert got == want
    assert sum(map(len, got)) == 80 and all(got[:2])


def test_split_rejects_bad_arguments():
    data, _ = _both_datasets(20)
    with pytest.raises(ValueError, match="sum to 1"):
        split_data(data, "random", (0.5, 0.1, 0.1))
    with pytest.raises(ValueError, match="not supported"):
        split_data(data, "stratified")
    with pytest.raises(ValueError, match="folds"):
        split_data(data, "cv", num_folds=1)


@pytest.mark.parametrize("class_balance", [False, True])
def test_loader_batches_match_jax_package(class_balance):
    """Three shuffled epochs: the same molecules in the same batches, the
    same targets, mask and weights; the ragged last batch is padded with
    mask 0 and weight 0; the envelope never shrinks."""
    path = CLASSIFICATION if class_balance else REGRESSION
    data = get_data(path, max_data_size=47)
    jdata = jax_get_data(path, max_data_size=47)
    kw = dict(batch_size=10, shuffle=True, seed=7, num_workers=1,
              class_balance=class_balance)
    loader = MoleculeDataLoader(data, FeaturizationConfig(), **kw)
    jloader = JaxLoader(jdata, JaxFcfg(), use_native=False, **kw)
    envelopes = []
    for _ in range(3):
        batches, jbatches = list(loader), list(jloader)
        assert len(batches) == len(jbatches)
        for b, jb in zip(batches, jbatches):
            assert b.size == jb.size
            np.testing.assert_array_equal(b.targets, jb.targets)
            np.testing.assert_array_equal(b.mask, jb.mask)
            np.testing.assert_array_equal(b.data_weights, jb.data_weights)
            np.testing.assert_array_equal(b.graph_arrays[0]["f_atoms"],
                                          jb.graph_arrays[0]["f_atoms"])
            assert b.targets.shape[0] == 10
            assert (b.mask[b.size:] == 0).all()
            assert (b.data_weights[b.size:] == 0).all()
        if not class_balance:
            assert [b.size for b in batches] == [10, 10, 10, 10, 7]
        envelopes.append((loader._pad_atoms, loader._pad_bonds))
    assert envelopes == sorted(envelopes)
    assert len(loader) == len(jloader)
    with pytest.raises(ValueError, match="Cannot safely extract targets"):
        loader.targets()


def test_dataset_target_handling_matches_jax_package(tmp_path):
    data, jdata = _both_datasets(30)
    assert data.num_tasks == jdata.num_tasks == 1
    scaler, jscaler = data.normalize_targets(), jdata.normalize_targets()
    np.testing.assert_array_equal(scaler.means, jscaler.means)
    np.testing.assert_array_equal(scaler.stds, jscaler.stds)
    assert data.targets() == jdata.targets()
    raw = [d.raw_targets for d in data]
    data.reset_features_and_targets()
    assert data.targets() == raw
    assert data.data_weights() == [1.0] * 30
    weights = tmp_path / "w.csv"
    weights.write_text("w\n" + "\n".join(str(1 + i % 3) for i in range(30)))
    got = get_data_weights(str(weights))
    assert abs(sum(got) / 30 - 1.0) < 1e-12
    weighted = get_data(REGRESSION, max_data_size=30,
                        data_weights_path=str(weights))
    assert weighted.data_weights() == got
    validate_dataset_type(data, "regression")
    with pytest.raises(ValueError, match="0 or 1"):
        validate_dataset_type(data, "classification")


# -- training as a whole ----------------------------------------------------

def _log(save_dir, model=0):
    path = os.path.join(save_dir, "fold_0", f"model_{model}",
                        "train_val_loss_log.csv")
    with open(path) as f:
        return list(csv.DictReader(f))


def _assert_logs_close(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=rtol,
                                       err_msg=k)


@pytest.fixture(scope="module")
def regression_runs(tmp_path_factory):
    """One 2-epoch run of each package on the same 60 molecules."""
    root = tmp_path_factory.mktemp("runs")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    kw = dict(data_path=REGRESSION, dataset_type="regression",
              extra_metrics=["mae"], grad_clip=2.0, save_preds=True,
              save_smiles_splits=True, **SMALL)
    port = cross_validate(TrainConfig(save_dir=port_dir, device="cpu", **kw))
    jax_ = jax_cross_validate(JaxTrainConfig(save_dir=jax_dir, **kw))
    return port_dir, jax_dir, port, jax_, kw


def test_cross_validate_matches_jax_package(regression_runs):
    port_dir, jax_dir, port, jax_, _ = regression_runs
    np.testing.assert_allclose(port, jax_, rtol=RTOL)
    _assert_logs_close(_log(port_dir), _log(jax_dir))
    rows = _log(port_dir)
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert {"train_loss", "train_avg_rmse", "val_avg_mae",
            "val_logSolubility_rmse", "param_norm",
            "gradient_norm"} <= rows[0].keys()
    # the artifacts a run leaves, as the JAX package leaves them
    for d in (port_dir, jax_dir):
        fold = os.path.join(d, "fold_0")
        for name in ("args.json", "test_scores.csv", "verbose.log",
                     "quiet.log", "fold_0/test_scores.json",
                     "fold_0/test_preds.csv", "fold_0/train_smiles.csv",
                     "fold_0/split_indices.pckl",
                     "fold_0/model_0/model.ckpt",
                     "fold_0/model_0/best_model.ckpt"):
            assert os.path.exists(os.path.join(d, name)), (d, name)
        with open(os.path.join(fold, "split_indices.pckl"), "rb") as f:
            assert [len(x) for x in pickle.load(f)] == [48, 6, 6]
    with open(os.path.join(port_dir, "fold_0", "test_scores.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_dir, "fold_0", "test_scores.json")) as f:
        want = json.load(f)
    assert got.keys() == want.keys() == {"rmse", "mae"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)


def test_port_checkpoint_predicts_the_same_through_both_packages(
        regression_runs, tmp_path):
    port_dir = regression_runs[0]
    ckpt = os.path.join(port_dir, "fold_0", "model_0", "best_model.ckpt")
    test_path = os.path.join(DATA, "regression_test_smiles.csv")
    got = make_predictions(PredictConfig(
        test_path=test_path, checkpoint_path=ckpt, num_workers=1,
        preds_path=str(tmp_path / "port.csv"), device="cpu"))
    want = jax_make_predictions(JaxPredictConfig(
        test_path=test_path, checkpoint_path=ckpt, num_workers=1,
        preds_path=str(tmp_path / "jax.csv")))
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=1e-5, atol=1e-6)
    # parameters, scalers, config and epoch read back on both sides
    params, config, scalers, epoch = load_checkpoint(ckpt)
    jparams, jconfig, jscalers, jepoch = jax_load_checkpoint(ckpt)
    assert epoch == jepoch and config == jconfig
    np.testing.assert_array_equal(params["ffn"][1]["w"], jparams["ffn"][1]["w"])
    np.testing.assert_array_equal(scalers["data_scaler"].means,
                                  jscalers["data_scaler"].means)
    assert load_opt_leaves(ckpt) is None   # best_model carries no optimizer
    # a directory walk prefers best_model.ckpt over the resume checkpoint
    from_dir = make_predictions(PredictConfig(
        test_path=test_path, checkpoint_dir=port_dir, num_workers=1,
        preds_path=str(tmp_path / "dir.csv"), device="cpu"))
    assert from_dir == got


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_resume_across_packages(regression_runs, tmp_path, writer, reader):
    """Resume a third epoch from the ``model.ckpt`` that ``writer`` wrote
    after epoch 1, in ``reader``; the JAX package resuming from its own
    checkpoint is the reference."""
    port_dir, jax_dir, _, _, kw = regression_runs
    kw = dict(kw, epochs=3)

    def resume(package, ckpt_dir, out):
        ckpt = os.path.join(ckpt_dir, "fold_0", "model_0", "model.ckpt")
        if package == "port":
            cross_validate(TrainConfig(save_dir=out, device="cpu",
                                       resume_from_checkpoint=ckpt, **kw))
        else:
            jax_cross_validate(JaxTrainConfig(
                save_dir=out, resume_from_checkpoint=ckpt, **kw))
        with open(os.path.join(out, "verbose.log")) as f:
            text = f.read()
        assert "at epoch 2" in text
        assert "Epoch 2:" in text and "Epoch 1:" not in text
        saved = os.path.join(out, "fold_0", "model_0", "model.ckpt")
        return text, load_checkpoint(saved), load_opt_leaves(saved)

    _, want_ckpt, want_opt = resume("jax", jax_dir, str(tmp_path / "ref"))
    src = port_dir if writer == "port" else jax_dir
    text, got_ckpt, got_opt = resume(reader, src, str(tmp_path / "got"))
    assert got_ckpt[3] == want_ckpt[3] == 2          # the saved epoch
    # 10 updates before the resume + 5 after it, with the moments carried
    assert int(got_opt[0]) == int(want_opt[0]) == 15
    assert len(got_opt) == len(want_opt)
    for a, b in zip(got_opt, want_opt):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-7)
    np.testing.assert_allclose(got_ckpt[0]["encoders"][0]["W_h"]["w"],
                               want_ckpt[0]["encoders"][0]["W_h"]["w"],
                               rtol=RTOL, atol=1e-6)
    line = [l for l in text.splitlines() if l.startswith("Epoch 2:")][0]
    with open(os.path.join(str(tmp_path / "ref"), "verbose.log")) as f:
        ref = [l for l in f.read().splitlines() if l.startswith("Epoch 2:")][0]
    value = lambda l: float(l.split("train loss = ")[1].split(",")[0])
    np.testing.assert_allclose(value(line), value(ref), rtol=RTOL)


def test_resume_experiment_skips_finished_folds(regression_runs):
    port_dir, _, port, _, kw = regression_runs
    before = os.path.getmtime(os.path.join(port_dir, "fold_0", "model_0",
                                           "model.ckpt"))
    again = cross_validate(TrainConfig(save_dir=port_dir, device="cpu",
                                       resume_experiment=True, **kw))
    assert again == port
    assert before == os.path.getmtime(os.path.join(
        port_dir, "fold_0", "model_0", "model.ckpt"))


@pytest.mark.parametrize("dataset_type", ["classification", "multiclass"])
def test_classification_and_multiclass_training_match_jax_package(
        tmp_path, dataset_type):
    """Three tasks with missing targets (classification.csv has blanks);
    multiclass reads the same 0/1 columns as class ids of two classes."""
    kw = dict(data_path=CLASSIFICATION, dataset_type=dataset_type,
              target_columns=["NR-AR", "NR-AhR", "SR-MMP"],
              multiclass_num_classes=2, class_balance=False,
              optimizer="adamw", weight_decay=0.01, scheduler="cosine",
              **dict(SMALL, epochs=1))
    got = cross_validate(TrainConfig(save_dir=str(tmp_path / "port"),
                                     device="cpu", **kw))
    want = jax_cross_validate(JaxTrainConfig(save_dir=str(tmp_path / "jax"),
                                             **kw))
    _assert_logs_close(_log(str(tmp_path / "port")),
                       _log(str(tmp_path / "jax")))
    np.testing.assert_allclose(got, want, rtol=RTOL, equal_nan=True)


def test_reference_stream_init_matches_jax_package():
    from polymer_chemprop_tpu.models.torch_init import reference_init_params
    from polymer_chemprop_tpu.train.trainer import (
        build_model_config as jax_build_model_config,
    )
    kw = dict(hidden_size=32, number_of_molecules=2, ffn_num_layers=3)
    cfg = build_model_config(TrainConfig(**kw), 2)
    jcfg = jax_build_model_config(JaxTrainConfig(**kw), 2)
    for member in (0, 2):
        state = torch.get_rng_state()
        got = params_to_jax(reference_init_model(cfg, 11, member))
        assert torch.equal(state, torch.get_rng_state())  # RNG untouched
        want = reference_init_params(jcfg, 11, member)
        for enc, jenc in zip(got["encoders"], want["encoders"]):
            for name in ("W_i", "W_h", "W_o"):
                np.testing.assert_array_equal(enc[name]["w"], jenc[name]["w"])
            assert (enc["W_o"]["b"] == 0).all()
        for layer, jlayer in zip(got["ffn"], want["ffn"]):
            np.testing.assert_array_equal(layer["w"], jlayer["w"])
            np.testing.assert_array_equal(layer["b"], jlayer["b"])


def test_ensemble_warm_start_and_frozen_encoder(regression_runs, tmp_path):
    port_dir = regression_runs[0]
    teacher = os.path.join(port_dir, "fold_0", "model_0", "best_model.ckpt")
    out = str(tmp_path / "frozen")
    kw = dict(data_path=REGRESSION, dataset_type="regression",
              **dict(SMALL, epochs=1))
    cross_validate(TrainConfig(
        save_dir=out, device="cpu", ensemble_size=2, checkpoint_frzn=teacher,
        frzn_encoder=True, frzn_ffn_layers=1, reference_init=False,
        dropout=0.1, **kw))
    taught, _, _, _ = load_checkpoint(teacher)
    members = []
    for i in range(2):
        ckpt = os.path.join(out, "fold_0", f"model_{i}", "model.ckpt")
        params, _, _, _ = load_checkpoint(ckpt)
        # the frozen encoder and first FFN layer stay the teacher's
        for name in ("W_i", "W_h", "W_o"):
            np.testing.assert_array_equal(params["encoders"][0][name]["w"],
                                          taught["encoders"][0][name]["w"])
        np.testing.assert_array_equal(params["ffn"][0]["w"],
                                      taught["ffn"][0]["w"])
        assert not np.array_equal(params["ffn"][1]["w"], taught["ffn"][1]["w"])
        # only the trainable layer has moments: count, mu(b, w), nu(b, w), count
        assert [l.shape for l in load_opt_leaves(ckpt)] == \
            [(), (1,), (32, 1), (1,), (32, 1), ()]
        members.append(params)
    assert not np.array_equal(members[0]["ffn"][1]["w"],
                              members[1]["ffn"][1]["w"])
    assert len(_log(out, model=1)) == 1

    # warm start: matching shapes are taken, the rest stays fresh
    warm = str(tmp_path / "warm")
    cross_validate(TrainConfig(save_dir=warm, device="cpu",
                               checkpoint_paths=[teacher], **kw))
    with open(os.path.join(warm, "verbose.log")) as f:
        assert "(8 parameters loaded, 0 kept fresh)" in f.read()


def test_merge_matching_matches_jax_package():
    fresh = {"encoders": [{"W_h": {"w": np.zeros((3, 3))}}],
             "ffn": [{"w": np.zeros((3, 2)), "b": np.zeros(2)},
                     {"w": np.zeros((2, 1)), "b": np.zeros(1)}]}
    loaded = {"encoders": [{"W_h": {"w": np.ones((3, 3))}}],
              "ffn": [{"w": np.ones((3, 4)), "b": np.ones(2)}]}
    got, used, skipped = _merge_matching(fresh, loaded)
    want, jused, jskipped = jax_merge(fresh, loaded)
    assert (used, skipped) == (jused, jskipped) == (2, 3)
    assert got["encoders"][0]["W_h"]["w"].sum() == 9
    assert got["ffn"][0]["w"].sum() == 0 and got["ffn"][0]["b"].sum() == 2
    np.testing.assert_array_equal(got["ffn"][1]["w"], want["ffn"][1]["w"])


@pytest.mark.parametrize("kw,match", [
    (dict(dataset_type="spectra"), "spectra training"),
    (dict(features_generator=["morgan"]), "features_generator"),
    (dict(features_path=["f.csv"]), "features_path"),
    (dict(atom_descriptors="feature", atom_descriptors_path="a.npz"),
     "atom_descriptors"),
    (dict(tensorboard=True), "tensorboard"),
    (dict(profile_dir="/tmp/p"), "profile_dir"),
    (dict(data_parallel=True), "data_parallel"),
    (dict(atom_messages=True), "atom_messages"),
    (dict(bias=True), "bias"),
    (dict(undirected=True), "undirected"),
    (dict(param_dtype="bfloat16"), "bfloat16"),
])
def test_unported_training_options_raise(tmp_path, kw, match):
    """What is not ported raises. The plain-band options (``bias``,
    ``undirected``, bfloat16), ``atom_messages``, spectra training and the
    extra features (generators, feature files, atom descriptors) have been
    ported since: they train (parity with the JAX package:
    tests/test_torch_plain_band_train.py, tests/test_torch_atom_messages.py,
    tests/test_torch_extra_features.py). So do ``tensorboard`` (an event
    file in the model directory) and ``profile_dir`` (a Chrome trace
    there). ``data_parallel`` is ported too: in one process it trains on
    the one device, as the JAX trainer does with one device
    (tests/test_torch_parallel_trainer.py trains it under torchrun)."""
    kw = dict(kw)
    if match == "profile_dir":
        kw["profile_dir"] = str(tmp_path / "profile")
    if match == "spectra training":
        kw.update(data_path=os.path.join(DATA, "spectra.csv"),
                  phase_features_path=os.path.join(DATA,
                                                   "spectra_features.csv"))
    if match == "features_path":
        kw["features_path"] = [os.path.join(DATA, "regression.npz")]
    if match == "atom_descriptors":
        rows = list(csv.reader(open(REGRESSION)))[:31]
        data_csv = tmp_path / "data.csv"
        with open(data_csv, "w", newline="") as f:
            csv.writer(f).writerows(rows)
        from polymer_chemprop_tpu_torch.chem import parse_smiles
        rng = np.random.default_rng(0)
        np.savez(tmp_path / "a.npz", *[
            rng.normal(size=(parse_smiles(r[0]).n_atoms, 2))
            for r in rows[1:]])
        kw.update(data_path=str(data_csv),
                  atom_descriptors_path=str(tmp_path / "a.npz"))
    cfg = TrainConfig(**dict(dict(data_path=REGRESSION, device="cpu",
                                  save_dir=str(tmp_path)), **SMALL, **kw))
    cfg.epochs = 1
    score, _ = cross_validate(cfg)
    assert np.isfinite(score)
    if match == "tensorboard":
        model_dir = tmp_path / "fold_0" / "model_0"
        assert any(f.startswith("events.out.tfevents")
                   for f in os.listdir(model_dir))
    if match == "profile_dir":
        traces = os.listdir(tmp_path / "profile")
        assert traces and all(f.endswith(".json") for f in traces)


def test_cli_train_defaults_to_cuda_and_takes_cpu(tmp_path):
    argv = ["--data_path", REGRESSION, "--dataset_type", "regression",
            "--save_dir", str(tmp_path / "run"), "--epochs", "1",
            "--max_data_size", "30", "--hidden_size", "16", "--quiet",
            "--num_workers", "1", "--split_sizes", "0.6", "0.2", "0.2"]
    cfg = parse_train_args(argv)
    assert cfg.device == "cuda" and cfg.split_sizes == (0.6, 0.2, 0.2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            cli.main(["train"] + argv)
    cli.main(["train"] + argv + ["--device", "cpu"])
    rows = _log(str(tmp_path / "run"))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["train_loss"]))
    with open(tmp_path / "run" / "test_scores.csv") as f:
        assert next(csv.reader(f))[:2] == ["Task", "Mean rmse"]
