"""Training the plain-band configurations (``bias``, ``undirected``,
bfloat16) through the port vs the JAX package, on the CPU.

* two optimizer steps of the port's ``TrainStep`` against the JAX
  package's ``make_train_step`` (optax Adam, Noam, clip) from the same
  parameters on the same batches, and the optimizer state in optax's leaf
  order with the ``"b"`` leaves of ``W_i`` / ``W_h`` present: rtol 1e-4
  (FP32, sums in another order);
* ``cross_validate`` in both packages on 60 molecules of
  tests/data/regression.csv (hidden 32, 2 epochs, dropout 0,
  reference-stream init) with ``bias`` and with ``undirected``: per-epoch
  train loss, validation score and test score agree to rtol 1e-3 (FP32
  training over ten optimizer steps);
* a ``bias=True`` ``model.ckpt`` resumes in either package, and its
  ``best_model.ckpt`` predicts the same through both;
* ``cli train`` / ``cli predict`` take ``--bias --undirected --param_dtype
  bf16`` on the CPU.

The port runs with ``device="cpu"``: its kernels' plain versions and the
hand-written backward. Model and batch helpers are those of
tests/test_torch_plain_band.py.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

import test_torch_plain_band as pb
from polymer_chemprop_tpu.config import PredictConfig as JaxPredictConfig
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.train.cross_validate import (
    cross_validate as jax_cross_validate,
)
from polymer_chemprop_tpu.train.make_predictions import (
    make_predictions as jax_make_predictions,
)
from polymer_chemprop_tpu.train.scheduler import build_optimizer as jax_optimizer
from polymer_chemprop_tpu.train.scheduler import build_schedule as jax_schedule
from polymer_chemprop_tpu.train.step import make_train_step
from polymer_chemprop_tpu_torch import cli
from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
from polymer_chemprop_tpu_torch.models import convert
from polymer_chemprop_tpu_torch.models.model import MoleculeModel
from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
from polymer_chemprop_tpu_torch.train.make_predictions import make_predictions
from polymer_chemprop_tpu_torch.train.scheduler import (
    build_optimizer,
    build_schedule,
)
from polymer_chemprop_tpu_torch.train.step import TrainStep, make_loss_fn
from polymer_chemprop_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_opt_leaves,
)
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DATA = os.path.join(os.path.dirname(__file__), "data")
REGRESSION = os.path.join(DATA, "regression.csv")
RTOL = 1e-3
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
SMALL = dict(hidden_size=32, depth=3, ffn_num_layers=2, epochs=2,
             batch_size=10, max_data_size=60, num_workers=1, quiet=True)
SCHEDULE = dict(init_lr=1e-3, max_lr=1e-2, final_lr=1e-3, warmup_epochs=1.0,
                epochs=3, steps_per_epoch=2)


@pytest.mark.parametrize("name", ["bias", "undirected", "bias_undirected"])
def test_optimizer_step_matches_make_train_step(name):
    jcfg, cfg, _, params, model = pb._init(name)
    tx = jax_optimizer("adam", jax_schedule("noam", **SCHEDULE), 0.0, 0.5)
    jstep = make_train_step(jcfg, tx)
    tstep = TrainStep(model, build_optimizer("adam", model.parameters(), 0.0),
                      build_schedule("noam", **SCHEDULE), make_loss_fn(cfg),
                      grad_clip=0.5)
    opt_state = tx.init(params)
    for i in range(2):
        jbatch, tbatch = pb._batch(name, shift=i)
        params, opt_state, want_loss, want_gnorm = jstep(
            params, opt_state, jbatch, None)
        loss, gnorm = tstep(tbatch)
        np.testing.assert_allclose(loss.item(), float(want_loss),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(gnorm.item(), float(want_gnorm),
                                   rtol=STEP_RTOL)
    pb._assert_tree_close(convert.params_to_jax(model), params, STEP_RTOL,
                          STEP_ATOL)
    # the optimizer state crosses in optax's leaf order, "b" leaves present
    leaves = convert.opt_state_to_leaves(model, tstep.optimizer, tstep.count)
    want_leaves = jax.tree_util.tree_leaves(opt_state)
    assert [l.shape for l in leaves] == [np.shape(l) for l in want_leaves]
    n_params = sum(1 for _ in model.parameters())
    assert len(leaves) == 2 * n_params + 2
    assert n_params == (10 if cfg.encoder.bias else 8)
    for got, want in zip(leaves, want_leaves):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-7)
    # and back: what is written is what is read
    fresh = convert.load_jax_params(MoleculeModel(cfg),
                                    convert.params_to_jax(model))
    opt = build_optimizer("adam", fresh.parameters(), 0.0)
    assert convert.opt_state_from_leaves(fresh, opt, leaves) == 2
    for a, b in zip(convert.opt_state_to_leaves(fresh, opt, 2), leaves):
        np.testing.assert_array_equal(a, b)


# -- training as a whole ----------------------------------------------------

def _log(save_dir):
    path = os.path.join(save_dir, "fold_0", "model_0",
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


def _run_both(root, option, **extra):
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    kw = dict(data_path=REGRESSION, dataset_type="regression",
              grad_clip=2.0, **SMALL, **{option: True}, **extra)
    port = cross_validate(TrainConfig(save_dir=port_dir, device="cpu", **kw))
    jax_ = jax_cross_validate(JaxTrainConfig(save_dir=jax_dir, **kw))
    return port_dir, jax_dir, port, jax_, kw


@pytest.fixture(scope="module")
def bias_runs(tmp_path_factory):
    """One 2-epoch ``bias=True`` run of each package on the same 60
    molecules."""
    return _run_both(tmp_path_factory.mktemp("bias_runs"), "bias")


def test_cross_validate_with_bias_matches_jax_package(bias_runs):
    port_dir, jax_dir, port, jax_, _ = bias_runs
    np.testing.assert_allclose(port, jax_, rtol=RTOL)
    _assert_logs_close(_log(port_dir), _log(jax_dir))
    ckpt = os.path.join(port_dir, "fold_0", "model_0", "model.ckpt")
    params, config, _, _ = load_checkpoint(ckpt)
    assert config["bias"] is True
    # the biases were trained: the reference init starts them at zero
    for layer in ("W_i", "W_h"):
        assert np.abs(params["encoders"][0][layer]["b"]).max() > 0
    # count, mu and nu of 10 parameters, count
    assert len(load_opt_leaves(ckpt)) == 22


def test_cross_validate_undirected_matches_jax_package(tmp_path):
    # on the CPU the JAX package trains through XLA in FP32, whatever its
    # band_precision: the port's layer says "highest" to compute the same
    port_dir, jax_dir, port, jax_, _ = _run_both(
        tmp_path, "undirected", band_precision="highest")
    np.testing.assert_allclose(port, jax_, rtol=RTOL)
    _assert_logs_close(_log(port_dir), _log(jax_dir))


def test_bias_checkpoint_predicts_the_same_through_both_packages(
        bias_runs, tmp_path):
    ckpt = os.path.join(bias_runs[0], "fold_0", "model_0", "best_model.ckpt")
    test_path = os.path.join(DATA, "regression_test_smiles.csv")
    got = make_predictions(PredictConfig(
        test_path=test_path, checkpoint_path=ckpt, num_workers=1,
        preds_path=str(tmp_path / "port.csv"), device="cpu"))
    want = jax_make_predictions(JaxPredictConfig(
        test_path=test_path, checkpoint_path=ckpt, num_workers=1,
        preds_path=str(tmp_path / "jax.csv")))
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_bias_resume_across_packages(bias_runs, tmp_path, writer, reader):
    """Resume a third epoch from the ``bias=True`` ``model.ckpt`` that
    ``writer`` wrote after epoch 1, in ``reader``; the JAX package resuming
    from its own checkpoint is the reference."""
    port_dir, jax_dir, _, _, kw = bias_runs
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
        assert "at epoch 2" in text and "Epoch 2:" in text
        saved = os.path.join(out, "fold_0", "model_0", "model.ckpt")
        line = [l for l in text.splitlines() if l.startswith("Epoch 2:")][0]
        loss = float(line.split("train loss = ")[1].split(",")[0])
        return loss, load_checkpoint(saved), load_opt_leaves(saved)

    want_loss, want_ckpt, want_opt = resume("jax", jax_dir,
                                            str(tmp_path / "ref"))
    src = port_dir if writer == "port" else jax_dir
    loss, got_ckpt, got_opt = resume(reader, src, str(tmp_path / "got"))
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    assert got_ckpt[3] == want_ckpt[3] == 2          # the saved epoch
    # 10 updates before the resume + 5 after it, with the moments carried
    assert int(got_opt[0]) == int(want_opt[0]) == 15
    assert len(got_opt) == len(want_opt) == 22
    for a, b in zip(got_opt, want_opt):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-7)
    for layer in ("W_i", "W_h"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(
                got_ckpt[0]["encoders"][0][layer][leaf],
                want_ckpt[0]["encoders"][0][layer][leaf], rtol=RTOL,
                atol=1e-6)


def test_cli_takes_bias_undirected_and_bf16(tmp_path):
    run = tmp_path / "run"
    cli.main(["train", "--data_path", REGRESSION, "--dataset_type",
              "regression", "--save_dir", str(run), "--epochs", "1",
              "--max_data_size", "30", "--hidden_size", "16", "--quiet",
              "--num_workers", "1", "--bias", "--undirected",
              "--param_dtype", "bf16", "--device", "cpu"])
    rows = _log(str(run))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["train_loss"]))
    _, config, _, _ = load_checkpoint(
        str(run / "fold_0" / "model_0" / "best_model.ckpt"))
    assert config["bias"] and config["undirected"]
    assert config["param_dtype"] == "bf16"
    preds = tmp_path / "preds.csv"
    cli.main(["predict", "--test_path",
              os.path.join(DATA, "regression_test_smiles.csv"),
              "--checkpoint_dir", str(run), "--preds_path", str(preds),
              "--num_workers", "1", "--device", "cpu"])
    with open(preds) as f:
        values = [float(r[1]) for r in list(csv.reader(f))[1:]]
    assert values and np.isfinite(values).all()
