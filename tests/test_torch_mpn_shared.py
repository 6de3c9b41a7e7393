"""``mpn_shared`` checkpoints written by the JAX package, through the port.

The JAX package lists one encoder per molecule position even when they are
shared, and its optimizer updates each copy on its own position's
gradient, so a file it trained can hold copies that differ. The port
serves such a file as the JAX package computes it (one encoder per
position) and refuses to train on from it, since its shared model holds one
encoder.

Files are written with the JAX package's ``init_model`` and
``save_checkpoint`` at hidden 32, depth 2, two molecules, no training:
"equal" is one ``init_model`` (the copies equal, as in an untrained file),
"differing" replaces copy 1 with the copy 0 of another key. Predictions
and both fingerprint types are held to the JAX package at rtol 1e-5,
the tolerance of tests/test_torch_predict.py (FP32, sums in another order).
"""

import csv
import os

import jax
import numpy as np
import pytest

from polymer_chemprop_tpu.config import PredictConfig as JaxPredictConfig
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.models import init_model
from polymer_chemprop_tpu.train.make_predictions import (
    make_predictions as jax_make_predictions,
)
from polymer_chemprop_tpu.train.molecule_fingerprint import (
    FingerprintConfig as JaxFingerprintConfig,
)
from polymer_chemprop_tpu.train.molecule_fingerprint import (
    molecule_fingerprint as jax_molecule_fingerprint,
)
from polymer_chemprop_tpu.train.trainer import build_model_config
from polymer_chemprop_tpu.utils.checkpoint import save_checkpoint
from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
from polymer_chemprop_tpu_torch.data import MoleculeDataLoader, get_data
from polymer_chemprop_tpu_torch.models.convert import (
    encoder_copies_differ,
    load_jax_params,
    params_from_jax,
)
from polymer_chemprop_tpu_torch.models.model import (
    MoleculeModel,
    build_model_config as port_build_model_config,
)
from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
from polymer_chemprop_tpu_torch.train.make_predictions import (
    load_model,
    make_predictions,
    serving_model,
)
from polymer_chemprop_tpu_torch.train.molecule_fingerprint import (
    FingerprintConfig,
    molecule_fingerprint,
)
from polymer_chemprop_tpu_torch.train.predict import predict
from polymer_chemprop_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
RTOL, ATOL = 1e-5, 1e-6
MODEL = dict(hidden_size=32, depth=2, ffn_num_layers=2, ffn_hidden_size=32,
             number_of_molecules=2, mpn_shared=True,
             band_precision="highest")
FILES = ("equal", "differing")
DIFFERS = r"encoders\[1\]\.W_h\.w differs from encoders\[0\]\.W_h\.w"


def _params(differing: bool, **model):
    tcfg = JaxTrainConfig(target_columns=["y"], **dict(MODEL, **model))
    mcfg = build_model_config(tcfg, 1)
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(21), mcfg))
    if differing:
        other = jax.tree_util.tree_map(
            np.asarray, init_model(jax.random.PRNGKey(22), mcfg))
        params["encoders"] = [params["encoders"][0], other["encoders"][0]]
    return params, tcfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The two checkpoints, a one-molecule one to start from, and a
    two-molecule CSV with a target."""
    root = tmp_path_factory.mktemp("mpn_shared")
    with open(os.path.join(DATA, "regression.csv")) as f:
        rows = list(csv.reader(f))[1:31]
    smiles = [r[0] for r in rows]
    csv_path = root / "pairs.csv"
    csv_path.write_text("solvent,solute,y\n" + "".join(
        f"{a},{b},{r[1]}\n" for a, b, r in zip(smiles, smiles[::-1], rows)))
    out = {"csv": str(csv_path), "root": root}
    for name in FILES + ("one_molecule",):
        params, tcfg = _params(name == "differing", **(
            dict(number_of_molecules=1, mpn_shared=False)
            if name == "one_molecule" else {}))
        path = str(root / name / "model.ckpt")
        save_checkpoint(path, params, tcfg.to_dict(), epoch=0)
        out[name] = path
    return out


def _serve(package, files, names, output, tag):
    """Predictions or fingerprints of the CSV's rows from the ensemble of
    ``names`` through one package's entry point."""
    out = str(files["root"] / f"{package}_{tag}.csv")
    kw = dict(test_path=files["csv"], preds_path=out, num_workers=1,
              checkpoint_paths=[files[n] for n in names],
              number_of_molecules=2)
    if package == "port":
        kw["device"] = "cpu"
    if output == "preds":
        cfg = PredictConfig if package == "port" else JaxPredictConfig
        run = make_predictions if package == "port" else jax_make_predictions
        return np.asarray(run(cfg(**kw)), float)
    cfg = FingerprintConfig if package == "port" else JaxFingerprintConfig
    run = molecule_fingerprint if package == "port" \
        else jax_molecule_fingerprint
    return np.asarray(run(cfg(fingerprint_type=output, **kw)), float)


@pytest.mark.parametrize("output", ["preds", "MPN", "last_FFN"])
@pytest.mark.parametrize("members", [["differing"], ["equal"],
                                     ["differing", "equal"]],
                         ids=["differing", "equal", "ensemble"])
def test_served_outputs_match_jax(files, members, output):
    tag = f"{output}_{'_'.join(members)}"
    got = _serve("port", files, members, output, tag)
    want = _serve("jax", files, members, output, tag)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if "differing" in members:
        # copy 0 at both positions (what the port served before) is another
        # model: the comparison above would catch it
        copy0 = _serve("port", files, ["equal"] * len(members), output,
                       tag + "_copy0")
        assert np.max(np.abs(copy0 - want)) > 1e3 * (
            ATOL + RTOL * np.max(np.abs(want)))


def test_equal_copies_serve_the_shared_function(files):
    """Serving's one-encoder-per-position model computes, bit for bit, what
    the shared model computes from a file whose copies are equal."""
    params, tcfg, _ = load_model(files["equal"])
    fcfg = tcfg.featurization()
    data = get_data(files["csv"], number_of_molecules=2, config=fcfg)
    model_cfg = port_build_model_config(tcfg, 1, data=data)
    assert model_cfg.mpn_shared
    shared = load_jax_params(MoleculeModel(model_cfg), params).eval()
    served = load_jax_params(serving_model(model_cfg), params).eval()
    assert len(shared.encoders) == 1 and len(served.encoders) == 2
    loader = MoleculeDataLoader(data, fcfg, batch_size=50, num_workers=1)
    got, got_emb = predict(served, loader, "cpu", return_embeddings=True)
    want, want_emb = predict(shared, loader, "cpu", return_embeddings=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(got_emb, want_emb)


@pytest.mark.parametrize("name", FILES)
def test_params_from_jax_refuses_copies_that_differ(files, name):
    params, _, _, _ = load_checkpoint(files[name])
    differ = encoder_copies_differ(params)
    # both copies are served as they are
    state = params_from_jax(params)
    for i in range(2):
        np.testing.assert_array_equal(
            state[f"encoders.{i}.W_h.weight"].numpy(),
            params["encoders"][i]["W_h"]["w"].T)
    if name == "equal":
        assert differ is None
        state = params_from_jax(params, mpn_shared=True)
        assert not any(k.startswith("encoders.1.") for k in state)
        return
    want = np.max(np.abs(params["encoders"][1]["W_h"]["w"].astype(float)
                         - params["encoders"][0]["W_h"]["w"]))
    assert differ.endswith(f"by up to {want:.6g}")
    with pytest.raises(ValueError, match=DIFFERS):
        params_from_jax(params, mpn_shared=True)


START = {"resume": lambda p: dict(resume_from_checkpoint=p),
         "warm_start": lambda p: dict(checkpoint_paths=[p]),
         "checkpoint_frzn": lambda p: dict(checkpoint_frzn=p,
                                           frzn_encoder=True)}


@pytest.mark.parametrize("start,name", [
    (start, name) for start in START for name in FILES + ("one_molecule",)
    if (start, name) != ("resume", "one_molecule")])
def test_training_on_from_a_jax_file(files, tmp_path, start, name):
    """A file whose copies differ is refused by every way of training on
    from it, with the parameter named; one whose copies are equal trains
    on as before, and a one-molecule file's encoder starts every position
    (the reference's encoder 0 into the shared module)."""
    save_dir = str(tmp_path / "run")
    cfg = TrainConfig(data_path=files["csv"], dataset_type="regression",
                      save_dir=save_dir, device="cpu", epochs=2,
                      batch_size=10, num_workers=1, quiet=True,
                      **START[start](files[name]), **MODEL)
    if name == "differing":
        with pytest.raises(ValueError, match=DIFFERS):
            cross_validate(cfg)
        return
    score, _ = cross_validate(cfg)
    assert np.isfinite(score)
    with open(os.path.join(save_dir, "verbose.log")) as f:
        log = f.read()
    trained, _, _, _ = load_checkpoint(
        os.path.join(save_dir, "fold_0", "model_0", "model.ckpt"))
    assert encoder_copies_differ(trained) is None
    if start == "resume":
        assert "at epoch 1" in log
        return
    loaded, _, _, _ = load_checkpoint(files[name])
    if start == "warm_start":
        # every leaf of the model, but the one-molecule file's first FFN
        # weight (32 inputs, not 64)
        n = len(jax.tree_util.tree_leaves(trained))
        fresh = int(name == "one_molecule")
        assert f"({n - fresh} parameters loaded, {fresh} kept fresh)" in log
    else:
        for i in range(2):
            np.testing.assert_array_equal(
                trained["encoders"][i]["W_h"]["w"],
                loaded["encoders"][0]["W_h"]["w"])
