"""The port's extra features vs the JAX package's, on the CPU.

* the four features generators (``morgan``, ``morgan_count``, ``rdkit_2d``,
  ``rdkit_2d_normalized``) on aromatic, charged, polymer, reaction and
  invalid strings, and ``rdkit_2d`` through the Python engine on
  ``Molecule`` inputs: equal bit for bit;
* feature files (``.npz``, ``.csv``), per-atom/bond ``.npz`` files and
  ``get_data`` with every extra input, the three feature scalers included:
  equal;
* the loader's arrays with extra atom and/or bond features and the two
  ``overwrite_default_*`` flags, on the C++ and the Python loader: equal
  bit for bit to the JAX package's Python loader;
* the model forward with molecule features, atom descriptors (both
  modes), bond extras, ``features_only`` and ``atom_messages`` with
  descriptors: rtol 1e-5 at ``band_precision="highest"`` and 1e-4 at
  "high" (the JAX package's own tolerance for "high"); the gradients of
  one loss: rtol 1e-4;
* 2-epoch ``cross_validate`` (hidden 32, 60 molecules) with
  ``rdkit_2d_normalized``, descriptors plus bond features, spectra with
  phase features and a phase mask, and ``features_only``: test scores
  within 1e-4 relative; checkpoints with scalers cross in both directions
  through ``make_predictions`` and ``molecule_fingerprint``: rtol 1e-5.

The port runs with ``device="cpu"``.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.chem import parse_smiles as jax_parse_smiles
from polymer_chemprop_tpu.config import PredictConfig as JaxPredictConfig
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.data import MoleculeDataLoader as JaxLoader
from polymer_chemprop_tpu.data import get_data as jax_get_data
from polymer_chemprop_tpu.features import FeaturizationConfig as JaxFcfg
from polymer_chemprop_tpu.features import MolGraph as JaxMolGraph
from polymer_chemprop_tpu.features import batch_graphs as jax_batch_graphs
from polymer_chemprop_tpu.features import generators as jax_generators
from polymer_chemprop_tpu.features import utils as jax_futils
from polymer_chemprop_tpu.models import EncoderConfig as JaxEncoderConfig
from polymer_chemprop_tpu.models import ModelConfig as JaxModelConfig
from polymer_chemprop_tpu.models import apply_model, init_model
from polymer_chemprop_tpu.train.cross_validate import (
    cross_validate as jax_cross_validate,
)
from polymer_chemprop_tpu.train.make_predictions import (
    make_predictions as jax_make_predictions,
)
from polymer_chemprop_tpu.train.molecule_fingerprint import (
    FingerprintConfig as JaxFingerprintConfig,
)
from polymer_chemprop_tpu.train.molecule_fingerprint import (
    molecule_fingerprint as jax_molecule_fingerprint,
)
from polymer_chemprop_tpu.train.step import make_loss_fn as jax_make_loss_fn
from polymer_chemprop_tpu_torch.chem import parse_smiles
from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
from polymer_chemprop_tpu_torch.data import MoleculeDataLoader, get_data
from polymer_chemprop_tpu_torch.features import (
    FeaturizationConfig,
    MolGraph,
    batch_graphs,
)
from polymer_chemprop_tpu_torch.features import generators
from polymer_chemprop_tpu_torch.features import utils as futils
from polymer_chemprop_tpu_torch.models import convert
from polymer_chemprop_tpu_torch.models.encoder import (
    EncoderConfig,
    batch_to_tensors,
)
from polymer_chemprop_tpu_torch.models.model import ModelConfig, MoleculeModel
from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
from polymer_chemprop_tpu_torch.train.make_predictions import make_predictions
from polymer_chemprop_tpu_torch.train.molecule_fingerprint import (
    FingerprintConfig,
    molecule_fingerprint,
)
from polymer_chemprop_tpu_torch.train.step import make_loss_fn
from polymer_chemprop_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DATA = os.path.join(os.path.dirname(__file__), "data")
REGRESSION = os.path.join(DATA, "regression.csv")
GEN_SMILES = ["CCO", "c1ccccc1O", "C[N+](C)(C)C", "CC(=O)[O-]",
              "c1ccc2[nH]ccc2c1", "O=C(O)c1ccncc1", "C1CCC1", "FC(F)(F)Cl",
              "[*:1]CC[*:2].[*:3]CO[*:4]|0.5|0.5|<1-3:0.5:0.5<2-4:0.5:0.5~20",
              "[CH3:1][OH:2]>>[CH2:1]=[O:2]", "C1CC", "S=C=S"]
SMALL = dict(hidden_size=32, depth=3, ffn_num_layers=2, epochs=2,
             batch_size=10, max_data_size=60, num_workers=1, quiet=True)


def _rows(n):
    with open(REGRESSION) as f:
        return list(csv.reader(f))[:n + 1]


@pytest.fixture(scope="module")
def extras(tmp_path_factory):
    """A 60-row regression CSV, one random (atoms, 3) and (bonds, 2) array
    per molecule from a numpy seed (sized from the parser's counts), and
    a 60 x 5 molecule feature file in .npz and .csv."""
    root = tmp_path_factory.mktemp("extras")
    rows = _rows(60)
    with open(root / "data.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    rng = np.random.default_rng(0)
    atoms, bonds = {}, {}
    for i, row in enumerate(rows[1:]):
        m = parse_smiles(row[0])
        atoms[f"arr_{i}"] = rng.normal(size=(m.n_atoms, 3))
        bonds[f"arr_{i}"] = rng.normal(size=(m.n_bonds, 2))
    np.savez(root / "atoms.npz", **atoms)
    np.savez(root / "bonds.npz", **bonds)
    feats = rng.normal(size=(60, 5))
    feats[3, 1] = np.nan
    futils.save_features(str(root / "feats.npz"), feats)
    with open(root / "feats.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([f"f{i}" for i in range(5)])
        w.writerows(feats.tolist())
    return {k: str(root / v) for k, v in (
        ("csv", "data.csv"), ("atoms", "atoms.npz"), ("bonds", "bonds.npz"),
        ("npz", "feats.npz"), ("feats_csv", "feats.csv"), ("root", "."))}


# -- generators --------------------------------------------------------------

@pytest.mark.parametrize("name", ["morgan", "morgan_count", "rdkit_2d",
                                  "rdkit_2d_normalized"])
def test_generators_match_jax_package(name):
    gen = generators.get_features_generator(name)
    jgen = jax_generators.get_features_generator(name)
    inputs = [generators.generator_input_smiles(s) for s in GEN_SMILES]
    assert inputs == [jax_generators.generator_input_smiles(s)
                      for s in GEN_SMILES]
    assert inputs[8] == "[*:1]CC[*:2].[*:3]CO[*:4]"
    assert inputs[9] == "[CH3:1][OH:2]"
    for s in inputs:
        got, want = gen(s), jgen(s)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=s)
    if name.startswith("rdkit"):
        # the batched C++ call and its caches serve the same vectors
        generators.precompute_rdkit2d_batch(GEN_SMILES, n_threads=2)
        for s in inputs:
            np.testing.assert_array_equal(gen(s), jgen(s), err_msg=s)


def test_rdkit_2d_python_engine_on_molecules():
    names = ["CC(=O)Oc1ccccc1C(=O)O", "C[N+](C)(C)CC(=O)[O-]", "ClC=CBr"]
    gen = generators.get_features_generator("rdkit_2d")
    jgen = jax_generators.get_features_generator("rdkit_2d")
    generators.python_engine_count(reset=True)
    for s in names:
        np.testing.assert_array_equal(gen(parse_smiles(s)),
                                      jgen(jax_parse_smiles(s)))
    assert generators.python_engine_count(reset=True) == 3
    # strings go to the C++ engine in both packages
    for s in names:
        np.testing.assert_array_equal(gen(s), jgen(s))
    assert generators.python_engine_count() == 0
    with pytest.raises(ValueError, match="could not be found"):
        generators.get_features_generator("rdkit_3d")


# -- files and data ----------------------------------------------------------

def test_feature_files_match_jax_package(extras):
    for key in ("npz", "feats_csv"):
        got = futils.load_features(extras[key])
        np.testing.assert_array_equal(got, jax_futils.load_features(
            extras[key]))
        assert got.shape == (60, 5)
    smiles = [r[0] for r in _rows(60)[1:]]
    for key in ("atoms", "bonds"):
        got = futils.load_valid_atom_or_bond_features(extras[key], smiles)
        want = jax_futils.load_valid_atom_or_bond_features(extras[key],
                                                           smiles)
        assert len(got) == len(want) == 60
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="mismatch"):
        futils.load_valid_atom_or_bond_features(extras["atoms"], smiles[:5])


def _assert_datasets_equal(data, jdata):
    assert len(data) == len(jdata)
    assert data.features_size() == jdata.features_size()
    assert data.atom_descriptors_size() == jdata.atom_descriptors_size()
    for d, j in zip(data, jdata):
        assert d.smiles == j.smiles and d.targets == j.targets
        for attr in ("features", "phase_features", "atom_features",
                     "atom_descriptors", "bond_features"):
            a, b = getattr(d, attr), getattr(j, attr)
            assert (a is None) == (b is None), attr
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=attr)


@pytest.mark.parametrize("case", ["features", "phases", "descriptor",
                                  "feature_and_bonds"])
def test_get_data_and_scalers_match_jax_package(extras, case):
    kw = {
        "features": dict(features_path=[extras["npz"], extras["feats_csv"]],
                         features_generators=["morgan_count",
                                              "rdkit_2d_normalized"]),
        "phases": dict(features_path=[extras["npz"]]),
        "descriptor": dict(atom_descriptors="descriptor",
                           atom_descriptors_path=extras["atoms"]),
        "feature_and_bonds": dict(atom_descriptors="feature",
                                  atom_descriptors_path=extras["atoms"],
                                  bond_features_path=extras["bonds"]),
    }[case]
    path = extras["csv"]
    if case == "phases":
        path = os.path.join(DATA, "spectra.csv")
        kw = dict(phase_features_path=os.path.join(
            DATA, "spectra_features.csv"), max_data_size=40)
    data, jdata = get_data(path, **kw), jax_get_data(path, **kw)
    _assert_datasets_equal(data, jdata)
    if case == "features":
        assert data.features_size() == 5 + 5 + 2048 + 200
        assert np.isfinite(np.stack(data.features())).all()  # NaN -> 0
    if case == "phases":
        assert data.phase_features() is not None
        assert data.features_size() == 5
    # the scalers: fit on the data, then applied, in float64
    for flags in (dict(), dict(scale_atom_descriptors=True),
                  dict(scale_bond_features=True)):
        scaler = data.normalize_features(replace_nan_token=0, **flags)
        jscaler = jdata.normalize_features(replace_nan_token=0, **flags)
        assert (scaler is None) == (jscaler is None)
        if scaler is not None:
            np.testing.assert_array_equal(scaler.means, jscaler.means)
            np.testing.assert_array_equal(scaler.stds, jscaler.stds)
    _assert_datasets_equal(data, jdata)
    data.reset_features_and_targets()
    jdata.reset_features_and_targets()
    _assert_datasets_equal(data, jdata)


def test_phase_features_must_be_one_hot(tmp_path):
    bad = tmp_path / "phases.csv"
    with open(os.path.join(DATA, "spectra_features.csv")) as f:
        lines = f.read().splitlines()
    lines[2] = "1,1,0,0,0"
    bad.write_text("\n".join(lines) + "\n")
    path = os.path.join(DATA, "spectra.csv")
    for load in (get_data, jax_get_data):
        with pytest.raises(ValueError, match="must be one-hot encoded"):
            load(path, phase_features_path=str(bad), max_data_size=10)


# -- the loader ----------------------------------------------------------------

LOADER_CASES = {
    "atom": dict(atom_descriptors="feature"),
    "bond": dict(bond=True),
    "both": dict(atom_descriptors="feature", bond=True),
    "overwrite_atom": dict(atom_descriptors="feature",
                           overwrite_default_atom_features=True),
    "overwrite_bond": dict(bond=True, overwrite_default_bond_features=True),
}


@pytest.mark.parametrize("native", [True, False], ids=["cxx", "python"])
@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_arrays_with_extras_match_jax_package(extras, case, native):
    kw = dict(LOADER_CASES[case])
    data_kw = {}
    if "atom_descriptors" in kw:
        data_kw.update(atom_descriptors=kw.pop("atom_descriptors"),
                       atom_descriptors_path=extras["atoms"])
    if kw.pop("bond", False):
        data_kw["bond_features_path"] = extras["bonds"]
    data = get_data(extras["csv"], max_data_size=23, **data_kw)
    jdata = jax_get_data(extras["csv"], max_data_size=23, **data_kw)
    loader = MoleculeDataLoader(data, FeaturizationConfig(**kw),
                                batch_size=10, num_workers=1,
                                use_native=native)
    assert loader.use_native == native
    jloader = JaxLoader(jdata, JaxFcfg(**kw), batch_size=10, num_workers=1,
                        use_native=False)
    batches, jbatches = list(loader), list(jloader)
    assert [b.size for b in batches] == [10, 10, 3]
    for b, jb in zip(batches, jbatches):
        g, jg = b.graph_arrays[0], jb.graph_arrays[0]
        perm = g["sorted_aux"]["perm"]
        for key in ("f_atoms", "w_atoms", "b2a", "b2dst", "a2mol"):
            np.testing.assert_array_equal(g[key], jg[key], err_msg=key)
        np.testing.assert_array_equal(g["f_bonds"], jg["f_bonds"][perm])
    width = batches[0].graph_arrays[0]["f_atoms"].shape[1]
    assert width == {"atom": 136, "both": 136, "overwrite_atom": 3}.get(
        case, 133)


def test_python_path_for_polymers_with_extras(extras):
    """Extras on a polymer take the Python loader, as in the JAX
    package; without extras the C++ loader stays on."""
    data = get_data(extras["csv"], max_data_size=5,
                    atom_descriptors="feature",
                    atom_descriptors_path=extras["atoms"])
    assert not MoleculeDataLoader(data, FeaturizationConfig(polymer=True),
                                  num_workers=1).use_native
    assert MoleculeDataLoader(data, FeaturizationConfig(),
                              num_workers=1).use_native
    plain = get_data(extras["csv"], max_data_size=5)
    assert MoleculeDataLoader(plain, FeaturizationConfig(polymer=True),
                              num_workers=1).use_native


# -- the model ---------------------------------------------------------------

MODEL_SMILES = ["CCO", "c1ccccc1", "CC(C)=CCCC(C)=CC(=O)", "C",
                "CCOc1ccc2nc(S(N)(=O)=O)sc2c1", "C[N+](C)(C)CC(=O)[O-]"]
MODEL_CASES = {
    "input_features": dict(features=7),
    "descriptor": dict(descriptors=4),
    "feature_mode": dict(atom_extra=3),
    "bond_extras": dict(bond_extra=2, features=3),
    "features_only": dict(features=7, features_only=True),
    "atom_messages_descriptor": dict(descriptors=4, atom_messages=True),
}


def _model_inputs(case, precision):
    """(JAX ModelConfig, port ModelConfig, JAX batch, port batch) for one
    case: 6 molecules, hidden 32, 2 tasks, random extras from a seed."""
    spec = MODEL_CASES[case]
    rng = np.random.default_rng(1)
    E, Eb = spec.get("atom_extra", 0), spec.get("bond_extra", 0)
    D, F = spec.get("descriptors", 0), spec.get("features", 0)
    mols = [parse_smiles(s) for s in MODEL_SMILES]
    atom_x = [rng.normal(size=(m.n_atoms, E)) for m in mols] if E else None
    bond_x = [rng.normal(size=(m.n_bonds, Eb)) for m in mols] if Eb else None
    fcfg = dict(extra_atom_fdim=E, extra_bond_fdim=Eb)
    am = spec.get("atom_messages", False)
    graphs, jgraphs = [], []
    for i, s in enumerate(MODEL_SMILES):
        ax = atom_x[i] if E else None
        bx = bond_x[i] if Eb else None
        graphs.append(MolGraph(s, FeaturizationConfig(**fcfg),
                               atom_features_extra=ax,
                               bond_features_extra=bx))
        jgraphs.append(JaxMolGraph(s, JaxFcfg(**fcfg),
                                   atom_features_extra=ax,
                                   bond_features_extra=bx))
    pad = dict(pad_atoms=256, pad_bonds=512, pad_mols=8)
    gb, jgb = batch_graphs(graphs, **pad), jax_batch_graphs(jgraphs, **pad)
    enc = dict(atom_fdim=133 + E, bond_fdim=(0 if am else 133 + E) + 14 + Eb,
               hidden_size=32, depth=3, band_precision=precision,
               atom_messages=am,
               atom_descriptors="descriptor" if D else
               ("feature" if E else None), atom_descriptors_size=D)
    model_kw = dict(dataset_type="regression", num_tasks=2, ffn_num_layers=2,
                    ffn_hidden_size=32, features_size=F,
                    features_only=spec.get("features_only", False),
                    use_input_features=F > 0,
                    atom_descriptors=enc["atom_descriptors"],
                    atom_descriptors_size=D)
    jcfg = JaxModelConfig(encoder=JaxEncoderConfig(**enc), **model_kw)
    cfg = ModelConfig(encoder=EncoderConfig(**enc), **model_kw)
    feats = rng.normal(size=(8, F)).astype(np.float32) if F else None
    desc = np.zeros((256, D), np.float32) if D else None
    if D:
        desc[1:gb.n_atoms_real] = rng.normal(size=(gb.n_atoms_real - 1, D))
    targets = rng.normal(size=(8, 2)).astype(np.float32)
    mask = np.ones((8, 2), np.float32)
    mask[6:] = 0
    weights = mask[:, :1].copy()
    jbatch = {"graphs": [jax.tree_util.tree_map(jnp.asarray,
                                                jgb.arrays(pallas=False))],
              "targets": jnp.asarray(targets), "mask": jnp.asarray(mask),
              "weights": jnp.asarray(weights)}
    tbatch = {"graphs": [batch_to_tensors(gb.arrays(sorted_aux=True),
                                          "cpu")],
              "targets": torch.from_numpy(targets),
              "mask": torch.from_numpy(mask),
              "weights": torch.from_numpy(weights)}
    natural = batch_to_tensors(gb.arrays(), "cpu")
    if F:
        jbatch["features"] = jnp.asarray(feats)
        tbatch["features"] = torch.from_numpy(feats)
    if D:
        jbatch["atom_descriptors"] = jnp.asarray(desc)
        tbatch["atom_descriptors"] = torch.from_numpy(desc)
    return jcfg, cfg, jbatch, tbatch, natural


@pytest.mark.parametrize("precision,rtol", [("highest", 1e-5),
                                            ("high", 1e-4)])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_forward_matches_jax_package(case, precision, rtol):
    jcfg, cfg, jbatch, tbatch, natural = _model_inputs(case, precision)
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(2), jcfg))
    assert ("encoders" in params) == (case != "features_only")
    if "descriptor" in case:
        assert params["encoders"][0]["W_d"]["w"].shape == (36, 36)
    model = convert.load_jax_params(MoleculeModel(cfg), params).eval()
    want = np.asarray(apply_model(
        params, jbatch["graphs"], jcfg, features=jbatch.get("features"),
        atom_descriptors=jbatch.get("atom_descriptors")))
    # both branches of the port: the kernels' (sorted) and the reference
    for graphs in (tbatch["graphs"], [natural]):
        with torch.inference_mode():
            got = model(graphs, features=tbatch.get("features"),
                        atom_descriptors=tbatch.get("atom_descriptors"))
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol)
    # the parameter tree round-trips, W_d transposed once each way
    back = convert.params_to_jax(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(back))[path], leaf)


@pytest.mark.parametrize("case", ["input_features", "descriptor",
                                  "bond_extras", "features_only"])
def test_model_gradients_match_jax_grad(case):
    jcfg, cfg, jbatch, tbatch, _ = _model_inputs(case, "highest")
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(4), jcfg))
    model = convert.load_jax_params(MoleculeModel(cfg), params)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_make_loss_fn(jcfg)(p, jbatch, None))(params)
    model.train()
    loss = make_loss_fn(cfg)(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = convert._param_tree(model,
                              lambda p: convert._to_jax_layout(p.grad))
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(got_flat[path], np.asarray(leaf),
                                   rtol=1e-4, atol=1e-6, err_msg=str(path))


# -- training and serving ------------------------------------------------------

def _train_cases(extras):
    spectra = os.path.join(DATA, "spectra.csv")
    return {
        "rdkit_2d_normalized": dict(
            data_path=REGRESSION, features_generator=["rdkit_2d_normalized"],
            no_features_scaling=True),
        "descriptor_bonds": dict(
            data_path=extras["csv"], atom_descriptors="descriptor",
            atom_descriptors_path=extras["atoms"],
            bond_features_path=extras["bonds"]),
        "spectra": dict(
            data_path=spectra, dataset_type="spectra", split_type="random",
            phase_features_path=os.path.join(DATA, "spectra_features.csv"),
            spectra_phase_mask_path=os.path.join(DATA, "spectra_mask.csv")),
        "features_only": dict(data_path=REGRESSION,
                              features_generator=["morgan"],
                              features_only=True),
    }


@pytest.fixture(scope="module")
def runs(extras, tmp_path_factory):
    """One 2-epoch cross_validate of each package per training case."""
    root = tmp_path_factory.mktemp("feature_runs")
    out = {}
    for name, kw in _train_cases(extras).items():
        kw = dict(SMALL, **kw)
        port_dir, jax_dir = str(root / f"port_{name}"), str(root / f"jax_{name}")
        port = cross_validate(TrainConfig(save_dir=port_dir, device="cpu",
                                          **kw))
        jax_ = jax_cross_validate(JaxTrainConfig(save_dir=jax_dir, **kw))
        out[name] = (port_dir, jax_dir, port, jax_, kw)
    return out


@pytest.mark.parametrize("case", ["rdkit_2d_normalized", "descriptor_bonds",
                                  "spectra", "features_only"])
def test_cross_validate_matches_jax_package(runs, case):
    port_dir, jax_dir, port, jax_, _ = runs[case]
    np.testing.assert_allclose(port, jax_, rtol=1e-4)
    params, _, scalers, _ = load_checkpoint(
        os.path.join(port_dir, "fold_0", "model_0", "best_model.ckpt"))
    _, _, jscalers, _ = load_checkpoint(
        os.path.join(jax_dir, "fold_0", "model_0", "best_model.ckpt"))
    # the same scalers under the same keys
    for key in ("data_scaler", "features_scaler", "atom_descriptor_scaler",
                "bond_feature_scaler"):
        assert (scalers.get(key) is None) == (jscalers.get(key) is None), key
        if scalers.get(key) is not None:
            np.testing.assert_array_equal(scalers[key].means,
                                          jscalers[key].means)
    assert ("encoders" in params) == (case != "features_only")
    if case == "descriptor_bonds":
        assert scalers["atom_descriptor_scaler"] is not None
        assert scalers["bond_feature_scaler"] is not None
        assert params["encoders"][0]["W_d"]["w"].shape == (35, 35)


def _predict_kw(case, runs, extras):
    kw = dict(num_workers=1)
    if case == "descriptor_bonds":
        kw.update(test_path=extras["csv"],
                  atom_descriptors_path=extras["atoms"],
                  bond_features_path=extras["bonds"])
    elif case == "spectra":
        kw.update(test_path=os.path.join(DATA, "spectra.csv"),
                  phase_features_path=os.path.join(DATA,
                                                   "spectra_features.csv"))
    else:
        kw.update(test_path=extras["csv"])
    return kw


@pytest.mark.parametrize("case", ["rdkit_2d_normalized", "descriptor_bonds",
                                  "spectra", "features_only"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_predict_the_same_in_both_packages(runs, extras, tmp_path,
                                                       case, writer):
    """A checkpoint with its scalers, written by either package, predicts
    the same through both packages' ``make_predictions``."""
    port_dir, jax_dir = runs[case][:2]
    ckpt = os.path.join(port_dir if writer == "port" else jax_dir,
                        "fold_0", "model_0", "best_model.ckpt")
    kw = _predict_kw(case, runs, extras)
    got = make_predictions(PredictConfig(
        checkpoint_path=ckpt, preds_path=str(tmp_path / "p.csv"),
        device="cpu", **kw))
    want = jax_make_predictions(JaxPredictConfig(
        checkpoint_path=ckpt, preds_path=str(tmp_path / "j.csv"), **kw))
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fingerprint_type", ["MPN", "last_FFN"])
def test_fingerprint_from_jax_checkpoint_with_scalers(runs, extras, tmp_path,
                                                      fingerprint_type):
    """``features_only`` with a molecule-feature scaler: the "MPN"
    fingerprint is the scaled features, and both packages agree."""
    ckpt = os.path.join(runs["features_only"][1], "fold_0", "model_0",
                        "best_model.ckpt")
    assert load_checkpoint(ckpt)[2]["features_scaler"] is not None
    kw = dict(test_path=extras["csv"], checkpoint_path=ckpt, num_workers=1,
              fingerprint_type=fingerprint_type)
    got = molecule_fingerprint(FingerprintConfig(
        preds_path=str(tmp_path / "p.csv"), device="cpu", **kw))
    want = jax_molecule_fingerprint(JaxFingerprintConfig(
        preds_path=str(tmp_path / "j.csv"), **kw))
    assert got.shape == want.shape == (
        (60, 2048) if fingerprint_type == "MPN" else (60, 32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_prediction_requires_the_training_inputs(runs, extras, tmp_path):
    ckpt = os.path.join(runs["descriptor_bonds"][0], "fold_0", "model_0",
                        "best_model.ckpt")
    with pytest.raises(ValueError, match="--atom_descriptors_path"):
        make_predictions(PredictConfig(test_path=extras["csv"],
                                       checkpoint_path=ckpt, device="cpu"))
    plain = os.path.join(runs["rdkit_2d_normalized"][0], "fold_0", "model_0",
                         "best_model.ckpt")
    with pytest.raises(ValueError, match="Atom descriptors were not used"):
        make_predictions(PredictConfig(
            test_path=extras["csv"], checkpoint_path=plain, device="cpu",
            atom_descriptors_path=extras["atoms"]))


@pytest.mark.parametrize("case", ["descriptor", "features_only"])
def test_reference_init_matches_jax_package(case):
    """The reference-stream initial weights, W_d included; a
    ``features_only`` model draws the encoders' weights it does not keep,
    as the reference builds them (JAX models/torch_init.py:38-41)."""
    from polymer_chemprop_tpu.models.torch_init import reference_init_params
    from polymer_chemprop_tpu_torch.models.init import reference_init_model
    jcfg, cfg, _, _, _ = _model_inputs(case, "highest")
    want = reference_init_params(jcfg, 7, ensemble_index=1)
    got = convert.params_to_jax(reference_init_model(cfg, 7, 1))
    flat = jax.tree_util.tree_leaves_with_path(want)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat) == len(got_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(got_flat[path], leaf, err_msg=str(path))


def test_separate_sets_take_their_own_feature_files(extras, tmp_path):
    """``separate_val_*`` / ``separate_test_*`` feature and descriptor
    files go to their own sets (JAX trainer.py:205-232)."""
    from polymer_chemprop_tpu_torch.train.trainer import _split
    val_feats = np.arange(300, dtype=float).reshape(60, 5)
    futils.save_features(str(tmp_path / "val.npz"), val_feats)
    cfg = TrainConfig(
        data_path=extras["csv"], separate_val_path=extras["csv"],
        separate_test_path=extras["csv"], features_path=[extras["npz"]],
        separate_val_features_path=[str(tmp_path / "val.npz")],
        atom_descriptors="descriptor",
        atom_descriptors_path=extras["atoms"],
        separate_val_atom_descriptors_path=extras["atoms"],
        separate_test_atom_descriptors_path=extras["atoms"],
        device="cpu")
    data = get_data(extras["csv"], features_path=[extras["npz"]],
                    atom_descriptors="descriptor",
                    atom_descriptors_path=extras["atoms"])
    train, val, test = _split(cfg, data, cfg.featurization())
    assert train is data and len(val) == len(test) == 60
    np.testing.assert_array_equal(np.stack(val.features()), val_feats)
    np.testing.assert_array_equal(np.stack(test.features()),
                                  np.stack(data.features()))
    assert val.atom_descriptors_size() == test.atom_descriptors_size() == 3
