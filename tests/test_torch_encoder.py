"""The port's MoleculeModel vs the JAX package's apply_model.

The same JAX parameters (``init_model`` from a seed) go into both through
``params_from_jax``; the same featurized batch goes through

* JAX ``apply_model`` + ``postprocess_preds`` on its XLA branch and on its
  sorted-resident Pallas branch (interpret mode, ``band_precision
  ="highest"``), and
* the port's ``MoleculeModel`` + ``postprocess_preds`` on its kernel
  branch (dst-sorted, plain versions on the CPU) and its reference branch.

Hidden 32, depth 3, 512 padded bonds. Tolerance rtol 1e-5, atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.features import FeaturizationConfig as JaxFcfg
from polymer_chemprop_tpu.features import mol2graph as jax_mol2graph
from polymer_chemprop_tpu.models import EncoderConfig as JaxEncoderConfig
from polymer_chemprop_tpu.models import ModelConfig as JaxModelConfig
from polymer_chemprop_tpu.models import apply_model, init_model
from polymer_chemprop_tpu.models import postprocess_preds as jax_postprocess
from polymer_chemprop_tpu_torch.features import FeaturizationConfig
from polymer_chemprop_tpu_torch.features import mol2graph
from polymer_chemprop_tpu_torch.models.convert import (
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from polymer_chemprop_tpu_torch.models.encoder import (
    EncoderConfig,
    batch_to_tensors,
)
from polymer_chemprop_tpu_torch.models.model import (
    ModelConfig,
    MoleculeModel,
    postprocess_preds,
)
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
SMILES = ["CCO", "c1ccccc1", "CC(C)=CCCC(C)=CC(=O)", "C",
          "CCOc1ccc2nc(S(N)(=O)=O)sc2c1",
          "OCC3OC(OCC2OC(OC(C#N)c1ccccc1)C(O)C(O)C2O)C(O)C(O)C3O"]
POLYMERS = ["[*:1]CC[*:2].[*:3]CO[*:4]|0.5|0.5|<1-3:0.5:0.5<2-4:0.5:0.5~20",
            "[*:1]c1ccc([*:2])cc1.[*:3]C(C)C[*:4]|0.25|0.75|"
            "<1-3:0.25:0.75<2-4:0.75:0.25~100",
            "[*:1]CC[*:2].[*:3]c1ccc([*:4])cc1C|0.3|0.7|"
            "<1-3:0.5:0.5<2-4:0.5:0.5~7",
            "[*:1]CO[*:2].[*:3]C(C)C[*:4]|0.75|0.25|"
            "<1-3:0.5:0.5<2-4:0.5:0.5~2"]

CASES = {
    "regression": dict(dataset_type="regression", num_tasks=2),
    "classification": dict(dataset_type="classification", num_tasks=3),
    "multiclass": dict(dataset_type="multiclass", num_tasks=2,
                       multiclass_num_classes=3),
    "spectra": dict(dataset_type="spectra", num_tasks=5),
    "polymer": dict(dataset_type="regression", num_tasks=1, polymer=True,
                    activation="elu", aggregation="norm"),
    "two_molecules": dict(dataset_type="regression", num_tasks=1,
                          number_of_molecules=2, activation="selu",
                          aggregation="sum"),
}


@pytest.fixture(scope="module")
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _configs(case):
    kw = dict(CASES[case])
    polymer = kw.pop("polymer", False)
    enc_kw = {k: kw.pop(k) for k in ("activation", "aggregation") if k in kw}
    enc = dict(atom_fdim=133, bond_fdim=147, hidden_size=32, depth=3,
               band_precision="highest", **enc_kw)
    model_kw = dict(ffn_num_layers=3, ffn_hidden_size=32, **kw)
    jcfg = JaxModelConfig(encoder=JaxEncoderConfig(**enc), **model_kw)
    cfg = ModelConfig(encoder=EncoderConfig(**enc), **model_kw)
    return jcfg, cfg, polymer


def _graph_arrays(case, polymer, n_mols):
    """Per molecule position: (port GraphBatch, JAX GraphBatch)."""
    smiles = POLYMERS if polymer else SMILES
    out = []
    for pos in range(n_mols):
        smi = smiles[pos:] + smiles[:pos]
        kw = dict(pad_atoms=256, pad_bonds=512, pad_mols=len(smi))
        out.append((mol2graph(smi, FeaturizationConfig(polymer=polymer), **kw),
                    jax_mol2graph(smi, JaxFcfg(polymer=polymer), **kw)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_apply_model_on_both_branches(interpret_mode, case):
    jcfg, cfg, polymer = _configs(case)
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(3), jcfg))
    graphs = _graph_arrays(case, polymer, cfg.number_of_molecules)

    def jax_preds(pallas):
        batches = [jax.tree_util.tree_map(jnp.asarray,
                                          jgb.arrays(pallas=pallas))
                   for _, jgb in graphs]
        if pallas:
            assert all("rs_rev" in b["pallas_aux"] for b in batches)
        return np.asarray(jax_postprocess(
            apply_model(params, batches, jcfg), jcfg))

    model = load_jax_params(MoleculeModel(cfg), params).eval()

    def port_preds(sorted_aux):
        batches = [batch_to_tensors(gb.arrays(sorted_aux=sorted_aux), "cpu")
                   for gb, _ in graphs]
        with torch.inference_mode():
            return postprocess_preds(model(batches), cfg).numpy()

    want_xla, want_pallas = jax_preds(False), jax_preds(True)
    np.testing.assert_allclose(want_pallas, want_xla, rtol=1e-4, atol=1e-5)
    for sorted_aux in (True, False):
        got = port_preds(sorted_aux)
        assert got.shape == want_xla.shape
        np.testing.assert_allclose(got, want_xla, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


def test_params_from_jax_round_trip_and_transpose():
    jcfg, cfg, _ = _configs("regression")
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(0), jcfg))
    state = params_from_jax(params)
    # JAX w is (in, out); nn.Linear.weight is (out, in): one transpose
    w_i = params["encoders"][0]["W_i"]["w"]
    assert w_i.shape == (147, 32)
    np.testing.assert_array_equal(state["encoders.0.W_i.weight"].numpy(),
                                  w_i.T)
    np.testing.assert_array_equal(state["ffn.2.bias"].numpy(),
                                  params["ffn"][2]["b"])
    model = load_jax_params(MoleculeModel(cfg), params)
    back = params_to_jax(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)
    # linear layers compute x @ w + b with the JAX weights
    x = np.random.default_rng(0).normal(size=(4, 147)).astype(np.float32)
    with torch.inference_mode():
        y = model.encoders[0].W_i(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, x @ w_i, rtol=RTOL, atol=ATOL)


def test_shared_encoder_round_trip():
    jcfg, cfg, _ = _configs("two_molecules")
    jcfg = dataclasses.replace(jcfg, mpn_shared=True)
    cfg = dataclasses.replace(cfg, mpn_shared=True)
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(1), jcfg))
    model = load_jax_params(MoleculeModel(cfg), params)
    assert len(model.encoders) == 1
    back = params_to_jax(model)
    assert len(back["encoders"]) == 2
    np.testing.assert_array_equal(back["encoders"][1]["W_h"]["w"],
                                  params["encoders"][1]["W_h"]["w"])


@pytest.mark.parametrize("field", ["atom_messages", "undirected", "bias",
                                   "compute_dtype", "atom_descriptors"])
def test_unported_encoder_configs_raise(field):
    """What is not ported raises; what has been ported since (the
    plain-band options ``undirected``, ``bias`` and bfloat16 compute) builds
    and takes the layer form its configuration implies, ``atom_messages``
    builds W_i on the atom features and W_h on the messages and the bond
    features, and ``atom_descriptors="descriptor"`` builds W_d with in =
    out = H + D."""
    value = {"compute_dtype": "bfloat16",
             "atom_descriptors": "descriptor"}.get(field, True)
    extra = {"atom_descriptors_size": 5} \
        if field == "atom_descriptors" else {}
    cfg = EncoderConfig(atom_fdim=133, bond_fdim=147, **{field: value},
                        **extra)
    if field == "atom_descriptors":
        enc = MoleculeModel(ModelConfig(encoder=cfg)).encoders[0]
        H = cfg.hidden_size
        assert enc.W_d.in_features == enc.W_d.out_features == H + 5
        assert enc.W_d.bias is not None
        return
    if field == "atom_messages":
        enc = MoleculeModel(ModelConfig(encoder=cfg)).encoders[0]
        assert enc.W_i.in_features == 133
        assert enc.W_h.in_features == cfg.hidden_size + 147
        assert enc.W_h.out_features == cfg.hidden_size
        return
    forms = {"undirected": "matmul_act", "bias": "plain",
             "compute_dtype": "plain"}
    if field in forms:
        model = MoleculeModel(ModelConfig(encoder=cfg))
        assert cfg.layer_form() == forms[field]
        assert (model.encoders[0].W_h.bias is not None) == (field == "bias")
        return
    with pytest.raises(NotImplementedError, match="not on the port yet"):
        MoleculeModel(ModelConfig(encoder=cfg))


def test_unknown_compute_dtype_is_refused():
    cfg = EncoderConfig(atom_fdim=133, bond_fdim=147, compute_dtype="float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        MoleculeModel(ModelConfig(encoder=cfg))
