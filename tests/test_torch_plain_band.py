"""The plain-band encoder configurations of the port vs the JAX package:
``bias``, ``undirected``, bfloat16 compute and a hidden size too wide for
the W_h-fused kernels.

The same JAX parameters (``init_model`` from a seed, biases of ``W_i`` and
``W_h`` redrawn non-zero with numpy) go into both through
``load_jax_params``; the same featurized batch goes through

* JAX ``apply_model`` on its XLA branch and on its sorted-resident Pallas
  branch (interpret mode, ``band_precision="highest"``), ``jax.grad`` of its
  ``make_loss_fn``, and
* the port's ``MoleculeModel`` on its kernel branch (dst-sorted, the layer
  form chosen by the configuration, plain versions on the CPU) and its
  reference branch, and its ``make_loss_fn`` + ``backward``.

Optimizer steps and whole training runs of these configurations are in
tests/test_torch_plain_band_train.py.

Hidden 32, depth 3, 512 padded bonds; the wide case is hidden 1,600 on
three small molecules. Tolerances:

* float32: forward rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-6
  (FP32 through five layers and their transposes, sums in another order).
* bfloat16: forward rtol 2e-3, atol 2e-4; gradients rtol 1e-2 relative to
  each gradient's largest entry. Both sides round the same operands to
  bfloat16 and accumulate in float32, so they agree unless a float32 sum
  taken in another order lands on the other side of a bfloat16 rounding
  boundary; one such flip moves that operand (in the backward: that
  gradient entry) by 2^-8 of its value.
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
from polymer_chemprop_tpu.train.step import make_loss_fn as jax_make_loss_fn
from polymer_chemprop_tpu_torch.features import FeaturizationConfig, mol2graph
from polymer_chemprop_tpu_torch.models import convert
from polymer_chemprop_tpu_torch.models.encoder import (
    EncoderConfig,
    batch_to_tensors,
)
from polymer_chemprop_tpu_torch.models.model import ModelConfig, MoleculeModel
from polymer_chemprop_tpu_torch.models.nn import linear
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from polymer_chemprop_tpu_torch.train.step import make_loss_fn
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-6
BF16_RTOL, BF16_ATOL = 2e-3, 2e-4
BF16_G_RTOL = 1e-2
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
# encoder options, the layer form they must take, and the data they run on
CONFIGS = {
    "bias": (dict(bias=True), "plain", "molecules"),
    "bias_polymer": (dict(bias=True, activation="tanh", aggregation="norm"),
                     "plain", "polymer"),
    "undirected": (dict(undirected=True), "matmul_act", "molecules"),
    "undirected_polymer": (dict(undirected=True, activation="elu",
                                aggregation="sum"), "matmul_act", "polymer"),
    "bias_undirected": (dict(bias=True, undirected=True), "plain",
                        "polymer"),
    "bf16": (dict(compute_dtype="bfloat16"), "plain", "molecules"),
    "bf16_bias_polymer": (dict(compute_dtype="bfloat16", bias=True), "plain",
                          "polymer"),
    "wide": (dict(hidden_size=1600), "plain", "few"),
    "wide_undirected": (dict(hidden_size=1600, undirected=True), "plain",
                        "few"),
}


@pytest.fixture(scope="module")
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _configs(name, num_tasks=2):
    enc_kw, form, data = CONFIGS[name]
    enc = dict(dict(atom_fdim=133, bond_fdim=147, hidden_size=32, depth=3,
                    band_precision="highest"), **enc_kw)
    model_kw = dict(ffn_num_layers=2, ffn_hidden_size=32, num_tasks=num_tasks)
    jcfg = JaxModelConfig(encoder=JaxEncoderConfig(**enc), **model_kw)
    cfg = ModelConfig(encoder=EncoderConfig(**enc), **model_kw)
    assert cfg.encoder.layer_form() == form
    return jcfg, cfg, data


def _init(name, seed=3):
    """JAX parameters with non-zero W_i / W_h biases, and the port's model
    holding the same."""
    jcfg, cfg, data = _configs(name)
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for enc in params["encoders"]:
        for layer in ("W_i", "W_h"):
            assert ("b" in enc[layer]) == cfg.encoder.bias
            if cfg.encoder.bias:
                enc[layer]["b"] = (0.1 * rng.normal(
                    size=enc[layer]["b"].shape)).astype(np.float32)
    model = convert.load_jax_params(MoleculeModel(cfg), params)
    return jcfg, cfg, data, params, model


def _graphs(data, shift=0):
    polymer = data == "polymer"
    smiles = POLYMERS if polymer else SMILES[:3] if data == "few" else SMILES
    smiles = smiles[shift:] + smiles[:shift]
    kw = dict(pad_atoms=256, pad_bonds=512, pad_mols=8)
    return (mol2graph(smiles, FeaturizationConfig(polymer=polymer), **kw),
            jax_mol2graph(smiles, JaxFcfg(polymer=polymer), **kw),
            len(smiles))


def _batch(name, pallas=False, shift=0):
    """(JAX batch pytree, port batch of tensors) with the same targets,
    mask and weights; rows beyond the molecules are batch padding."""
    _, cfg, data = _configs(name)
    gb, jgb, n = _graphs(data, shift)
    rng = np.random.default_rng(10 * shift)
    M, T = 8, cfg.num_tasks
    mask = (rng.uniform(size=(M, T)) > 0.25).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, size=(M, 1)).astype(np.float32)
    mask[n:], weights[n:] = 0.0, 0.0
    targets = (rng.normal(size=(M, T)) * mask).astype(np.float32)
    jbatch = {"graphs": [jax.tree_util.tree_map(jnp.asarray,
                                                jgb.arrays(pallas=pallas))],
              "targets": jnp.asarray(targets), "mask": jnp.asarray(mask),
              "weights": jnp.asarray(weights)}
    tbatch = {"graphs": [batch_to_tensors(gb.arrays(sorted_aux=True), "cpu")],
              "targets": torch.from_numpy(targets),
              "mask": torch.from_numpy(mask),
              "weights": torch.from_numpy(weights)}
    return jbatch, tbatch


def _port_grads(model):
    return convert._param_tree(model,
                               lambda p: convert._to_jax_layout(p.grad))


def _assert_tree_close(got, want, rtol, atol=0.0, rel_to_max=False):
    want_flat = jax.tree_util.tree_leaves_with_path(want)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_flat) == len(got_flat)
    for path, leaf in want_flat:
        leaf = np.asarray(leaf)
        if rel_to_max:
            err = np.abs(got_flat[path] - leaf).max()
            assert err <= rtol * np.abs(leaf).max() + atol, (path, err)
        else:
            np.testing.assert_allclose(got_flat[path], leaf, rtol=rtol,
                                       atol=atol, err_msg=str(path))


# -- forward -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_apply_model_on_both_branches(interpret_mode, name):
    jcfg, cfg, data, params, model = _init(name)
    gb, jgb, n = _graphs(data)

    def jax_preds(pallas):
        batch = jax.tree_util.tree_map(jnp.asarray, jgb.arrays(pallas=pallas))
        return np.asarray(apply_model(params, [batch], jcfg))[:n]

    model.eval()

    def port_preds(sorted_aux):
        batch = batch_to_tensors(gb.arrays(sorted_aux=sorted_aux), "cpu")
        before = bm.launch_counts()
        with torch.inference_mode():
            out = model([batch]).numpy()[:n]
        assert bm.launch_counts() == before      # CPU: the plain versions
        return out

    bf16 = cfg.encoder.compute_dtype == "bfloat16"
    rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (RTOL, ATOL)
    want_xla, want_pallas = jax_preds(False), jax_preds(True)
    np.testing.assert_allclose(want_pallas, want_xla, rtol=max(rtol, 1e-4),
                               atol=max(atol, 1e-5))
    assert np.abs(want_xla).max() > 1e-3
    for sorted_aux in (True, False):
        got = port_preds(sorted_aux)
        assert got.shape == want_xla.shape == (n, cfg.num_tasks)
        np.testing.assert_allclose(got, want_xla, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got, want_pallas, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["bias", "undirected", "bf16", "wide"])
def test_option_changes_the_predictions(name):
    """Each option does something: the same weights without it predict
    otherwise (a test that passes with the option ignored proves little)."""
    _, cfg, data, _, model = _init(name)
    gb, _, n = _graphs(data)
    batch = batch_to_tensors(gb.arrays(sorted_aux=True), "cpu")
    if name == "wide":
        # the wide model through the natural-order branch instead
        other = batch_to_tensors(gb.arrays(sorted_aux=False), "cpu")
        with torch.inference_mode():
            a, b = model.eval()([batch]), model([other])
        np.testing.assert_allclose(a[:n].numpy(), b[:n].numpy(), rtol=RTOL,
                                   atol=ATOL)
        return
    off = {"bias": "bias", "undirected": "undirected",
           "bf16": "compute_dtype"}[name]
    plain_enc = dataclasses.replace(
        cfg.encoder, **{off: "float32" if name == "bf16" else False})
    plain = MoleculeModel(dataclasses.replace(cfg, encoder=plain_enc))
    plain.load_state_dict(model.state_dict(), strict=False)
    with torch.inference_mode():
        a, b = model.eval()([batch])[:n], plain.eval()([batch])[:n]
    diff = (a - b).abs().max().item()
    assert diff > (1e-5 if name == "bf16" else 1e-3), diff
    if name == "bf16":           # and bfloat16 stays near float32
        assert diff < 2e-2 * b.abs().max().item()


def test_padding_rows_with_bias_change_no_prediction():
    """With a bias the padding rows of the messages hold act(b), not 0; more
    padding must leave every prediction where it was (rtol 1e-6: the same
    sums with other rows beside them)."""
    _, cfg, _, _, model = _init("bias_polymer")
    assert model.encoders[0].W_i.bias.abs().max() > 0
    outs = []
    for pad_atoms, pad_bonds in ((256, 512), (512, 1536)):
        gb = mol2graph(POLYMERS, FeaturizationConfig(polymer=True),
                       pad_atoms=pad_atoms, pad_bonds=pad_bonds, pad_mols=4)
        batch = batch_to_tensors(gb.arrays(sorted_aux=True), "cpu")
        with torch.inference_mode():
            outs.append(model.eval()([batch]).numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)


def test_linear_bf16_has_the_jax_meaning():
    """Operands rounded to bfloat16, product and sum in float32, bias added
    in float32 (polymer_chemprop_tpu models/nn.py linear)."""
    from polymer_chemprop_tpu.models.nn import linear as jax_linear
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    layer = torch.nn.Linear(96, 40)
    layer.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                           "bias": torch.from_numpy(b)})
    want = np.asarray(jax_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x), jnp.bfloat16))
    with torch.no_grad():
        got = linear(layer, torch.from_numpy(x), bf16=True)
        exact = linear(layer, torch.from_numpy(x))
    assert got.dtype == torch.float32
    # float32 accumulation of exactly representable products: only the
    # order of a 96-term sum differs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a bfloat16 result would be 2^-8 coarse; this one is not
    assert (got - got.to(torch.bfloat16).float()).abs().max() > 1e-4
    assert 1e-4 < (got - exact).abs().max() < 0.2


# -- gradients ---------------------------------------------

@pytest.mark.parametrize("name,branch", [
    ("bias", "xla"), ("bias_polymer", "xla"), ("undirected", "xla"),
    ("undirected_polymer", "xla"), ("bias_undirected", "xla"),
    ("bias", "pallas"), ("undirected", "pallas"), ("bf16", "xla"),
    ("bf16_bias_polymer", "xla"),
])
def test_model_gradients_match_jax_grad(interpret_mode, name, branch):
    jcfg, cfg, _, params, model = _init(name)
    jbatch, tbatch = _batch(name, pallas=branch == "pallas")
    tw = np.linspace(0.5, 1.5, cfg.num_tasks).astype(np.float32)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_make_loss_fn(jcfg, jnp.asarray(tw))(p, jbatch, None)
    )(params)
    model.train()
    loss = make_loss_fn(cfg, torch.from_numpy(tw))(model, tbatch)
    loss.backward()
    got = _port_grads(model)
    if cfg.encoder.compute_dtype == "bfloat16":
        np.testing.assert_allclose(loss.item(), float(want_loss),
                                   rtol=BF16_RTOL)
        _assert_tree_close(got, want, BF16_G_RTOL, rel_to_max=True)
    else:
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=G_RTOL)
        _assert_tree_close(got, want, G_RTOL, G_ATOL)
    if cfg.encoder.bias:
        assert np.abs(got["encoders"][0]["W_h"]["b"]).max() > 0


@pytest.mark.parametrize("name", ["bias_polymer", "undirected_polymer",
                                  "bias_undirected", "wide"])
def test_kernel_branch_gradients_match_reference_branch(name):
    """The hand-written backward of the sorted branch against PyTorch's
    autograd through the port's natural-order branch."""
    _, cfg, _, _, model = _init(name)
    _, tbatch = _batch(name)
    natural = {k: v for k, v in tbatch["graphs"][0].items()
               if k != "sorted_aux"}
    perm = tbatch["graphs"][0]["sorted_aux"]["perm"].long()
    natural["f_bonds"] = torch.empty_like(natural["f_bonds"])
    natural["f_bonds"][perm] = tbatch["graphs"][0]["f_bonds"]
    grads = []
    for graphs in (tbatch["graphs"], [natural]):
        model.zero_grad()
        make_loss_fn(cfg)(model, dict(tbatch, graphs=graphs)).backward()
        grads.append(_port_grads(model))
    _assert_tree_close(grads[0], grads[1], G_RTOL, G_ATOL)
