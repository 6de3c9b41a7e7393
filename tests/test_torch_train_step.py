"""Gradients and optimizer steps of the port vs the JAX package.

The same JAX parameters (``init_model`` from a seed) go into both through
``load_jax_params``; the same featurized batch, targets, mask and weights
(numpy, from a seed) go through

* ``jax.grad`` of the JAX package's ``make_loss_fn`` and its
  ``make_train_step`` with ``build_optimizer`` (optax), and
* the port's ``make_loss_fn`` + ``backward`` and its ``TrainStep`` with
  ``torch.optim``.

The port runs its kernel branch (dst-sorted batches, hand-written
backward, plain kernels on the CPU); the JAX package runs its XLA branch,
and its Pallas branch in interpret mode for one case. Dropout is 0 on both
sides (the two frameworks draw different masks); dropout > 0 is tested on
the port alone. Hidden 32, depth 3. Tolerance: rtol 1e-4, atol 1e-6 (FP32
through five layers and their transposes, sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polymer_chemprop_tpu.features import FeaturizationConfig as JaxFcfg
from polymer_chemprop_tpu.features import mol2graph as jax_mol2graph
from polymer_chemprop_tpu.models import EncoderConfig as JaxEncoderConfig
from polymer_chemprop_tpu.models import ModelConfig as JaxModelConfig
from polymer_chemprop_tpu.models import init_model
from polymer_chemprop_tpu.train.scheduler import build_optimizer as jax_optimizer
from polymer_chemprop_tpu.train.scheduler import build_schedule as jax_schedule
from polymer_chemprop_tpu.train.step import make_loss_fn as jax_make_loss_fn
from polymer_chemprop_tpu.train.step import make_train_step
from polymer_chemprop_tpu_torch.features import FeaturizationConfig, mol2graph
from polymer_chemprop_tpu_torch.models import convert
from polymer_chemprop_tpu_torch.models.encoder import (
    EncoderConfig,
    batch_to_tensors,
)
from polymer_chemprop_tpu_torch.models.model import ModelConfig, MoleculeModel
from polymer_chemprop_tpu_torch.models.nn import dropout
from polymer_chemprop_tpu_torch.train.scheduler import (
    build_optimizer,
    build_schedule,
)
from polymer_chemprop_tpu_torch.train.step import TrainStep, make_loss_fn
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-4, 1e-6
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
    "polymer": dict(dataset_type="regression", num_tasks=1, polymer=True,
                    activation="elu", aggregation="norm"),
}
SCHEDULE = dict(init_lr=1e-3, max_lr=1e-2, final_lr=1e-3, warmup_epochs=1.0,
                epochs=3, steps_per_epoch=2)


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
    model_kw = dict(ffn_num_layers=2, ffn_hidden_size=32, **kw)
    jcfg = JaxModelConfig(encoder=JaxEncoderConfig(**enc), **model_kw)
    return jcfg, ModelConfig(encoder=EncoderConfig(**enc), **model_kw), polymer


def _batch(case, seed=0, shift=0, pallas=False, pad_atoms=256, pad_bonds=512,
           pad_mols=None):
    """(JAX batch pytree, port batch of tensors): the same molecules,
    targets (some missing), mask and data weights. Rows beyond the
    molecules are batch padding with mask 0 and weight 0."""
    jcfg, cfg, polymer = _configs(case)
    smiles = POLYMERS if polymer else SMILES
    smiles = smiles[shift:] + smiles[:shift]
    n, M = len(smiles), pad_mols or len(smiles)
    kw = dict(pad_atoms=pad_atoms, pad_bonds=pad_bonds, pad_mols=M)
    gb = mol2graph(smiles, FeaturizationConfig(polymer=polymer), **kw)
    jgb = jax_mol2graph(smiles, JaxFcfg(polymer=polymer), **kw)
    rng = np.random.default_rng(seed + 10 * shift)
    T = cfg.num_tasks
    if cfg.dataset_type == "regression":
        targets = rng.normal(size=(M, T))
    else:
        hi = 2 if cfg.dataset_type == "classification" \
            else cfg.multiclass_num_classes
        targets = rng.integers(0, hi, size=(M, T))
    mask = (rng.uniform(size=(M, T)) > 0.25).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, size=(M, 1)).astype(np.float32)
    mask[n:], weights[n:] = 0.0, 0.0
    targets = (targets * mask).astype(np.float32)
    jbatch = {"graphs": [jax.tree_util.tree_map(jnp.asarray,
                                                jgb.arrays(pallas=pallas))],
              "targets": jnp.asarray(targets), "mask": jnp.asarray(mask),
              "weights": jnp.asarray(weights)}
    tbatch = {"graphs": [batch_to_tensors(gb.arrays(sorted_aux=True), "cpu")],
              "targets": torch.from_numpy(targets),
              "mask": torch.from_numpy(mask),
              "weights": torch.from_numpy(weights)}
    return jbatch, tbatch


def _init(case, seed=3):
    jcfg, cfg, _ = _configs(case)
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, params, convert.load_jax_params(MoleculeModel(cfg),
                                                      params)


def _assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    want_flat = jax.tree_util.tree_leaves_with_path(want)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_flat) == len(got_flat)
    for path, leaf in want_flat:
        np.testing.assert_allclose(got_flat[path], np.asarray(leaf),
                                   rtol=rtol, atol=atol, err_msg=str(path))


def _port_grads(model):
    return convert._param_tree(model,
                               lambda p: convert._to_jax_layout(p.grad))


@pytest.mark.parametrize("case,branch", [(c, "xla") for c in CASES]
                         + [("regression", "pallas")])
def test_model_gradients_match_jax_grad(interpret_mode, case, branch):
    jcfg, cfg, params, model = _init(case)
    jbatch, tbatch = _batch(case, pallas=branch == "pallas", pad_mols=8)
    if branch == "pallas":
        assert "rs_rev" in jbatch["graphs"][0]["pallas_aux"]
    tw = np.linspace(0.5, 1.5, cfg.num_tasks).astype(np.float32)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_make_loss_fn(jcfg, jnp.asarray(tw))(p, jbatch, None)
    )(params)
    model.train()
    loss = make_loss_fn(cfg, torch.from_numpy(tw))(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    _assert_tree_close(_port_grads(model), want)


def test_kernel_branch_gradients_match_reference_branch():
    """The hand-written backward of the kernel branch against PyTorch's
    autograd through the port's natural-order branch."""
    _, cfg, _, model = _init("polymer")
    _, tbatch = _batch("polymer")
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
    _assert_tree_close(grads[0], grads[1])


def test_padding_rows_leave_parameter_gradients_unchanged():
    """Padding bonds carry zero m, inp, z and f_bonds, so whatever
    gradient lands on them reaches no parameter: dW_h, dW_i and the rest
    do not move when the batch gets more padding. rtol 1e-5: the same sums
    with zeros added."""
    _, cfg, _, model = _init("polymer")
    grads = []
    for pad_atoms, pad_bonds in ((256, 512), (512, 1536)):
        _, tbatch = _batch("polymer", pad_atoms=pad_atoms,
                           pad_bonds=pad_bonds)
        model.zero_grad()
        make_loss_fn(cfg)(model, tbatch).backward()
        grads.append(_port_grads(model))
    assert np.abs(grads[0]["encoders"][0]["W_h"]["w"]).max() > 0
    _assert_tree_close(grads[1], grads[0], rtol=1e-5, atol=1e-7)


def _torch_step(cfg, model, optimizer, grad_clip=None, weight_decay=0.0,
                trainable=None):
    params = trainable if trainable is not None else model.parameters()
    return TrainStep(model,
                     build_optimizer(optimizer, params, weight_decay),
                     build_schedule("noam", **SCHEDULE), make_loss_fn(cfg),
                     grad_clip=grad_clip)


STEP_CASES = {
    "adam_noam_clip": dict(optimizer="adam", grad_clip=0.5),
    "adam_weight_decay_ignored": dict(optimizer="adam", weight_decay=0.1),
    "adamw_decay": dict(optimizer="adamw", weight_decay=0.1),
    "sgd_clip": dict(optimizer="sgd", grad_clip=0.05),
}


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_optimizer_steps_match_make_train_step(name, n_steps):
    kw = dict(STEP_CASES[name])
    jcfg, cfg, params, model = _init("regression")
    tx = jax_optimizer(kw["optimizer"], jax_schedule("noam", **SCHEDULE),
                       kw.get("weight_decay", 0.0), kw.get("grad_clip"))
    jstep = make_train_step(jcfg, tx)
    tstep = _torch_step(cfg, model, **kw)
    opt_state = tx.init(params)
    for i in range(n_steps):
        jbatch, tbatch = _batch("regression", shift=i)
        params, opt_state, want_loss, want_gnorm = jstep(
            params, opt_state, jbatch, None)
        loss, gnorm = tstep(tbatch)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
        np.testing.assert_allclose(gnorm.item(), float(want_gnorm), rtol=RTOL)
        if kw.get("grad_clip"):
            assert gnorm.item() > kw["grad_clip"]  # the clip is active
    _assert_tree_close(convert.params_to_jax(model), params)
    # the optimizer state crosses into the JAX package's leaf order
    leaves = convert.opt_state_to_leaves(model, tstep.optimizer, tstep.count)
    want_leaves = jax.tree_util.tree_leaves(opt_state)
    assert len(leaves) == len(want_leaves)
    for got, want in zip(leaves, want_leaves):
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-7)


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_resume_from_jax_mid_training_state(optimizer):
    """Two steps in the JAX package, its optax state converted into the
    port's optimizer, then one more step on both sides."""
    jcfg, cfg, params, _ = _init("classification")
    tx = jax_optimizer(optimizer, jax_schedule("noam", **SCHEDULE), 0.05, 1.0)
    jstep = make_train_step(jcfg, tx)
    opt_state = tx.init(params)
    for i in range(2):
        params, opt_state, _, _ = jstep(
            params, opt_state, _batch("classification", shift=i)[0], None)
    params = jax.tree_util.tree_map(np.asarray, params)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(opt_state)]

    model = convert.load_jax_params(MoleculeModel(cfg), params)
    tstep = _torch_step(cfg, model, optimizer, grad_clip=1.0,
                        weight_decay=0.05)
    tstep.count = convert.opt_state_from_leaves(model, tstep.optimizer,
                                                leaves)
    assert tstep.count == 2
    # round trip: what was loaded is what is written back
    back = convert.opt_state_to_leaves(model, tstep.optimizer, tstep.count)
    assert len(back) == len(leaves)
    for a, b in zip(back, leaves):
        np.testing.assert_array_equal(a, b)

    jbatch, tbatch = _batch("classification", shift=2)
    params, opt_state, want_loss, want_gnorm = jstep(params, opt_state,
                                                     jbatch, None)
    loss, gnorm = tstep(tbatch)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    np.testing.assert_allclose(gnorm.item(), float(want_gnorm), rtol=RTOL)
    _assert_tree_close(convert.params_to_jax(model), params)


def test_frozen_parameters_match_multi_transform():
    """Frozen parameters get no update and no moment; they still count in
    the reported gnorm, while the clip sees the trainable ones only."""
    jcfg, cfg, params, model = _init("regression")
    mask = {"encoders": jax.tree_util.tree_map(lambda _: "freeze",
                                               params["encoders"]),
            "ffn": jax.tree_util.tree_map(lambda _: "train", params["ffn"])}
    inner = jax_optimizer("adam", jax_schedule("noam", **SCHEDULE), 0.0, 0.2)
    tx = optax.multi_transform({"train": inner,
                                "freeze": optax.set_to_zero()}, mask)
    jstep = make_train_step(jcfg, tx)
    tstep = _torch_step(cfg, model, "adam", grad_clip=0.2,
                        trainable=model.ffn.parameters())
    before = convert.params_to_jax(model)
    opt_state = tx.init(params)
    for i in range(2):
        jbatch, tbatch = _batch("regression", shift=i)
        params, opt_state, want_loss, want_gnorm = jstep(params, opt_state,
                                                         jbatch, None)
        loss, gnorm = tstep(tbatch)
        np.testing.assert_allclose(gnorm.item(), float(want_gnorm), rtol=RTOL)
    after = convert.params_to_jax(model)
    _assert_tree_close(after, params)
    np.testing.assert_array_equal(after["encoders"][0]["W_h"]["w"],
                                  before["encoders"][0]["W_h"]["w"])
    assert all(p not in tstep.optimizer.state
               for p in model.encoders.parameters())
    leaves = convert.opt_state_to_leaves(model, tstep.optimizer, tstep.count)
    want_leaves = jax.tree_util.tree_leaves(opt_state)
    assert [l.shape for l in leaves] == [np.shape(l) for l in want_leaves]


# -- dropout, on the port alone ----------------------------------------------

def test_dropout_function():
    x = torch.ones(200, 300)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, True, gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.all((y == 0) | (y == 1 / 0.75))
    assert abs(y.mean().item() - 1.0) < 0.02           # mean preserved
    assert dropout(x, 0.25, False, gen) is x            # eval: identity
    assert dropout(x, 0.0, True, gen) is x              # rate 0: identity
    again = dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


def test_dropout_in_training_and_eval_mode():
    _, cfg, params, _ = _init("regression")
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.3))
    model = convert.load_jax_params(MoleculeModel(cfg), params)
    _, tbatch = _batch("regression")
    plain_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0))
    plain = convert.load_jax_params(MoleculeModel(plain_cfg), params)

    def run(mode_train, seed):
        model.train(mode_train)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model(tbatch["graphs"], generator=gen)

    with torch.no_grad():
        want = plain.eval()(tbatch["graphs"])
    assert torch.equal(run(False, 0), want)             # eval: identity
    a, b, c = run(True, 0), run(True, 0), run(True, 1)
    assert torch.equal(a, b)                            # same seed, same run
    assert not torch.equal(a, c) and not torch.equal(a, want)

    def train_two_steps(seed):
        m = convert.load_jax_params(MoleculeModel(cfg), params)
        step = TrainStep(m, build_optimizer("adam", m.parameters()),
                         build_schedule("noam", **SCHEDULE),
                         make_loss_fn(cfg),
                         generator=torch.Generator().manual_seed(seed))
        return [step(tbatch)[0].item() for _ in range(2)]

    assert train_two_steps(5) == train_two_steps(5)
    assert train_two_steps(5) != train_two_steps(6)
