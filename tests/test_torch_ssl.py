"""SSL pretraining in the PyTorch port vs the JAX package (ssl.py).

* ``molecular_weight_label`` equal;
* masking: the port's :func:`apply_masks` on the JAX package's own draws
  (``jax.random`` with the key splits of JAX ``_mask_batch``) gives JAX's
  masks and masked features, bond rows permuted into the port's dst-sorted
  order (``min_mask`` 0 and 2);
* one step from carried-across weights on the same draws, without and with
  the graph task and in enhanced mode (``augment_ratio`` 1, so the gate is
  open and the edge weights move): loss within rtol 1e-5, gradients and
  the parameters after Adam within 1e-4 of each one's largest entry;
* a whole ``ssl_pretrain`` with ``mask_ratio=0``, ``min_mask=0`` and no
  augmentation, which draws nothing that matters: from the JAX package's
  initial weights (the port's ``init_ssl_model`` monkeypatched), stage 2
  trains the encoder through the graph loss and must end at the JAX
  package's checkpoint within 1e-4 relative, its graph embeddings too;
* the ``checkpoint_frzn`` transfer with a frozen encoder.

The port runs with ``device="cpu"`` (the kernels' plain versions) at
``band_precision="highest"`` in the step, FP32 as JAX's CPU path.
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polymer_chemprop_tpu import ssl as jax_ssl
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.data import MoleculeDataLoader as JaxLoader
from polymer_chemprop_tpu.data import get_data as jax_get_data
from polymer_chemprop_tpu.models import EncoderConfig as JaxEncoderConfig
from polymer_chemprop_tpu.train.scheduler import (
    build_optimizer as jax_build_optimizer,
)
from polymer_chemprop_tpu.train.step import batch_pytree
from polymer_chemprop_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from polymer_chemprop_tpu_torch import ssl
from polymer_chemprop_tpu_torch.config import TrainConfig
from polymer_chemprop_tpu_torch.models.convert import (
    ssl_params_from_jax,
    ssl_params_to_jax,
)
from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
from polymer_chemprop_tpu_torch.ops.sorted_aux import sorted_batch
from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
from polymer_chemprop_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_threads import torch_threads  # noqa: F401

HIDDEN, DEPTH = 16, 2


@pytest.fixture(scope="module")
def polymer_csv(tmp_path_factory):
    """Copolymer ensemble strings as in tests/test_ssl.py, with
    inter-monomer edge weights 0.5 (what the augmentation perturbs)."""
    tmp = tmp_path_factory.mktemp("ssl")
    rng = np.random.default_rng(0)
    rows = ["smiles,target"]
    monomers = ["[*:1]CC[*:2]", "[*:1]c1ccc([*:2])cc1", "[*:1]CO[*:2]",
                "[*:1]C(C)C[*:2]"]
    for _ in range(30):
        m1, m2 = rng.choice(monomers, 2, replace=False)
        m2 = m2.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
        w = rng.choice([0.25, 0.5, 0.75])
        rows.append(f'"{m1}.{m2}|{w}|{1 - w}|<1-3:0.5:0.5<2-4:0.5:0.5'
                    f'~{rng.integers(2, 100)}",{rng.normal():.4f}')
    path = tmp / "polymer.csv"
    path.write_text("\n".join(rows))
    return str(path)


@pytest.fixture(scope="module")
def batch(polymer_csv):
    """``(fcfg, JAX natural-order arrays, port tensors, labels)`` of the
    first batch of 10 molecules."""
    fcfg = JaxTrainConfig(data_path=polymer_csv, polymer=True,
                          dataset_type="regression").featurization()
    data = jax_get_data(polymer_csv, config=fcfg, target_columns=[])
    loader = JaxLoader(data, fcfg, batch_size=10, shuffle=False,
                       num_workers=1)
    b = next(iter(loader))
    arrays = batch_pytree(b)["graphs"][0]
    # the port's layout: the dst-sorted aux, f_bonds permuted
    port = sorted_batch(arrays)
    labels = np.zeros(b.mol_mask.shape[0], np.float32)
    labels[:b.size] = jax_ssl.molecular_weight_label(data, fcfg)[:b.size]
    return fcfg, arrays, batch_to_tensors(port, "cpu"), labels


def _jax_draws(key, A, B, augment):
    """The random numbers of JAX ``loss_fn`` + ``_mask_batch`` for ``key``
    (ssl.py:130-150, 197-207), in the port's draws layout."""
    draws = {}
    if augment:
        key, k_gate, k_noise = jax.random.split(key, 3)
        draws["noise"] = jax.random.normal(k_noise, (B,))
        draws["gate"] = jax.random.uniform(k_gate, ())
        # bernoulli(k, p) is uniform(k) < p
        assert bool(jax.random.bernoulli(k_gate, 0.3)) == \
            bool(draws["gate"] < 0.3)
    k1, k2 = jax.random.split(key)
    draws["atom"] = jax.random.uniform(k1, (A,))
    draws["pair"] = jax.random.uniform(k2, (B // 2,))
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in draws.items()}


def test_molecular_weight_label(polymer_csv, batch):
    from polymer_chemprop_tpu_torch.data import get_data
    fcfg = TrainConfig(data_path=polymer_csv, polymer=True).featurization()
    data = get_data(polymer_csv, config=fcfg, target_columns=[])
    jdata = jax_get_data(polymer_csv, config=batch[0], target_columns=[])
    got = ssl.molecular_weight_label(data, fcfg)
    want = jax_ssl.molecular_weight_label(jdata, batch[0])
    assert got.dtype == want.dtype and got.shape == (30,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_mask", [0, 2])
def test_masks_on_the_jax_draws(batch, min_mask):
    _, arrays, tb, _ = batch
    A, B = arrays["f_atoms"].shape[0], arrays["f_bonds"].shape[0]
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    masked, atom_mask, bond_mask = jax_ssl._mask_batch(jb, key, 0.15,
                                                       min_mask)
    got, g_atom, g_bond = ssl.apply_masks(
        tb, _jax_draws(key, A, B, False), 0.15, min_mask)
    perm = tb["sorted_aux"]["perm"].numpy()
    np.testing.assert_array_equal(g_atom.numpy(), np.asarray(atom_mask))
    np.testing.assert_array_equal(g_bond.numpy(), np.asarray(bond_mask)[perm])
    np.testing.assert_array_equal(got["f_atoms"].numpy(),
                                  np.asarray(masked["f_atoms"]))
    np.testing.assert_array_equal(got["f_bonds"].numpy(),
                                  np.asarray(masked["f_bonds"])[perm])
    assert g_atom.sum() > 0 and g_bond.sum() > 0
    if min_mask:
        # every molecule of the batch has at least min_mask masked atoms
        a2mol = tb["a2mol"].numpy()[g_atom.numpy()]
        assert np.bincount(a2mol)[np.unique(a2mol)].min() >= min_mask


def _port_model(params, enc_cfg):
    model = ssl.SSLModel(enc_cfg)
    model.load_state_dict(ssl_params_from_jax(params), strict=True)
    return model


def _close(got, want, what):
    """Within 1e-4 of the largest entry of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    tol = 1e-4 * max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(),
                                             tol)


@pytest.mark.parametrize("mode", ["masking", "graph", "enhanced"])
def test_one_step_matches_jax(batch, mode):
    fcfg, arrays, tb, labels = batch
    with_graph = mode != "masking"
    kw = dict(min_mask=2, edge_loss_weight=1.0, augment_ratio=0.0)
    if mode == "enhanced":
        kw.update(edge_loss_weight=1.5, augment_ratio=1.0)
    jenc = JaxEncoderConfig(atom_fdim=fcfg.atom_fdim,
                            bond_fdim=fcfg.bond_fdim(), hidden_size=HIDDEN,
                            depth=DEPTH)
    params = jax.tree_util.tree_map(np.asarray, jax_ssl.init_ssl_model(
        jax.random.PRNGKey(3), jenc))
    key = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jlabels = jnp.asarray(labels)

    # the JAX gradients, kept as the optimizer state of a capturing
    # transform, and the JAX Adam step
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jax_ssl.make_ssl_step(jenc, capture, 0.15, 0.5, with_graph, **kw)
    _, grads, loss = step(params, capture.init(params), jb, jlabels, key,
                          1.0)
    adam = jax_build_optimizer("adam", lambda s: 1e-3)
    step = jax_ssl.make_ssl_step(jenc, adam, 0.15, 0.5, with_graph, **kw)
    new_params, _, _ = step(params, adam.init(params), jb, jlabels, key, 1.0)

    cfg = ssl.SSLConfig(hidden_size=HIDDEN, depth=DEPTH, lr=1e-3,
                        use_enhanced_ssl=mode == "enhanced",
                        augment_ratio=kw["augment_ratio"])
    model = _port_model(params, ssl.ssl_encoder_config(cfg, fcfg))
    pstep = ssl.make_ssl_step(cfg, model)
    A, B = arrays["f_atoms"].shape[0], arrays["f_bonds"].shape[0]
    draws = _jax_draws(key, A, B, mode == "enhanced")
    if mode == "enhanced":
        # the gate is open: the inter-monomer weights moved
        masked = ssl.apply_masks(tb, draws, 0.15, 2, 1.0)[0]
        assert not torch.equal(masked["w_bonds"], tb["w_bonds"])
    got_loss, gnorm = pstep(tb, torch.from_numpy(labels), draws, with_graph,
                            1.0)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    want_grads = ssl_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            grads))
    want_params = ssl_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             new_params))
    got_params = model.state_dict()
    assert set(want_grads) == set(got_params)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), f"grad {name}")
        _close(got_params[name].numpy(), want_params[name].numpy(),
               f"param {name}")
    if not with_graph:
        assert all(float(p.grad.abs().sum()) == 0
                   for p in model.graph_head.parameters())
    jnorm = np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                        for g in jax.tree_util.tree_leaves(grads)))
    np.testing.assert_allclose(float(gnorm), jnorm, rtol=1e-4)


def test_deterministic_pretrain_matches_jax(polymer_csv, tmp_path,
                                            monkeypatch):
    common = dict(data_path=polymer_csv, hidden_size=HIDDEN, depth=DEPTH,
                  mask_ratio=0.0, min_mask=0, epochs_stage1=1,
                  epochs_stage2=3, batch_size=10, val_frac=0.2,
                  transfer_strategy="b", save_graph_embeddings=True,
                  num_workers=1, quiet=True, seed=5)
    jcfg = jax_ssl.SSLConfig(save_dir=str(tmp_path / "jax"), **common)
    jpath = jax_ssl.ssl_pretrain(jcfg)

    # the JAX package's initial weights (ssl.py:264-266)
    _, init_key = jax.random.split(jax.random.PRNGKey(common["seed"]))
    fcfg = TrainConfig(polymer=True).featurization()
    init = jax.tree_util.tree_map(np.asarray, jax_ssl.init_ssl_model(
        init_key, JaxEncoderConfig(atom_fdim=fcfg.atom_fdim,
                                   bond_fdim=fcfg.bond_fdim(),
                                   hidden_size=HIDDEN, depth=DEPTH)))
    monkeypatch.setattr(ssl, "init_ssl_model",
                        lambda enc_cfg, seed: _port_model(init, enc_cfg))
    cfg = ssl.SSLConfig(save_dir=str(tmp_path / "port"), device="cpu",
                        **common)
    path = ssl.ssl_pretrain(cfg)

    got, gmeta, _, _ = load_checkpoint(path)
    want, _, _, _ = jax_load_checkpoint(jpath)
    assert set(got) == set(want) == {"encoders", "ffn"}
    moved = 0
    for (k, a), (_, b) in zip(sorted(_flat(got).items()),
                              sorted(_flat(want).items())):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)
        moved += not np.array_equal(b, _flat({"encoders": [init["encoder"]],
                                              "ffn": init["graph_head"]})[k])
    assert moved > 0   # stage 2 trained the encoder and the graph head
    assert gmeta["hidden_size"] == HIDDEN and gmeta["device"] == "cpu"
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
    assert meta["ssl"] is True and meta["transfer_strategy"] == "b"
    emb = np.load(tmp_path / "port" / "ssl_graph_embeddings.npy")
    jemb = np.load(tmp_path / "jax" / "ssl_graph_embeddings.npy")
    assert emb.shape == jemb.shape == (24, HIDDEN)
    np.testing.assert_allclose(emb, jemb, rtol=1e-4,
                               atol=1e-4 * np.abs(jemb).max())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, f"{prefix}{i}/").items()}
    return {prefix: np.asarray(tree)}


def test_pretrain_transfers_into_a_frozen_encoder(polymer_csv, tmp_path):
    cfg = ssl.SSLConfig(data_path=polymer_csv, save_dir=str(tmp_path),
                        hidden_size=HIDDEN, depth=DEPTH, epochs_stage1=1,
                        epochs_stage2=1, batch_size=10, use_enhanced_ssl=True,
                        num_workers=1, quiet=True, device="cpu")
    ckpt = ssl.ssl_pretrain(cfg)
    params, _, _, _ = load_checkpoint(ckpt)
    assert set(params) == {"encoders"}           # strategy "a"
    for k, v in _flat(jax_load_checkpoint(ckpt)[0]).items():
        np.testing.assert_array_equal(_flat(params)[k], v)
    tcfg = TrainConfig(data_path=polymer_csv, dataset_type="regression",
                       polymer=True, epochs=1, hidden_size=HIDDEN,
                       depth=DEPTH, ffn_hidden_size=HIDDEN,
                       checkpoint_frzn=ckpt, frzn_encoder=True, batch_size=10,
                       save_dir=str(tmp_path / "downstream"), quiet=True,
                       num_workers=1, device="cpu")
    assert np.isfinite(cross_validate(tcfg)[0])
    trained, _, _, _ = load_checkpoint(str(
        tmp_path / "downstream" / "fold_0" / "model_0" / "best_model.ckpt"))
    for name in ("W_i", "W_h", "W_o"):
        for k, v in params["encoders"][0][name].items():
            np.testing.assert_array_equal(
                trained["encoders"][0][name][k], v)


def test_ssl_tree_round_trip():
    fcfg = TrainConfig(polymer=True).featurization()
    enc_cfg = ssl.ssl_encoder_config(
        ssl.SSLConfig(hidden_size=HIDDEN, depth=DEPTH), fcfg)
    model = ssl.init_ssl_model(enc_cfg, 0)
    tree = ssl_params_to_jax(model)
    assert tree["encoder"]["W_i"]["w"].shape == (fcfg.bond_fdim(), HIDDEN)
    assert tree["edge_head"]["w"].shape == (HIDDEN, fcfg.bond_fdim())
    assert len(tree["graph_head"]) == 2
    back = ssl_params_from_jax(tree)
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t)
