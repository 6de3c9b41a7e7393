"""The ``atom_messages`` encoder of the port vs the JAX package's, on the CPU.

* The two ops of the atom-message branch, ``atom_neighbor_sum_sorted`` and
  ``src_readout_sorted`` (their plain versions, which the wrappers run on
  CPU tensors), and their autograd Functions' VJPs against the JAX ops of
  the same names (pallas_mpnn.py:1485, :1528) in interpret mode at
  ``"highest"``, with unit and polymer (asymmetric) weights; the neighbour
  sum is self-adjoint. Rows 1 and up: the port's CSR gives the padding
  atom 0 an empty run, the JAX banded op the padding bonds of tile 0's
  window, and no real atom reads atom 0.
* ``MoleculeModel(atom_messages=True)`` on both port branches (dst-sorted
  kernels, natural-order segment sums) against JAX ``apply_model`` on its
  XLA branch; its Pallas branch (interpret mode) in one forward-and-
  gradient case. The JAX parameters go in through ``load_jax_params``.
* Gradients of every parameter against ``jax.grad`` of the JAX package's
  ``make_loss_fn``.
* Training: a 2-epoch ``cross_validate`` in both packages, resuming from
  each other's ``model.ckpt``, the CLI, and the reference-stream init.
* ``bond_message_step_natural`` (the natural-order drop-in on the plain
  band aggregation) against the JAX package's ``bond_message_step_pallas``
  and the port's ``ops.segment.bond_message_step``.

Hidden 32, depth 3, 512 padded bonds (1,024 where the JAX banded ops
run: their window ``EXT_A``). Tolerances: FP32 forward rtol 1e-5,
atol 1e-6; gradients rtol 1e-4 (the JAX package's own 1e-3 / 1e-4 against
its Pallas branch); ``band_precision="high"`` rtol 1e-4 (the JAX banded
ops round ``h`` to three bf16 passes, the port sums in FP32); bfloat16
linear layers 2e-3 (both round the same operands to bfloat16). The models
run at ``"highest"`` elsewhere, as every parity test of the port does.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_plain_band as pb
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.features import FeaturizationConfig as JaxFcfg
from polymer_chemprop_tpu.features import mol2graph as jax_mol2graph
from polymer_chemprop_tpu.models import EncoderConfig as JaxEncoderConfig
from polymer_chemprop_tpu.models import ModelConfig as JaxModelConfig
from polymer_chemprop_tpu.models import apply_model, init_model
from polymer_chemprop_tpu.ops import pallas_mpnn
from polymer_chemprop_tpu.ops.segment import (
    bond_message_step as jax_bond_message_step,
)
from polymer_chemprop_tpu.train.cross_validate import (
    cross_validate as jax_cross_validate,
)
from polymer_chemprop_tpu.train.step import make_loss_fn as jax_make_loss_fn
from polymer_chemprop_tpu_torch import cli
from polymer_chemprop_tpu_torch.config import TrainConfig
from polymer_chemprop_tpu_torch.features import FeaturizationConfig, mol2graph
from polymer_chemprop_tpu_torch.models import convert
from polymer_chemprop_tpu_torch.models.encoder import (
    EncoderConfig,
    batch_to_tensors,
)
from polymer_chemprop_tpu_torch.models.model import ModelConfig, MoleculeModel
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from polymer_chemprop_tpu_torch.ops.segment import bond_message_step
from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
from polymer_chemprop_tpu_torch.train.step import make_loss_fn
from polymer_chemprop_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_opt_leaves,
)
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-6
HIGH_RTOL = 1e-4
BF16_RTOL, BF16_ATOL = 2e-3, 2e-4
REGRESSION = os.path.join(os.path.dirname(__file__), "data", "regression.csv")
# encoder options and the data they run on
CONFIGS = {
    "regression": (dict(), "molecules"),
    "polymer": (dict(activation="elu", aggregation="norm"), "polymer"),
    "bias": (dict(bias=True, activation="tanh"), "polymer"),
    "bf16": (dict(compute_dtype="bfloat16", bias=True), "polymer"),
    "high": (dict(band_precision="high", bias=True), "polymer"),
}


@pytest.fixture(scope="module")
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _init(name, seed=3):
    """JAX configuration and parameters (non-zero W_i / W_h biases where
    ``bias``), and the port's model holding the same."""
    enc_kw, data = CONFIGS[name]
    fc = FeaturizationConfig(polymer=data == "polymer")
    enc = dict(dict(atom_fdim=fc.atom_fdim, bond_fdim=fc.bond_fdim(True),
                    hidden_size=32, depth=3, atom_messages=True,
                    band_precision="highest"), **enc_kw)
    model_kw = dict(ffn_num_layers=2, ffn_hidden_size=32, num_tasks=2)
    jcfg = JaxModelConfig(encoder=JaxEncoderConfig(**enc), **model_kw)
    cfg = ModelConfig(encoder=EncoderConfig(**enc), **model_kw)
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for layer in ("W_i", "W_h"):
        p = params["encoders"][0][layer]
        if cfg.encoder.bias:
            p["b"] = (0.1 * rng.normal(size=p["b"].shape)).astype(np.float32)
    model = convert.load_jax_params(MoleculeModel(cfg), params)
    return jcfg, cfg, data, params, model


def _graphs(data, pad_bonds=512):
    """(port GraphBatch, JAX GraphBatch, molecules) of pb's molecules or
    polymers; the JAX banded atom ops need at least 1,024 padded bonds
    (``EXT_A``), the other tests take 512."""
    polymer = data == "polymer"
    smiles = pb.POLYMERS if polymer else pb.SMILES
    kw = dict(pad_atoms=256, pad_bonds=pad_bonds, pad_mols=8)
    return (mol2graph(smiles, FeaturizationConfig(polymer=polymer), **kw),
            jax_mol2graph(smiles, JaxFcfg(polymer=polymer), **kw),
            len(smiles))


def _batch(name, pallas=False):
    """(JAX batch pytree, port batch on the dst-sorted branch, port batch on
    the natural-order branch) with the same targets, mask and weights; rows
    beyond the molecules are batch padding. The JAX Pallas branch gets
    1,024 padded bonds."""
    _, data = CONFIGS[name]
    gb, jgb, n = _graphs(data, 1024 if pallas else 512)
    rng = np.random.default_rng(0)
    M, T = 8, 2
    mask = (rng.uniform(size=(M, T)) > 0.25).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, size=(M, 1)).astype(np.float32)
    mask[n:], weights[n:] = 0.0, 0.0
    targets = (rng.normal(size=(M, T)) * mask).astype(np.float32)
    jbatch = {"graphs": [jax.tree_util.tree_map(jnp.asarray,
                                                jgb.arrays(pallas=pallas))],
              "targets": jnp.asarray(targets), "mask": jnp.asarray(mask),
              "weights": jnp.asarray(weights)}
    tensors = dict(targets=torch.from_numpy(targets),
                   mask=torch.from_numpy(mask),
                   weights=torch.from_numpy(weights))
    return (jbatch,
            dict(tensors, graphs=[batch_to_tensors(
                gb.arrays(sorted_aux=True), "cpu")]),
            dict(tensors, graphs=[batch_to_tensors(gb.arrays(), "cpu")]))


# -- the two ops --------------------------------------------------------------

def _op_inputs(data):
    """Port and JAX aux arrays of one batch, an (A, 128) table and a
    cotangent; the port's in its own tensors."""
    gb, jgb, _ = _graphs(data, 1024)
    aux = batch_to_tensors(gb.arrays(sorted_aux=True), "cpu")["sorted_aux"]
    jaux = jax.tree_util.tree_map(jnp.asarray,
                                  jgb.arrays(pallas=True)["pallas_aux"])
    A = gb.f_atoms.shape[0]
    rng = np.random.default_rng(7)
    h, g = (rng.normal(size=(A, 128)).astype(np.float32) for _ in range(2))
    return aux, jaux, A, h, g


def _vjp_both(port_op, jax_op, h, g):
    """(forward, VJP) of the port's op and of the JAX op on the same h, g."""
    t = torch.from_numpy(h).requires_grad_(True)
    out = port_op(t)
    dh, = torch.autograd.grad(out, t, torch.from_numpy(g))
    j_out, vjp = jax.vjp(jax_op, jnp.asarray(h))
    j_dh, = vjp(jnp.asarray(g))
    return ((out.detach().numpy(), dh.numpy()),
            (np.asarray(j_out), np.asarray(j_dh)))


@pytest.mark.parametrize("data", ["molecules", "polymer"])
def test_ops_and_vjps_match_the_jax_ops(interpret_mode, data):
    """Forward and VJP of both ops on rows 1 and up, unit weights on
    molecules, the asymmetric edge rules (w(u->v) != w(v->u)) of the
    polymers: the readout's VJP must take w[srev], not w."""
    aux, jaux, A, h, g = _op_inputs(data)
    if data == "polymer":
        w = aux["w_sorted"]
        assert not torch.equal(w, w[aux["srev"].long()])
    prec = jax.lax.Precision.HIGHEST
    for name, port_op, jax_op in (
            ("neighbor_sum", lambda x: bm.atom_neighbor_sum_sorted(x, aux),
             lambda x: pallas_mpnn.atom_neighbor_sum_sorted(x, jaux, A,
                                                            prec)),
            ("src_readout", lambda x: bm.src_readout_sorted(x, aux),
             lambda x: pallas_mpnn.src_readout_sorted(x, jaux, A, 128,
                                                      prec))):
        got, want = _vjp_both(port_op, jax_op, h, g)
        assert np.abs(want[0][1:]).max() > 1.0
        for what, a, b in zip(("out", "dh"), got, want):
            np.testing.assert_allclose(a[1:], b[1:], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {what}")
        # the plain versions are what the wrappers ran on the CPU
        x = torch.from_numpy(h)
        plain = (bm.atom_neighbor_sum_plain(x, aux["src_sorted"],
                                            aux["rowptr"])
                 if name == "neighbor_sum" else
                 bm.src_readout_plain(x, aux["w_sorted"], aux["src_sorted"],
                                      aux["rowptr"]))
        np.testing.assert_array_equal(plain.numpy(), got[0])
        assert (got[0][0] == 0).all() and (got[1][0] == 0).all()


def test_neighbor_sum_is_self_adjoint():
    """<N v, u> == <v, N u>: every bond's reverse is in the batch."""
    aux, _, A, h, g = _op_inputs("polymer")
    v, u = torch.from_numpy(h).double(), torch.from_numpy(g).double()
    nv = bm.atom_neighbor_sum_sorted(v, aux)
    nu = bm.atom_neighbor_sum_sorted(u, aux)
    lhs, rhs = float((nv * u).sum()), float((v * nu).sum())
    assert abs(lhs) > 1.0
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    # and the readout's transpose is the w[srev] readout
    w = aux["w_sorted"].double()
    aux64 = dict(aux, w_sorted=w)
    rv = bm.src_readout_sorted(v, aux64)
    rt = bm.src_readout_sorted(u, dict(aux64, w_sorted=w[aux["srev"].long()]))
    np.testing.assert_allclose(float((rv * u).sum()), float((v * rt).sum()),
                               rtol=1e-12)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_apply_model_on_both_branches(name):
    jcfg, cfg, _, params, model = _init(name)
    jbatch, tbatch, natural = _batch(name)
    n = int(np.asarray(jbatch["weights"]).astype(bool).sum())
    want = np.asarray(apply_model(params, jbatch["graphs"], jcfg))[:n]
    assert np.abs(want).max() > 1e-3
    rtol, atol = {"bf16": (BF16_RTOL, BF16_ATOL),
                  "high": (HIGH_RTOL, ATOL)}.get(name, (RTOL, ATOL))
    model.eval()
    for batch in (tbatch, natural):
        before = bm.launch_counts()
        with torch.inference_mode():
            got = model(batch["graphs"]).numpy()[:n]
        assert bm.launch_counts() == before      # CPU: the plain versions
        assert got.shape == want.shape == (n, cfg.num_tasks)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_pallas_branch_forward_and_gradients(interpret_mode):
    """The JAX package's banded branch (the two ops in interpret mode, three
    bf16 passes at ``band_precision="high"``) on polymer data with bias,
    against the port's sorted branch (FP32 sums at every setting): the
    JAX package's own tolerances for that branch, rtol 1e-4 forward and
    1e-3 / 1e-4 for the gradients."""
    jcfg, cfg, _, params, model = _init("high")
    jbatch, tbatch, _ = _batch("high", pallas=True)
    assert "ra" in jbatch["graphs"][0]["pallas_aux"]
    n = int(np.asarray(jbatch["weights"]).astype(bool).sum())
    want = np.asarray(apply_model(params, jbatch["graphs"], jcfg))[:n]
    with torch.inference_mode():
        got = model.eval()(tbatch["graphs"]).numpy()[:n]
    np.testing.assert_allclose(got, want, rtol=HIGH_RTOL, atol=1e-5)
    tw = np.linspace(0.5, 1.5, cfg.num_tasks).astype(np.float32)
    want_loss, want_g = jax.value_and_grad(
        lambda p: jax_make_loss_fn(jcfg, jnp.asarray(tw))(p, jbatch, None)
    )(params)
    model.train()
    loss = make_loss_fn(cfg, torch.from_numpy(tw))(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    pb._assert_tree_close(pb._port_grads(model), want_g, 1e-3, 1e-4)


@pytest.mark.parametrize("name", ["regression", "polymer", "bias"])
def test_model_gradients_match_jax_grad(name):
    """Every parameter's gradient on both port branches against jax.grad of
    the JAX package's loss on its XLA branch."""
    jcfg, cfg, _, params, model = _init(name)
    jbatch, tbatch, natural = _batch(name)
    tw = np.linspace(0.5, 1.5, cfg.num_tasks).astype(np.float32)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_make_loss_fn(jcfg, jnp.asarray(tw))(p, jbatch, None)
    )(params)
    model.train()
    for batch in (tbatch, natural):
        model.zero_grad()
        loss = make_loss_fn(cfg, torch.from_numpy(tw))(model, batch)
        loss.backward()
        got = pb._port_grads(model)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=G_RTOL)
        pb._assert_tree_close(got, want, G_RTOL, G_ATOL)
        # W_h's bond-feature half is trained
        assert np.abs(got["encoders"][0]["W_h"]["w"][32:]).max() > 0
        if cfg.encoder.bias:
            assert np.abs(got["encoders"][0]["W_h"]["b"]).max() > 0


def test_model_shapes_and_undirected_refused():
    _, cfg, _, params, model = _init("bias")
    enc = model.encoders[0]
    assert enc.W_i.in_features == cfg.encoder.atom_fdim == 133
    assert enc.W_h.in_features == 32 + cfg.encoder.bond_fdim
    assert cfg.encoder.bond_fdim == 14
    # JAX (in, out) <-> torch (out, in), transposed once each way
    np.testing.assert_array_equal(enc.W_h.weight.detach().numpy(),
                                  params["encoders"][0]["W_h"]["w"].T)
    back = convert.params_to_jax(model)
    np.testing.assert_array_equal(back["encoders"][0]["W_h"]["w"],
                                  params["encoders"][0]["W_h"]["w"])
    with pytest.raises(ValueError, match="Undirected is unnecessary"):
        EncoderConfig(atom_fdim=133, bond_fdim=14, atom_messages=True,
                      undirected=True).check_supported()


# -- training -----------------------------------------------------------------

SMALL = dict(hidden_size=32, depth=3, ffn_num_layers=2, epochs=2,
             batch_size=10, max_data_size=60, num_workers=1, quiet=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2-epoch ``atom_messages`` run of each package on the same 60
    molecules (the port computing FP32 at "highest", as JAX's CPU path
    does at any band_precision)."""
    root = tmp_path_factory.mktemp("atom_messages_runs")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    kw = dict(data_path=REGRESSION, dataset_type="regression",
              grad_clip=2.0, atom_messages=True, band_precision="highest",
              **SMALL)
    port = cross_validate(TrainConfig(save_dir=port_dir, device="cpu", **kw))
    jax_ = jax_cross_validate(JaxTrainConfig(save_dir=jax_dir, **kw))
    return port_dir, jax_dir, port, jax_, kw


def test_cross_validate_matches_jax_package(runs):
    port_dir, jax_dir, port, jax_, _ = runs
    np.testing.assert_allclose(port, jax_, rtol=1e-4)
    pb_train = __import__("test_torch_plain_band_train")
    pb_train._assert_logs_close(pb_train._log(port_dir),
                                pb_train._log(jax_dir))
    params, config, _, _ = load_checkpoint(
        os.path.join(port_dir, "fold_0", "model_0", "model.ckpt"))
    assert config["atom_messages"] is True
    assert params["encoders"][0]["W_i"]["w"].shape == (133, 32)
    assert params["encoders"][0]["W_h"]["w"].shape == (32 + 14, 32)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_resume_across_packages(runs, tmp_path, writer, reader):
    """A third epoch from the ``model.ckpt`` that ``writer`` wrote, in
    ``reader``, against the writer's own package resuming from it."""
    port_dir, jax_dir, _, _, kw = runs
    kw = dict(kw, epochs=3)
    ckpt = os.path.join(port_dir if writer == "port" else jax_dir, "fold_0",
                        "model_0", "model.ckpt")

    def resume(package, out):
        if package == "port":
            cross_validate(TrainConfig(save_dir=out, device="cpu",
                                       resume_from_checkpoint=ckpt, **kw))
        else:
            jax_cross_validate(JaxTrainConfig(
                save_dir=out, resume_from_checkpoint=ckpt, **kw))
        with open(os.path.join(out, "verbose.log")) as f:
            line = [l for l in f.read().splitlines()
                    if l.startswith("Epoch 2:")][0]
        saved = os.path.join(out, "fold_0", "model_0", "model.ckpt")
        return (float(line.split("train loss = ")[1].split(",")[0]),
                load_checkpoint(saved), load_opt_leaves(saved))

    want_loss, want_ckpt, want_opt = resume(writer, str(tmp_path / "ref"))
    loss, got_ckpt, got_opt = resume(reader, str(tmp_path / "got"))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3)
    assert got_ckpt[3] == want_ckpt[3] == 2
    assert int(got_opt[0]) == int(want_opt[0]) == 15
    assert len(got_opt) == len(want_opt)
    for a, b in zip(got_opt, want_opt):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-7)
    np.testing.assert_allclose(got_ckpt[0]["encoders"][0]["W_h"]["w"],
                               want_ckpt[0]["encoders"][0]["W_h"]["w"],
                               rtol=1e-3, atol=1e-6)


def test_cli_train_predict_fingerprint(tmp_path):
    run = tmp_path / "run"
    cli.main(["train", "--data_path", REGRESSION, "--dataset_type",
              "regression", "--save_dir", str(run), "--epochs", "1",
              "--max_data_size", "30", "--hidden_size", "16", "--quiet",
              "--num_workers", "1", "--atom_messages", "--device", "cpu"])
    _, config, _, _ = load_checkpoint(
        str(run / "fold_0" / "model_0" / "best_model.ckpt"))
    assert config["atom_messages"]
    test_path = os.path.join(os.path.dirname(REGRESSION),
                             "regression_test_smiles.csv")
    for command, extra in (("predict", []),
                           ("fingerprint", ["--fingerprint_type", "MPN"])):
        out = tmp_path / f"{command}.csv"
        cli.main([command, "--test_path", test_path, "--checkpoint_dir",
                  str(run), "--preds_path", str(out), "--num_workers", "1",
                  "--device", "cpu", *extra])
        with open(out) as f:
            rows = list(csv.reader(f))[1:]
        values = np.asarray([r[1:] for r in rows], float)
        assert values.size and np.isfinite(values).all()
        assert values.shape[1] == (16 if command == "fingerprint" else 1)


def test_reference_stream_init_matches_jax_package():
    from polymer_chemprop_tpu.models.torch_init import reference_init_params
    from polymer_chemprop_tpu.train.trainer import (
        build_model_config as jax_build_model_config,
    )
    from polymer_chemprop_tpu_torch.models.init import reference_init_model
    from polymer_chemprop_tpu_torch.models.model import build_model_config
    kw = dict(hidden_size=32, ffn_num_layers=3, atom_messages=True,
              bias=True)
    cfg = build_model_config(TrainConfig(**kw), 2)
    jcfg = jax_build_model_config(JaxTrainConfig(**kw), 2)
    got = convert.params_to_jax(reference_init_model(cfg, 11, 1))
    want = reference_init_params(jcfg, 11, 1)
    assert got["encoders"][0]["W_h"]["w"].shape == (32 + 14, 32)
    flat = jax.tree_util.tree_leaves_with_path(want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat) == len(flat_got)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_got[path], leaf)


# -- bond_message_step_natural ------------------------------------------------

def test_bond_message_step_natural(interpret_mode):
    """Real rows against ``bond_message_step_pallas`` (interpret mode) and
    the port's segment-sum step; launches count under ``band_agg``."""
    gb, jgb, _ = _graphs("polymer", 1024)
    batch = batch_to_tensors(gb.arrays(sorted_aux=True), "cpu")
    jaux = jax.tree_util.tree_map(jnp.asarray,
                                  jgb.arrays(pallas=True)["pallas_aux"])
    A, B, n_real = gb.f_atoms.shape[0], gb.f_bonds.shape[0], gb.n_bonds_real
    rng = np.random.default_rng(5)
    m = rng.normal(size=(B, 24)).astype(np.float32)
    t = torch.from_numpy(m).requires_grad_(True)
    got = bm.bond_message_step_natural(t, batch["sorted_aux"])
    natural = {k: torch.from_numpy(v) for k, v in gb.arrays().items()}
    ref = bond_message_step(torch.from_numpy(m), natural["w_bonds"],
                            natural["b2a"], natural["b2dst"],
                            natural["b2revb"], A)
    want = np.asarray(pallas_mpnn.bond_message_step_pallas(jnp.asarray(m),
                                                           jaux))
    xla = np.asarray(jax_bond_message_step(
        jnp.asarray(m), *(jnp.asarray(gb.arrays()[k])
                          for k in ("w_bonds", "b2a", "b2dst", "b2revb")), A))
    real = slice(1, n_real)
    for other in (ref.numpy(), want, xla):
        np.testing.assert_allclose(got.detach().numpy()[real], other[real],
                                   rtol=RTOL, atol=ATOL)
    # differentiable through both permutations: the VJP of the real rows
    g = rng.normal(size=(B, 24)).astype(np.float32)
    g[n_real:] = 0.0
    g[0] = 0.0
    dm, = torch.autograd.grad(got, t, torch.from_numpy(g))
    t2 = torch.from_numpy(m).requires_grad_(True)
    dm_ref, = torch.autograd.grad(
        bond_message_step(t2, natural["w_bonds"], natural["b2a"],
                          natural["b2dst"], natural["b2revb"], A),
        t2, torch.from_numpy(g))
    np.testing.assert_allclose(dm.numpy()[real], dm_ref.numpy()[real],
                               rtol=RTOL, atol=ATOL)
