"""``band_precision`` in the port: the split-bf16 product of the W_h-fused
layer forms (``rev``, the default configuration's, and ``matmul_act``,
``undirected``) against the JAX package, on the CPU.

* the port's split product (``split_matmul``, three passes) against the
  JAX package's ``_dot_band`` at ``Precision.HIGH``: within 1e-6 x max|JAX|
  (the same exactly representable products, float32 sums in another
  order);
* ``band_matmul_plain``, ``band_matmul_act_plain`` and
  ``band_rev_layer_plain`` at ``"high"`` against
  ``band_matmul_step_sorted``, ``band_matmul_act_step_sorted`` and
  ``band_rev_layer_step_sorted`` at ``Precision.HIGH`` (Pallas kernels in
  interpret mode), unit and polymer (untidy) weights, relu, tanh and selu:
  within 5e-5 x max|JAX|. The JAX kernels also split their aggregation
  ``q @ m`` into bf16 halves, while the port sums the CSR run in float32,
  so z differs by about 2^-17 of |m| before the product. Measured here:
  5.3e-6 without activation, up to 2.6e-5 after tanh (whose output is at
  most 1 while its inputs are larger), the same size as JAX's own HIGH
  against HIGHEST (3.9e-5), so the tolerance stays at 5e-5;
* the default (directed) and the ``undirected`` model at ``"high"``
  against JAX ``apply_model`` at ``band_precision="high"`` on its
  sorted-resident Pallas branch: predictions rtol 1e-4, atol 1e-5 (the
  JAX package's own tolerance for this setting), the loss rtol 1e-4 and
  every gradient within 1e-4 x its largest entry (the backward is FP32 in
  the port, split in the JAX kernels);
* ``"default"`` (one bf16 pass) against FP64 within 1e-2 x max, for both
  forms: XLA on the CPU computes JAX's ``Precision.DEFAULT`` in full
  float32, so there is no JAX reference for it here;
* ``EncoderConfig`` rejects an unknown ``band_precision``; a model built
  from a configuration carries it, and its layer follows it.

Inputs from a numpy seed; hidden 32, 512 padded bonds. The tensor-core
kernels themselves are held against these plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_band_ops as bo
import test_torch_plain_band as pb
from polymer_chemprop_tpu.models import EncoderConfig as JaxEncoderConfig
from polymer_chemprop_tpu.models import ModelConfig as JaxModelConfig
from polymer_chemprop_tpu.models import apply_model, init_model
from polymer_chemprop_tpu.ops import pallas_mpnn as jpm
from polymer_chemprop_tpu.train.step import make_loss_fn as jax_make_loss_fn
from polymer_chemprop_tpu_torch.config import TrainConfig
from polymer_chemprop_tpu_torch.models import convert
from polymer_chemprop_tpu_torch.models.encoder import (
    EncoderConfig,
    batch_to_tensors,
)
from polymer_chemprop_tpu_torch.models.model import (
    ModelConfig,
    MoleculeModel,
    build_model_config,
)
from polymer_chemprop_tpu_torch.models.nn import get_activation
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from polymer_chemprop_tpu_torch.train.step import make_loss_fn
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HIGH = jax.lax.Precision.HIGH
H = bo.H
SPLIT_RTOL = 1e-6
OP_RTOL = 5e-5
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
GRAD_RTOL = 1e-4
DEFAULT_RTOL = 1e-2


def _max_err(got, want):
    """max|got - want| over max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_split_product_is_dot_band_at_high():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(96, 80)).astype(np.float32)
    b = (rng.normal(size=(80, 48)) * 0.2).astype(np.float32)
    want = np.asarray(jpm._dot_band(jnp.asarray(a), jnp.asarray(b), HIGH))
    got = bm.split_matmul(torch.from_numpy(a), torch.from_numpy(b), 3)
    assert _max_err(got, want) <= SPLIT_RTOL
    # and it is the split, not float32: the dropped lo x lo term shows
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert 1e-8 < _max_err(got, exact) < 3e-5
    np.testing.assert_array_equal(
        bm.band_product(torch.from_numpy(a), torch.from_numpy(b),
                        "high").numpy(), got.numpy())


@pytest.mark.parametrize("kind", bo.KINDS)
def test_band_matmul_plain_at_high_matches_jax_kernel(interpret_mode, kind):
    c = bo.Case(kind)
    want = np.asarray(jpm.band_matmul_step_sorted(
        bo._pad(c.m), jnp.asarray(c.wh), c.j, HIGH))[:, :H]
    before = bm.launch_counts(), bm.tc_launch_counts()
    got = bm.band_matmul_step_sorted(torch.from_numpy(c.m),
                                     torch.from_numpy(c.wh), c.t,
                                     "high").numpy()
    assert (bm.launch_counts(), bm.tc_launch_counts()) == before
    assert _max_err(got, want) <= OP_RTOL
    out, z = bm.band_matmul_plain(torch.from_numpy(c.m),
                                  torch.from_numpy(c.wh), *c.idx(), "high")
    np.testing.assert_array_equal(out[c.t["srev"].long()].numpy(), got)
    # z is the float32 aggregation at every precision
    np.testing.assert_array_equal(
        z.numpy(), bm.band_agg_plain(torch.from_numpy(c.m), *c.idx()).numpy())
    # "high" is not "highest"
    highest = bm.band_matmul_step_sorted(torch.from_numpy(c.m),
                                         torch.from_numpy(c.wh), c.t).numpy()
    assert _max_err(got, highest) > 1e-8


def _rev_case(c):
    """``(m, inp)`` of a case zero on padding rows, as the default
    encoder keeps its messages, and the rev form's index tensors."""
    real = (np.arange(c.B) < c.n_real)[:, None].astype(np.float32)
    idx = (c.t["w_sorted"], c.t["src_sorted"], c.t["srev"], c.t["rowptr"])
    return c.m * real, c.inp * real, idx


@pytest.mark.parametrize("act", ["relu", "tanh", "selu"])
@pytest.mark.parametrize("kind", bo.KINDS)
@pytest.mark.parametrize("form", ["matmul_act", "rev"])
def test_band_matmul_act_plain_at_high_matches_jax_kernel(interpret_mode,
                                                          form, kind, act):
    """The fused layer's plain version at "high" against the JAX op at
    ``Precision.HIGH``: ``band_matmul_act_step_sorted`` or, for the rev
    form, ``band_rev_layer_step_sorted``."""
    c = bo.Case(kind, seed=len(act))
    if form == "rev":
        assert "rs_rev" in c.j          # the JAX rev-fused kernel runs
        m, inp, idx = _rev_case(c)
        want = np.asarray(jpm.band_rev_layer_step_sorted(
            bo._pad(m), jnp.asarray(c.wh), bo._pad(inp), c.j, act,
            HIGH))[:, :H]
        before = bm.launch_counts(), bm.tc_launch_counts()
        got = bm.band_rev_layer(torch.from_numpy(m), torch.from_numpy(inp),
                                torch.from_numpy(c.wh), *idx, act,
                                "high").numpy()
        assert (bm.launch_counts(), bm.tc_launch_counts()) == before
        assert _max_err(got, want) <= OP_RTOL
        assert (got[c.n_real:] == 0).all()
        highest = bm.band_rev_layer_plain(
            torch.from_numpy(m), torch.from_numpy(inp),
            torch.from_numpy(c.wh), *idx, act).numpy()
        assert _max_err(got, highest) > 1e-8       # "high" is not "highest"
        return
    inp_srev = c.inp[c.aux.srev]
    want = np.asarray(jpm.band_matmul_act_step_sorted(
        bo._pad(c.m), jnp.asarray(c.wh), bo._pad(inp_srev), c.j, act,
        HIGH))[:, :H]
    got = bm.band_matmul_act_step_sorted(
        torch.from_numpy(c.m), torch.from_numpy(c.wh),
        torch.from_numpy(inp_srev), c.t, act, "high").numpy()
    assert _max_err(got, want) <= OP_RTOL
    plain = bm.band_matmul_act_plain(
        torch.from_numpy(c.m), torch.from_numpy(inp_srev),
        torch.from_numpy(c.wh), *c.idx(), act, "high")
    np.testing.assert_array_equal(plain[c.t["srev"].long()].numpy(), got)


@pytest.mark.parametrize("kind", bo.KINDS)
@pytest.mark.parametrize("form", ["matmul_act", "rev"])
def test_default_precision_is_one_bf16_pass(form, kind):
    c = bo.Case(kind)
    if form == "rev":
        # the layer's pre-activation: leakyrelu is linear above 0 and keeps
        # 0.1 of it below, so the rev layer's output is held here
        m, inp, idx = _rev_case(c)
        m, inp, wh = (torch.from_numpy(x) for x in (m, inp, c.wh))
        act = get_activation("leakyrelu")
        z = bm.band_rev_z_plain(m.double(), idx[0].double(), *idx[1:])
        exact = act(inp.double() + z @ wh.double()).numpy()
        got = bm.band_rev_layer_plain(m, inp, wh, *idx, "leakyrelu",
                                      "default")
        err = _max_err(got, exact)
        assert 1e-5 < err <= DEFAULT_RTOL
        zf = bm.band_rev_z_plain(m, *idx)
        np.testing.assert_array_equal(
            got.numpy(), act(inp + bm.split_matmul(zf, wh, 1)).numpy())
        high = bm.band_rev_layer_plain(m, inp, wh, *idx, "leakyrelu", "high")
        assert _max_err(high, exact) < err / 20
        return
    m, wh = torch.from_numpy(c.m), torch.from_numpy(c.wh)
    z = bm.band_agg_plain(m.double(), c.t["w_sorted"].double(),
                          c.t["rowptr"])
    exact = (z @ wh.double()).numpy()
    got, _ = bm.band_matmul_plain(m, wh, *c.idx(), "default")
    err = _max_err(got, exact)
    assert 1e-5 < err <= DEFAULT_RTOL
    # it is the hi x hi pass alone
    zf = bm.band_agg_plain(m, *c.idx())
    np.testing.assert_array_equal(got.numpy(),
                                  bm.split_matmul(zf, wh, 1).numpy())
    # and three passes come much closer
    high, _ = bm.band_matmul_plain(m, wh, *c.idx(), "high")
    assert _max_err(high, exact) < err / 20


def _undirected_high(form="matmul_act", seed=3):
    """The model at "high" whose layer takes ``form``: ``undirected``
    (``matmul_act``) or the default configuration (``rev``); both run on
    the molecules of tests/test_torch_plain_band.py."""
    enc_kw, _, data = pb.CONFIGS["undirected"]
    if form == "rev":
        enc_kw = {}
    enc = dict(atom_fdim=133, bond_fdim=147, hidden_size=32, depth=3,
               band_precision="high", **enc_kw)
    model_kw = dict(ffn_num_layers=2, ffn_hidden_size=32, num_tasks=2)
    jcfg = JaxModelConfig(encoder=JaxEncoderConfig(**enc), **model_kw)
    cfg = ModelConfig(encoder=EncoderConfig(**enc), **model_kw)
    assert cfg.encoder.layer_form() == form
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(seed), jcfg))
    model = convert.load_jax_params(MoleculeModel(cfg), params)
    return jcfg, cfg, data, params, model


@pytest.mark.parametrize("form", ["matmul_act", "rev"])
def test_undirected_model_at_high_matches_apply_model(interpret_mode, form):
    jcfg, cfg, data, params, model = _undirected_high(form)
    gb, jgb, n = pb._graphs(data)
    batch = jax.tree_util.tree_map(jnp.asarray, jgb.arrays(pallas=True))
    want = np.asarray(apply_model(params, [batch], jcfg))[:n]
    tbatch = batch_to_tensors(gb.arrays(sorted_aux=True), "cpu")
    with torch.inference_mode():
        got = model.eval()([tbatch]).numpy()[:n]
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    # the same model at "highest" is another computation
    fp32 = MoleculeModel(dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder,
                                         band_precision="highest")))
    fp32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        other = fp32.eval()([tbatch]).numpy()[:n]
    assert np.abs(other - got).max() > 0


@pytest.mark.parametrize("form", ["matmul_act", "rev"])
def test_undirected_gradients_at_high_match_jax_grad(interpret_mode, form):
    jcfg, cfg, _, params, model = _undirected_high(form)
    name = "undirected"
    # pb._batch builds the port's batch from pb's own (FP32, undirected)
    # configuration; the graphs and targets are the same for both forms
    jbatch, tbatch = pb._batch(name, pallas=True)
    tw = np.linspace(0.5, 1.5, cfg.num_tasks).astype(np.float32)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_make_loss_fn(jcfg, jnp.asarray(tw))(p, jbatch, None)
    )(params)
    model.train()
    loss = make_loss_fn(cfg, torch.from_numpy(tw))(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=GRAD_RTOL)
    pb._assert_tree_close(pb._port_grads(model), want, GRAD_RTOL,
                          rel_to_max=True)


def test_encoder_config_checks_band_precision():
    for precision in bm.PRECISIONS:
        assert EncoderConfig(atom_fdim=133, bond_fdim=147,
                             band_precision=precision).band_precision \
            == precision
    assert EncoderConfig(atom_fdim=133, bond_fdim=147).band_precision == "high"
    with pytest.raises(ValueError, match="band_precision"):
        EncoderConfig(atom_fdim=133, bond_fdim=147, band_precision="HIGH")
    with pytest.raises(ValueError, match="band_precision"):
        bm.band_matmul_plain(torch.zeros(4, 2), torch.zeros(2, 2),
                             torch.zeros(4), torch.zeros(3, dtype=torch.int32),
                             "fp32")


@pytest.mark.parametrize("precision", bm.PRECISIONS)
def test_model_from_a_config_carries_band_precision(precision):
    cfg = TrainConfig(data_path="x.csv", undirected=True,
                      band_precision=precision, device="cpu")
    model = MoleculeModel(build_model_config(cfg, num_tasks=1))
    assert model.cfg.encoder.band_precision == precision
    assert model.encoders[0].cfg.band_precision == precision


@pytest.fixture(scope="module")
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield

