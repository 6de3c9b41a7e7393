"""The training operators in the port vs the JAX package.

* ``band_rev_bwd`` (plain version, CPU) against the JAX package's
  ``_band_rev_bwd_apply`` Pallas kernel in interpret mode and against the
  dense ``M^T g`` built with numpy;
* the two ``torch.autograd.Function``s (hand-written backward, plain
  kernels on the CPU) against PyTorch's autograd through the plain
  forwards, against ``jax.grad`` of ``band_rev_layer_step_sorted`` (Pallas,
  interpret mode) and against ``jax.grad`` of the XLA layer;
* every loss and ``masked_loss``, every schedule (against optax), every
  metric (against the JAX package's scikit-learn-backed one).

Inputs are made with numpy from a seed and fed to both. Tolerances: rtol
1e-5, atol 1e-6 for single operators (FP32 on both sides, sums in another
order); gradients that pass through a matrix product get rtol 1e-4, atol
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.ops import segment as jseg
from polymer_chemprop_tpu.ops.pallas_mpnn import (
    _band_rev_bwd_apply,
    band_rev_layer_step_sorted,
)
from polymer_chemprop_tpu.ops.pallas_mpnn import (
    build_sorted_aux as jax_build_sorted_aux,
)
from polymer_chemprop_tpu.models.nn import get_activation as jax_activation
from polymer_chemprop_tpu.train import loss as jloss
from polymer_chemprop_tpu.train import metrics as jmetrics
from polymer_chemprop_tpu.train import scheduler as jsched
from polymer_chemprop_tpu_torch.features import FeaturizationConfig, mol2graph
from polymer_chemprop_tpu_torch.ops import band_mpnn
from polymer_chemprop_tpu_torch.ops.sorted_aux import build_sorted_aux
from polymer_chemprop_tpu_torch.train import loss as tloss
from polymer_chemprop_tpu_torch.train import metrics as tmetrics
from polymer_chemprop_tpu_torch.train import scheduler as tsched
from test_torch_threads import torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
H = 32
ACTS = ["relu", "leakyrelu", "prelu", "tanh", "elu", "selu"]
SMILES = ["CCO", "c1ccccc1", "CC(C)=CCCC(C)=CC(=O)", "C",
          "CCOc1ccc2nc(S(N)(=O)=O)sc2c1",
          "OCC3OC(OCC2OC(OC(C#N)c1ccccc1)C(O)C(O)C2O)C(O)C(O)C3O"]
POLYMERS = ["[*:1]CC[*:2].[*:3]CO[*:4]|0.5|0.5|<1-3:0.5:0.5<2-4:0.5:0.5~20",
            "[*:1]c1ccc([*:2])cc1.[*:3]C(C)C[*:4]|0.25|0.75|"
            "<1-3:0.25:0.75<2-4:0.75:0.25~100",
            "[*:1]CC[*:2].[*:3]c1ccc([*:4])cc1C|0.75|0.25|"
            "<1-3:0.5:0.5<2-4:0.5:0.5~7"]


@pytest.fixture(scope="module")
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _batch(kind):
    """A 512-bond batch with padding rows: GraphBatch, port aux (tensors),
    JAX aux (jnp) with the band windows."""
    if kind == "polymer":
        gb = mol2graph(POLYMERS, FeaturizationConfig(polymer=True),
                       pad_atoms=256, pad_bonds=512)
        # untidy weights on top of the polymer weights
        rng = np.random.default_rng(1)
        w = np.where(gb.w_bonds > 0,
                     gb.w_bonds * rng.uniform(0.3, 1.0, gb.w_bonds.shape),
                     0.0).astype(np.float32)
    else:
        gb = mol2graph(SMILES, pad_atoms=256, pad_bonds=512)
        w = gb.w_bonds
    A = gb.f_atoms.shape[0]
    aux = build_sorted_aux(gb.b2dst, gb.b2revb, w, num_atoms=A)
    jaux = jax_build_sorted_aux(gb.b2dst, gb.b2revb, w, num_atoms=A)
    assert jaux.rs_rev is not None
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in aux._asdict().items()}
    jd = {k: jnp.asarray(v) for k, v in jaux._asdict().items()
          if v is not None}
    return gb, w, aux, t, jd


def _pad(x):
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - H)))


def _dense_m(aux):
    """The (B, B) matrix M of z = M m, from the sorted index arrays."""
    B = aux.srev.shape[0]
    M = np.zeros((B, B), np.float64)
    for t in range(B):
        s = aux.src_sorted[t]
        for c in range(aux.rowptr[s], aux.rowptr[s + 1]):
            M[t, c] += aux.w_sorted[c]
        M[t, aux.srev[t]] -= 1.0
    return M


@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_band_rev_bwd_plain_matches_jax_kernel_and_dense(interpret_mode, kind):
    gb, _, aux, t, jd = _batch(kind)
    B, n_real = gb.f_bonds.shape[0], gb.n_bonds_real - 1
    assert n_real < B  # there are padding rows
    g = np.random.default_rng(3).normal(size=(B, H)).astype(np.float32)
    before = band_mpnn.band_rev_bwd.launches
    got = band_mpnn.band_rev_bwd(torch.from_numpy(g), t["w_sorted"],
                                 t["srev"], t["rowptr"]).numpy()
    assert band_mpnn.band_rev_bwd.launches == before  # CPU: plain version
    want = np.asarray(_band_rev_bwd_apply(
        _pad(g), jd["w_sorted"], jd["dst_sorted"], jd["src_sorted"],
        jd["srev"], jd["rs_rev"], jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(got, want[:, :H], rtol=RTOL, atol=ATOL)
    dense = _dense_m(aux).T @ g.astype(np.float64)
    np.testing.assert_allclose(got, dense, rtol=RTOL, atol=ATOL)
    # padding rows: zero weight, own reverse -> dm = -g exactly
    np.testing.assert_array_equal(got[n_real:], -g[n_real:])


def _layer_inputs(B, n_real, seed):
    rng = np.random.default_rng(seed)
    real = np.zeros((B, 1), np.float32)
    real[:n_real] = 1.0
    m = (rng.normal(size=(B, H)) * real).astype(np.float32)
    inp = (rng.normal(size=(B, H)) * real).astype(np.float32)
    wh = (rng.normal(size=(H, H)) * 0.2).astype(np.float32)
    g_out = rng.normal(size=(B, H)).astype(np.float32)
    return m, inp, wh, g_out


def _port_layer_grads(layer, readout, m, inp, wh, t, act, g_out, g_atoms):
    leaves = [torch.from_numpy(x).clone().requires_grad_(True)
              for x in (m, wh, inp)]
    out = layer(leaves[0], leaves[2], leaves[1], t["w_sorted"],
                t["src_sorted"], t["srev"], t["rowptr"], act)
    atoms = readout(out)
    grads = torch.autograd.grad(
        [out, atoms], leaves,
        [torch.from_numpy(g_out), torch.from_numpy(g_atoms)])
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_function_backward_matches_autograd_through_plain(kind, act):
    """The hand-written (dm, dW_h, dinp) and the readout's dm against
    PyTorch's own differentiation of the plain forwards."""
    gb, _, _, t, _ = _batch(kind)
    B, A = gb.f_bonds.shape[0], gb.f_atoms.shape[0]
    m, inp, wh, g_out = _layer_inputs(B, gb.n_bonds_real - 1, len(act))
    g_atoms = np.random.default_rng(9).normal(size=(A, H)).astype(np.float32)
    got = _port_layer_grads(
        band_mpnn.band_rev_layer,
        lambda x: band_mpnn.atom_readout(x, t["w_sorted"], t["rowptr"],
                                         t["dst_sorted"]),
        m, inp, wh, t, act, g_out, g_atoms)
    want = _port_layer_grads(
        band_mpnn.band_rev_layer_plain,
        lambda x: band_mpnn.atom_readout_plain(x, t["w_sorted"], t["rowptr"]),
        m, inp, wh, t, act, g_out, g_atoms)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    # without dst_sorted the readout rebuilds it from rowptr: the same
    # destinations, so the same gradients bit for bit (one thread: each
    # product sums in one order on both runs)
    assert torch.get_num_threads() == 1
    assert torch.equal(band_mpnn.dst_from_rowptr(t["rowptr"], B),
                       t["dst_sorted"].long())
    again = _port_layer_grads(
        band_mpnn.band_rev_layer,
        lambda x: band_mpnn.atom_readout(x, t["w_sorted"], t["rowptr"]),
        m, inp, wh, t, act, g_out, g_atoms)
    for g, w in zip(again, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("branch", ["pallas", "xla"])
def test_function_backward_matches_jax_grad(interpret_mode, branch):
    """(dm, dW_h, dinp) against jax.grad of the JAX package's layer: its
    Pallas custom_vjp in interpret mode, and the natural-order XLA layer."""
    act = "tanh" if branch == "pallas" else "selu"
    gb, w, aux, t, jd = _batch("polymer")
    B, A = gb.f_bonds.shape[0], gb.f_atoms.shape[0]
    m, inp, wh, g_out = _layer_inputs(B, gb.n_bonds_real - 1, 7)
    got = _port_layer_grads(
        band_mpnn.band_rev_layer,
        lambda x: band_mpnn.atom_readout(x, t["w_sorted"], t["rowptr"]),
        m, inp, wh, t, act, g_out, np.zeros((A, H), np.float32))
    if branch == "pallas":
        def f(m_, wh_, inp_):
            out = band_rev_layer_step_sorted(
                _pad(m_), wh_, _pad(inp_), jd, act,
                jax.lax.Precision.HIGHEST)
            return jnp.sum(out[:, :H] * g_out)
        want = jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(m), jnp.asarray(wh), jnp.asarray(inp))
    else:
        perm = aux.perm
        inv = np.argsort(perm)

        def f(m_, wh_, inp_):  # sorted in, natural-order layer, sorted out
            z = jseg.bond_message_step(
                m_[inv], jnp.asarray(w), jnp.asarray(gb.b2a),
                jnp.asarray(gb.b2dst), jnp.asarray(gb.b2revb), A)
            out = jax_activation(act)(inp_[inv] + z @ wh_)
            return jnp.sum(out[perm] * g_out)
        want = jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(m), jnp.asarray(wh), jnp.asarray(inp))
    want = [np.asarray(x) for x in want]
    if branch == "xla":
        # in natural order every padding bond has slot 0 as its reverse, so
        # their cotangents pile onto that one row; sorted, each padding bond
        # is its own reverse. No parameter sees either (padding messages
        # are constant zeros), so dm is compared on the real rows.
        n_real = gb.n_bonds_real - 1
        got[0], want[0] = got[0][:n_real], want[0][:n_real]
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=1e-5)


def test_inference_passes_no_z_and_training_does(monkeypatch):
    gb, _, _, t, _ = _batch("molecules")
    m, inp, wh, _ = _layer_inputs(gb.f_bonds.shape[0], gb.n_bonds_real - 1, 0)
    seen = []
    real = band_mpnn.band_rev_layer_forward
    # want_z, the ninth argument
    monkeypatch.setattr(band_mpnn, "band_rev_layer_forward",
                        lambda *a: seen.append(a[8]) or real(*a))
    T = torch.from_numpy
    rest = (T(inp), T(wh), t["w_sorted"], t["src_sorted"], t["srev"],
            t["rowptr"], "relu")
    band_mpnn.band_rev_layer(T(m), *rest)
    with torch.inference_mode():
        band_mpnn.band_rev_layer(T(m), *rest)
    band_mpnn.band_rev_layer(T(m).requires_grad_(True), *rest)
    assert seen == [False, False, True]


# -- losses ------------------------------------------------------------------

def _loss_inputs(seed, shape=(7, 5)):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=shape).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    return rng, preds, mask


@pytest.mark.parametrize("name", ["bce_with_logits", "mse",
                                  "cross_entropy_multiclass", "sid_loss",
                                  "wasserstein_loss"])
def test_loss_matches_jax(name):
    rng, preds, mask = _loss_inputs(len(name))
    T, J = torch.from_numpy, jnp.asarray
    if name == "cross_entropy_multiclass":
        preds = rng.normal(size=(7, 5, 3)).astype(np.float32)
        targets = rng.integers(0, 3, size=(7, 5)).astype(np.float32)
        args = (preds, targets)
    elif name in ("sid_loss", "wasserstein_loss"):
        preds = np.exp(preds)
        mask[0] = 0.0  # a fully masked spectrum
        targets = rng.uniform(0.01, 1.0, size=preds.shape).astype(np.float32)
        targets = targets / targets.sum(1, keepdims=True)
        args = (preds, targets, mask)
    elif name == "bce_with_logits":
        preds = preds * 20  # saturating logits
        args = (preds, (rng.uniform(size=preds.shape) > 0.5)
                .astype(np.float32))
    else:
        args = (preds, rng.normal(size=preds.shape).astype(np.float32))
    for extra in ([()] if name not in ("sid_loss", "wasserstein_loss")
                  else [(), (0.5,)]):
        got = getattr(tloss, name)(*map(T, args), *extra).numpy()
        want = np.asarray(getattr(jloss, name)(*map(J, args), *extra))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["plain", "target_weights", "all_masked",
                                  "ragged_padding"])
def test_masked_loss_matches_jax(case):
    rng, elem, mask = _loss_inputs(5)
    elem = np.abs(elem)
    weights = rng.uniform(0.5, 2.0, size=(7, 1)).astype(np.float32)
    tw = None
    if case == "target_weights":
        tw = rng.uniform(0.5, 2.0, size=(5,)).astype(np.float32)
    if case == "all_masked":
        mask[:] = 0.0
    if case == "ragged_padding":  # the last rows are batch padding
        mask[4:] = 0.0
        weights[4:] = 0.0
    T, J = torch.from_numpy, jnp.asarray
    got = tloss.masked_loss(T(elem), T(mask), None if tw is None else T(tw),
                            T(weights)).item()
    want = float(jloss.masked_loss(J(elem), J(mask),
                                   None if tw is None else J(tw), J(weights)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if case == "ragged_padding":
        # the denominator counts the real targets only
        real = float((elem * mask * weights)[:4].sum() / mask[:4].sum())
        np.testing.assert_allclose(got, real, rtol=RTOL)


def test_get_loss_fn_registry():
    assert tloss.get_loss_fn("regression") is tloss.mse
    assert tloss.get_loss_fn("classification") is tloss.bce_with_logits
    assert tloss.get_loss_fn("multiclass") is tloss.cross_entropy_multiclass
    assert tloss.get_loss_fn("spectra") is tloss.sid_loss
    assert tloss.get_loss_fn("spectra", "wasserstein") is tloss.wasserstein_loss
    with pytest.raises(ValueError):
        tloss.get_loss_fn("regression", "wasserstein")
    with pytest.raises(ValueError):
        tloss.get_loss_fn("ranking")


# -- schedules ---------------------------------------------------------------

STEPS = [0, 1, 2, 3, 5, 7, 8, 9, 10, 15, 16, 17, 24, 29, 30, 31, 39, 40, 41,
         60]


@pytest.mark.parametrize("scheduler", ["noam", "constant", "cosine",
                                       "cyclic", "exponential"])
def test_schedule_matches_optax(scheduler):
    kw = dict(init_lr=1e-4, max_lr=1e-3, final_lr=1e-4, warmup_epochs=2.0,
              epochs=5, steps_per_epoch=8)
    got_fn = tsched.build_schedule(scheduler, **kw)
    want_fn = jax.jit(jsched.build_schedule(scheduler, **kw))
    got = [got_fn(s) for s in STEPS]
    want = [float(want_fn(jnp.asarray(s, jnp.int32))) for s in STEPS]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)
    if scheduler == "noam":  # warmup ends at step 16, the horizon at 40
        at = dict(zip(STEPS, got))
        assert at[0] == pytest.approx(1e-4) and at[10] < at[16] > at[24]
        np.testing.assert_allclose(at[16], 1e-3, rtol=1e-6)
        assert at[41] == at[60] == pytest.approx(1e-4)


def test_unknown_scheduler_and_optimizer_raise():
    with pytest.raises(ValueError):
        tsched.build_schedule("step", init_lr=1, max_lr=1, final_lr=1,
                              warmup_epochs=1, epochs=1, steps_per_epoch=1)
    with pytest.raises(ValueError):
        tsched.build_optimizer("lamb", [torch.nn.Parameter(torch.zeros(1))])


# -- metrics -----------------------------------------------------------------

def _metric_inputs(metric):
    rng = np.random.default_rng(len(metric))
    n = 120
    if metric in ("auc", "prc-auc", "binary_cross_entropy"):
        t = rng.integers(0, 2, n).tolist()
        # rounded scores: ties between positives and negatives
        return t, np.round(rng.uniform(size=n), 2).tolist(), {}
    if metric == "accuracy":
        return (rng.integers(0, 2, n).tolist(),
                rng.uniform(size=n).tolist(), {})
    if metric == "cross_entropy":
        p = rng.dirichlet([1, 1, 1], n).astype(np.float32)
        p[0] = [1.0, 0.0, 0.0]  # clipped probabilities
        return (rng.integers(0, 3, n).tolist(), p.tolist(),
                {"labels": [0, 1, 2]})
    if metric in ("sid", "wasserstein"):
        p = rng.uniform(0.01, 1, size=(9, 6))
        t = rng.uniform(0.01, 1, size=(9, 6))
        t = (t / t.sum(1, keepdims=True)).tolist()
        t[2][3] = None
        return p.tolist(), t, {}
    y = rng.normal(size=n)
    return y.tolist(), (y + 0.3 * rng.normal(size=n)).tolist(), {}


@pytest.mark.parametrize("metric", sorted(tmetrics.METRICS))
def test_metric_matches_jax_package(metric):
    a, b, kw = _metric_inputs(metric)
    got = tmetrics.get_metric_fn(metric)(a, b, **kw)
    want = jmetrics.get_metric_fn(metric)(a, b, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert tmetrics.minimize_score(metric) == jmetrics.minimize_score(metric)


def test_metrics_cover_the_jax_registry():
    assert sorted(tmetrics.METRICS) == sorted(jmetrics.METRICS)
    # multiclass accuracy takes the argmax of probability rows
    preds = [np.array([0.1, 0.7, 0.2]), np.array([0.6, 0.3, 0.1])]
    assert tmetrics.accuracy([1, 2], preds) == jmetrics.accuracy([1, 2], preds)
    with pytest.raises(ValueError):
        tmetrics.get_metric_fn("f1")


@pytest.mark.parametrize("dataset_type", ["regression", "classification",
                                          "multiclass", "spectra"])
def test_evaluate_predictions_matches_jax_package(dataset_type):
    rng = np.random.default_rng(4)
    n, tasks = 40, 3
    if dataset_type == "regression":
        metrics = ["rmse", "mae", "mse", "r2"]
        preds = rng.normal(size=(n, tasks)).tolist()
        targets = rng.normal(size=(n, tasks)).tolist()
        targets[3][1] = None
    elif dataset_type == "classification":
        metrics = ["auc", "prc-auc", "accuracy", "binary_cross_entropy"]
        preds = rng.uniform(size=(n, tasks)).tolist()
        targets = rng.integers(0, 2, size=(n, tasks)).astype(float).tolist()
        for row in targets:   # task 2 has one class only -> nan
            row[2] = 1.0
        targets[5][0] = None
    elif dataset_type == "multiclass":
        metrics = ["cross_entropy", "accuracy"]
        preds = rng.dirichlet([1, 1, 1], size=(n, tasks)).tolist()
        targets = rng.integers(0, 3, size=(n, tasks)).astype(float).tolist()
    else:
        metrics = ["sid", "wasserstein"]
        preds = rng.uniform(0.01, 1, size=(n, tasks)).tolist()
        t = rng.uniform(0.01, 1, size=(n, tasks))
        targets = (t / t.sum(1, keepdims=True)).tolist()
    got = tmetrics.evaluate_predictions(preds, targets, tasks, metrics,
                                        dataset_type)
    want = jmetrics.evaluate_predictions(preds, targets, tasks, metrics,
                                         dataset_type)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12)
    empty = tmetrics.evaluate_predictions([], [], tasks, metrics,
                                          dataset_type)
    assert all(np.isnan(v).all() and len(v) == tasks for v in empty.values())
