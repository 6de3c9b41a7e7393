"""The port's message-passing ops vs the JAX package's.

* the port's featurization and dst-sorted layout against the JAX
  package's arrays and ``build_sorted_aux``;
* the plain versions of the two kernels (``band_rev_layer``,
  ``atom_readout``) against JAX ``band_rev_layer_step_sorted`` and
  ``atom_readout_sorted``, whose Pallas kernels run in interpret mode at
  ``Precision.HIGHEST`` (as tests/test_pallas.py runs them on the CPU);
* the port's plain segment ops against JAX ``ops/segment.py``.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py.

Inputs are made with numpy from a seed and fed to both. Tolerance: rtol
1e-5, atol 1e-6 (FP32 on both sides, sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.features import FeaturizationConfig as JaxFcfg
from polymer_chemprop_tpu.features import mol2graph as jax_mol2graph
from polymer_chemprop_tpu.ops import segment as jseg
from polymer_chemprop_tpu.ops.pallas_mpnn import (
    atom_readout_sorted,
    band_rev_layer_step_sorted,
)
from polymer_chemprop_tpu.ops.pallas_mpnn import (
    build_sorted_aux as jax_build_sorted_aux,
)
from polymer_chemprop_tpu_torch.features import FeaturizationConfig
from polymer_chemprop_tpu_torch.features import mol2graph
from polymer_chemprop_tpu_torch.ops import band_mpnn, segment
from polymer_chemprop_tpu_torch.ops.sorted_aux import build_sorted_aux
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
# high-degree atoms: runs of up to 6 incoming bonds (S in SF6)
HUBS = ["FS(F)(F)(F)(F)F", "CC(C)(C)C", "OP(=O)(O)O"] * 4


@pytest.fixture(scope="module")
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _graphs(kind, pad_atoms=256, pad_bonds=512):
    """(port GraphBatch, JAX GraphBatch) of the same molecules."""
    if kind == "polymer":
        smi, fc, jfc = POLYMERS, FeaturizationConfig(polymer=True), \
            JaxFcfg(polymer=True)
    else:
        smi = HUBS if kind == "hubs" else SMILES
        fc, jfc = FeaturizationConfig(), JaxFcfg()
    kw = dict(pad_atoms=pad_atoms, pad_bonds=pad_bonds, pad_mols=len(smi))
    return mol2graph(smi, fc, **kw), jax_mol2graph(smi, jfc, **kw)


def _aux_t(aux):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in aux._asdict().items()}


def _layer_inputs(B, n_real, seed):
    """m, inp zero on padding rows (as the encoder keeps them)."""
    rng = np.random.default_rng(seed)
    real = np.zeros((B, 1), np.float32)
    real[:n_real] = 1.0
    m = (rng.normal(size=(B, H)) * real).astype(np.float32)
    inp = (rng.normal(size=(B, H)) * real).astype(np.float32)
    wh = (rng.normal(size=(H, H)) * 0.2).astype(np.float32)
    return m, inp, wh


@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_featurization_matches_jax(kind):
    gb, jgb = _graphs(kind)
    for k, v in jgb.arrays().items():
        np.testing.assert_array_equal(gb.arrays()[k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_sorted_aux_matches_jax_and_keeps_invariants(kind):
    gb, _ = _graphs(kind)
    A, B = gb.f_atoms.shape[0], gb.f_bonds.shape[0]
    aux = build_sorted_aux(gb.b2dst, gb.b2revb, gb.w_bonds, num_atoms=A)
    ref = jax_build_sorted_aux(gb.b2dst, gb.b2revb, gb.w_bonds, num_atoms=A)
    for k in ("perm", "srev", "src_sorted", "dst_sorted", "w_sorted"):
        np.testing.assert_array_equal(getattr(aux, k), getattr(ref, k),
                                      err_msg=k)
    # srev is an involution; padding bonds are their own reverse, sort
    # last, and carry zero weight
    np.testing.assert_array_equal(aux.srev[aux.srev], np.arange(B))
    n_real = gb.n_bonds_real - 1
    pad = np.arange(n_real, B)
    np.testing.assert_array_equal(aux.srev[pad], pad)
    assert (aux.dst_sorted[pad] == 0).all() and (aux.w_sorted[pad] == 0).all()
    assert (aux.src_sorted[pad] == 0).all()
    # CSR: atom v's incoming bonds are exactly [rowptr[v], rowptr[v+1])
    assert aux.rowptr.shape == (A + 1,) and aux.rowptr[0] == aux.rowptr[1] == 0
    assert aux.rowptr[-1] == n_real
    for v in range(1, A):
        run = aux.dst_sorted[aux.rowptr[v]:aux.rowptr[v + 1]]
        assert (run == v).all()
        assert len(run) == int((gb.b2dst == v).sum())
    np.testing.assert_array_equal(gb.arrays(sorted_aux=True)["f_bonds"],
                                  gb.f_bonds[aux.perm])


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("kind", ["molecules", "polymer"])
def test_band_rev_layer_plain_matches_jax_kernel(interpret_mode, kind, act):
    gb, _ = _graphs(kind)
    A, B = gb.f_atoms.shape[0], gb.f_bonds.shape[0]
    w = gb.w_bonds  # unit weights for molecules
    if kind == "polymer":
        # untidy (non-bf16-exact) weights on top of the polymer weights
        rng = np.random.default_rng(1)
        w = np.where(w > 0, w * rng.uniform(0.3, 1.0, w.shape), 0.0
                     ).astype(np.float32)
    aux = build_sorted_aux(gb.b2dst, gb.b2revb, w, num_atoms=A)
    jaux = jax_build_sorted_aux(gb.b2dst, gb.b2revb, w, num_atoms=A)
    assert jaux.rs_rev is not None
    m, inp, wh = _layer_inputs(B, gb.n_bonds_real - 1, seed=len(act))
    pad = lambda x: jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - H)))
    jd = {k: jnp.asarray(v) for k, v in jaux._asdict().items()
          if v is not None}
    want = band_rev_layer_step_sorted(pad(m), jnp.asarray(wh), pad(inp), jd,
                                      act, jax.lax.Precision.HIGHEST)
    want = np.asarray(want)
    assert (want[:, H:] == 0).all()
    t = _aux_t(aux)
    before = band_mpnn.band_rev_layer.launches
    got = band_mpnn.band_rev_layer(
        torch.from_numpy(m), torch.from_numpy(inp), torch.from_numpy(wh),
        t["w_sorted"], t["src_sorted"], t["srev"], t["rowptr"], act).numpy()
    assert band_mpnn.band_rev_layer.launches == before  # CPU: plain version
    np.testing.assert_allclose(got, want[:, :H], rtol=RTOL, atol=ATOL)
    # padding rows stay exactly zero
    assert (got[gb.n_bonds_real - 1:] == 0).all()


@pytest.mark.parametrize("kind", ["molecules", "polymer", "hubs"])
def test_atom_readout_plain_matches_jax_kernel(interpret_mode, kind):
    # the JAX readout kernel needs >= EXT_A (1024) bonds and a TILE_A (256)
    # multiple of atoms; below that it takes its segment-sum fallback
    gb, _ = _graphs(kind, pad_atoms=256, pad_bonds=1024)
    A, B = gb.f_atoms.shape[0], gb.f_bonds.shape[0]
    aux = build_sorted_aux(gb.b2dst, gb.b2revb, gb.w_bonds, num_atoms=A)
    jaux = jax_build_sorted_aux(gb.b2dst, gb.b2revb, gb.w_bonds, num_atoms=A)
    assert jaux.ra is not None
    m, _, _ = _layer_inputs(B, gb.n_bonds_real - 1, seed=5)
    jd = {k: jnp.asarray(v) for k, v in jaux._asdict().items()
          if v is not None}
    mp = jnp.pad(jnp.asarray(m), ((0, 0), (0, 128 - H)))
    want = np.asarray(atom_readout_sorted(mp, jd, A, H,
                                          jax.lax.Precision.HIGHEST))
    t = _aux_t(aux)
    got = band_mpnn.atom_readout(torch.from_numpy(m), t["w_sorted"],
                                 t["rowptr"]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("aggregation", ["mean", "sum", "norm"])
def test_segment_ops_match_jax(aggregation):
    gb, _ = _graphs("polymer")
    A, B = gb.f_atoms.shape[0], gb.f_bonds.shape[0]
    rng = np.random.default_rng(2)
    m = rng.normal(size=(B, H)).astype(np.float32)
    h = rng.normal(size=(A, H)).astype(np.float32)
    T = torch.from_numpy
    J = jnp.asarray
    np.testing.assert_allclose(
        segment.bond_message_step(T(m), T(gb.w_bonds), T(gb.b2a),
                                  T(gb.b2dst), T(gb.b2revb), A).numpy(),
        np.asarray(jseg.bond_message_step(J(m), J(gb.w_bonds), J(gb.b2a),
                                          J(gb.b2dst), J(gb.b2revb), A)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        segment.atom_readout(T(m), T(gb.w_bonds), T(gb.b2dst), A).numpy(),
        np.asarray(jseg.atom_readout(J(m), J(gb.w_bonds), J(gb.b2dst), A)),
        rtol=RTOL, atol=ATOL)
    M = gb.degree_of_polym.shape[0]
    np.testing.assert_allclose(
        segment.molecule_readout(T(h), T(gb.w_atoms), T(gb.a2mol), M,
                                 T(gb.degree_of_polym), aggregation).numpy(),
        np.asarray(jseg.molecule_readout(J(h), J(gb.w_atoms), J(gb.a2mol),
                                         M, J(gb.degree_of_polym),
                                         aggregation)),
        rtol=RTOL, atol=ATOL)
    # the kernels' plain versions agree with the natural-order oracle
    aux = build_sorted_aux(gb.b2dst, gb.b2revb, gb.w_bonds, num_atoms=A)
    t = _aux_t(aux)
    np.testing.assert_allclose(
        band_mpnn.atom_readout_plain(T(m[aux.perm]), t["w_sorted"],
                                     t["rowptr"]).numpy(),
        segment.atom_readout(T(m), T(gb.w_bonds), T(gb.b2dst), A).numpy(),
        rtol=RTOL, atol=ATOL)
