"""The port's float sums run in a fixed order: one seed gives one model.

On CUDA, ``index_add_``, ``scatter_add_`` (the VJP of ``gather``) and an
accumulating ``index_put_`` add floats with atomics in no fixed order, so
two runs of the same seed differ. The port's message passing sums on row
3's CSR entries instead, whose plain versions these tests run:

* (a) the molecule readout over the molecule CSR
  (``ops/band_mpnn.py`` ``molecule_readout_sorted``, its plain version on
  CPU tensors) against the JAX package's ``ops/segment.py``
  ``molecule_readout``, for ``mean``, ``sum`` and ``norm``, on polymers
  with stoichiometric weights and Xn, a molecule with no atoms and tail
  padding atoms: forward at rtol 1e-6, the VJP against ``jax.vjp``;
* (b) the host molecule CSR (``ops/sorted_aux.py``
  ``build_molecule_csr``) of the C++ and the Python loader's batches,
  equal array for array;
* (c) one training step (forward and backward) of the default
  configuration, ``atom_messages`` and multiclass, and one SSL step,
  under a ``TorchDispatchMode``: outside the kernels' plain versions (the
  ``*_plain`` functions of ops/band_mpnn.py, which the card replaces by
  the kernels) no operator adds floats with ``index_add``,
  ``scatter_add``, a summing ``scatter_reduce`` or an accumulating
  ``index_put``.

Hidden 16-32, a few molecules: about 20 s.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from polymer_chemprop_tpu.ops import segment as jseg
from polymer_chemprop_tpu_torch.data import MoleculeDataLoader, get_data
from polymer_chemprop_tpu_torch.features import (FeaturizationConfig,
                                                 mol2graph)
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from test_torch_threads import torch_threads  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
POLYMERS = ["[*:1]CC[*:2].[*:3]CO[*:4]|0.5|0.5|<1-3:0.5:0.5<2-4:0.5:0.5~20",
            "[*:1]c1ccc([*:2])cc1.[*:3]C(C)C[*:4]|0.25|0.75|"
            "<1-3:0.25:0.75<2-4:0.75:0.25~100",
            "[*:1]CC[*:2].[*:3]c1ccc([*:4])cc1C|0.75|0.25|"
            "<1-3:0.5:0.5<2-4:0.5:0.5~7",
            "[*:1]CO[*:2].[*:3]C(C)C[*:4]|0.3|0.7|"
            "<1-3:0.5:0.5<2-4:0.5:0.5~2"]
H = 32


def _readout_batch():
    """A polymer batch with tail padding atoms and two molecules more than
    it has graphs, molecule 1 moved up so that it has no atoms."""
    gb = mol2graph(POLYMERS, FeaturizationConfig(polymer=True),
                   pad_atoms=160, pad_mols=len(POLYMERS) + 2)
    a2mol = np.where(gb.a2mol >= 1, gb.a2mol + 1, gb.a2mol)
    a2mol[0] = 0
    a2mol[gb.n_atoms_real:] = 0
    dop = np.ones(gb.n_mols, np.float32)
    dop[0] = gb.degree_of_polym[0]
    dop[2:len(POLYMERS) + 1] = gb.degree_of_polym[1:len(POLYMERS)]
    return gb.w_atoms, a2mol.astype(np.int32), dop, gb.n_atoms_real


@pytest.mark.parametrize("aggregation", ["mean", "sum", "norm"])
def test_molecule_readout_matches_jax(aggregation):
    from polymer_chemprop_tpu_torch.ops.sorted_aux import build_molecule_csr
    w, a2mol, dop, n_real = _readout_batch()
    M, A = dop.shape[0], w.shape[0]
    assert n_real < A and np.unique(w[1:n_real]).size > 2 \
        and (dop > 1).any()
    rng = np.random.default_rng(0)
    h = rng.normal(size=(A, H)).astype(np.float32)
    g = rng.normal(size=(M, H)).astype(np.float32)
    csr = build_molecule_csr(a2mol, w, M)
    assert np.diff(csr["mol_rowptr"])[1] == 0       # the empty molecule
    aux = {k: torch.from_numpy(v) for k, v in csr.items()}
    ht = torch.from_numpy(h).requires_grad_()
    got = bm.molecule_readout_sorted(
        ht, torch.from_numpy(w), torch.from_numpy(a2mol).long(), aux,
        torch.from_numpy(dop), aggregation, 50.0)
    (got * torch.from_numpy(g)).sum().backward()

    def ref(x):
        return jseg.molecule_readout(x, jnp.asarray(w), jnp.asarray(a2mol),
                                     M, jnp.asarray(dop), aggregation, 50.0)
    want, vjp = jax.vjp(ref, jnp.asarray(h))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-7)
    assert not got[1].any() and not ht.grad[n_real:].any()


@pytest.mark.parametrize("polymer", [False, True],
                         ids=["molecules", "polymers"])
def test_molecule_csr_is_the_same_from_both_featurizers(tmp_path, polymer):
    path = tmp_path / "data.csv"
    if polymer:
        rows = POLYMERS * 3
    else:
        with open(os.path.join(DATA, "regression.csv")) as f:
            rows = [r[0] for r in csv.reader(f)][1:24]
    with open(path, "w") as f:
        f.write("smiles,y\n" + "".join(f'"{s}",1.0\n' for s in rows))
    fcfg = FeaturizationConfig(polymer=polymer)
    data = get_data(str(path), config=fcfg)
    batches = {native: list(MoleculeDataLoader(
        data, fcfg, batch_size=10, num_workers=1, use_native=native))
        for native in (True, False)}
    for b_cpp, b_py in zip(batches[True], batches[False]):
        cpp = b_cpp.graph_arrays[0]
        py = b_py.graph_arrays[0]
        for k in ("mol_idx", "mol_rowptr", "mol_denom"):
            assert cpp["sorted_aux"][k].dtype == py["sorted_aux"][k].dtype
            np.testing.assert_array_equal(cpp["sorted_aux"][k],
                                          py["sorted_aux"][k], err_msg=k)
        aux, a2mol = py["sorted_aux"], py["a2mol"]
        n = int(aux["mol_rowptr"][-1])
        # every real atom once, in row order; molecule m's atoms in its run
        np.testing.assert_array_equal(aux["mol_idx"][:n],
                                      np.arange(1, n + 1))
        assert not aux["mol_idx"][n:].any() and not py["w_atoms"][n + 1:].any()
        counts = np.bincount(a2mol[1:n + 1], minlength=len(aux["mol_denom"]))
        np.testing.assert_array_equal(np.diff(aux["mol_rowptr"]), counts)
        np.testing.assert_allclose(
            aux["mol_denom"],
            np.bincount(a2mol, py["w_atoms"], len(aux["mol_denom"])),
            rtol=1e-6)
    assert len(batches[True]) == len(batches[False]) == -(-len(rows) // 10)


class _FloatAtomics(TorchDispatchMode):
    """Records the operators that add floats into their output in no fixed
    order on CUDA, outside the functions counted in ``plain`` (the kernels'
    plain versions)."""

    SUMMING = {"index_add", "index_add_", "scatter_add", "scatter_add_",
               "embedding_dense_backward"}
    REDUCING = {"scatter_reduce", "scatter_reduce_", "scatter", "scatter_"}
    ACCUMULATING = {"index_put", "index_put_", "_index_put_impl_", "put_",
                    "put"}

    def __init__(self):
        super().__init__()
        self.plain = 0
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        first = out[0] if isinstance(out, (tuple, list)) else out
        if self.plain or not (isinstance(first, torch.Tensor)
                              and first.is_floating_point()):
            return out
        if name in self.SUMMING:
            hit = True
        elif name in self.REDUCING:
            reduce = kwargs.get("reduce", args[4] if len(args) > 4 else None)
            hit = reduce in ("sum", "add", "mean")
        elif name in self.ACCUMULATING:
            pos = 2 if name.startswith("put") else 3
            hit = bool(kwargs.get("accumulate",
                                  args[pos] if len(args) > pos else False))
        else:
            hit = False
        if hit:
            self.found.append(str(func))
        return out


@pytest.fixture
def atomics(monkeypatch):
    """A :class:`_FloatAtomics` with every ``*_plain`` function of
    ops/band_mpnn.py counted as a plain version."""
    mode = _FloatAtomics()

    def counted(fn):
        def plain(*args, **kwargs):
            mode.plain += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.plain -= 1
        return plain

    for name in dir(bm):
        if name.endswith("_plain"):
            monkeypatch.setattr(bm, name, counted(getattr(bm, name)))
    return mode


def _csv(path, smiles, targets):
    with open(path, "w") as f:
        f.write("smiles,y\n" + "".join(f'"{s}",{t}\n'
                                       for s, t in zip(smiles, targets)))
    return str(path)


@pytest.mark.parametrize("case", ["default", "atom_messages", "multiclass",
                                  "ssl"])
def test_training_steps_add_no_float_atomics(tmp_path, atomics, case):
    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.ssl import SSLConfig, ssl_pretrain
    from polymer_chemprop_tpu_torch.train.cross_validate import (
        cross_validate)
    if case == "ssl":
        cfg = SSLConfig(data_path=_csv(tmp_path / "p.csv", POLYMERS,
                                       [0] * 4),
                        save_dir=str(tmp_path / "ssl"), hidden_size=16,
                        epochs_stage1=0, epochs_stage2=1, num_workers=1,
                        quiet=True, device="cpu")
        with atomics:
            ssl_pretrain(cfg)
    else:
        with open(os.path.join(DATA, "regression.csv")) as f:
            smiles = [r[0] for r in csv.reader(f)][1:13]
        kw = dict(dataset_type="regression")
        if case == "atom_messages":
            kw["atom_messages"] = True
        if case == "multiclass":
            kw = dict(dataset_type="multiclass", multiclass_num_classes=3)
        targets = [i % 3 for i in range(len(smiles))]
        cfg = TrainConfig(data_path=_csv(tmp_path / "d.csv", smiles,
                                         targets),
                          save_dir=str(tmp_path / "run"), hidden_size=16,
                          ffn_hidden_size=16, epochs=1, num_folds=1,
                          batch_size=10, num_workers=1, quiet=True,
                          device="cpu", **kw)
        with atomics:
            cross_validate(cfg)
    assert not atomics.found, sorted(set(atomics.found))


@pytest.mark.parametrize("weights", ["unit", "polymer"])
@pytest.mark.parametrize("aggregation", ["mean", "sum", "norm"])
def test_molecule_readout_equals_the_composition_bit_for_bit(aggregation,
                                                             weights):
    """The one-launch readout's Function (on CPU tensors its plain version
    and its own VJP) against autograd through the composition it replaces,
    ``molecule_sum`` then ``aggregate_molecules``: output and gradient
    equal bit for bit, with a molecule of no atoms and tail padding."""
    from polymer_chemprop_tpu_torch.ops.sorted_aux import build_molecule_csr
    w, a2mol, dop, _ = _readout_batch()
    if weights == "unit":
        w = (w != 0).astype(np.float32)
    M, A = dop.shape[0], w.shape[0]
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.normal(size=(A, H)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
    aux = {k: torch.from_numpy(v)
           for k, v in build_molecule_csr(a2mol, w, M).items()}
    wt, dopt = torch.from_numpy(w), torch.from_numpy(dop)
    mol = torch.from_numpy(a2mol).long()
    x, y = (h.clone().requires_grad_() for _ in range(2))
    got = bm.molecule_readout_sorted(x, wt, mol, aux, dopt, aggregation, 30.0)
    want = bm.aggregate_molecules(
        bm.molecule_sum(y, wt, mol, aux["mol_idx"], aux["mol_rowptr"]),
        aux["mol_denom"], dopt, aggregation, 30.0)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, x, g)[0],
                       torch.autograd.grad(want, y, g)[0])


def test_weights_through_an_index_equal_the_gathered_weights():
    """The plain version of the gather entry's weight index: the weights
    ``w[widx]`` read through it equal the gathered weights, bit for bit;
    the molecule readout's plain sum reads them through the CSR index."""
    rng = np.random.default_rng(2)
    A, B, K = 12, 40, 25
    counts = rng.multinomial(B - 5, np.ones(A) / A)
    rowptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                              .astype(np.int32))
    h = torch.from_numpy(rng.normal(size=(A, H)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, A, B).astype(np.int32))
    widx = torch.from_numpy(rng.integers(0, K, B).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, K).astype(np.float32))
    assert torch.equal(bm.src_readout_plain(h, w, idx, rowptr, widx),
                       bm.src_readout_plain(h, w[widx.long()], idx, rowptr))
    wa = w[:A].contiguous()
    assert torch.equal(
        bm.molecule_readout_plain(h, wa, idx[:A].contiguous(),
                                  rowptr[:4].contiguous(), None, None, None),
        bm.src_readout_plain(h, wa[idx[:A].long()], idx[:A].contiguous(),
                             rowptr[:4].contiguous()))


def test_graph_parallel_fallback_trains_on_the_sorted_layout(atomics):
    """A batch of the graph-parallel trainer's natural-order loader as its
    single-device fallback hands it to the step (``DeviceBatch.
    sorted_layout``): the layout a sorted loader builds, and one step on
    it adds no float atomics and equals the step on the natural-order
    batch (``index_add_`` segment sums) within 1e-6."""
    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.models.init import reference_init_model
    from polymer_chemprop_tpu_torch.models.model import build_model_config
    from polymer_chemprop_tpu_torch.train.scheduler import (
        build_optimizer, build_schedule)
    from polymer_chemprop_tpu_torch.train.step import (TrainStep,
                                                       batch_tensors,
                                                       make_loss_fn)
    path = os.path.join(DATA, "regression.csv")
    cfg = TrainConfig(data_path=path, dataset_type="regression",
                      hidden_size=16, ffn_hidden_size=16, device="cpu")
    fcfg = cfg.featurization()
    data = get_data(path, config=fcfg, max_data_size=20)
    data.normalize_targets()
    natural, sorted_ = (next(iter(MoleculeDataLoader(
        data, fcfg, batch_size=10, shuffle=True, seed=0, num_workers=1,
        sorted_aux=s))) for s in (False, True))
    assert "sorted_aux" not in natural.graph_arrays[0]
    converted = natural.sorted_layout()
    for got, want in zip(converted.graph_arrays, sorted_.graph_arrays):
        assert got.keys() == want.keys()
        for k in want:
            if k == "sorted_aux":
                for a in want[k]:
                    np.testing.assert_array_equal(got[k][a], want[k][a])
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mcfg = build_model_config(cfg, data.num_tasks, data=data)

    def step(batch):
        model = reference_init_model(mcfg, 0)
        train_step = TrainStep(
            model, build_optimizer("adam", model.parameters()),
            build_schedule("noam", init_lr=1e-4, max_lr=1e-3,
                           final_lr=1e-4, warmup_epochs=2.0, epochs=30,
                           steps_per_epoch=2),
            make_loss_fn(mcfg))
        loss, _ = train_step(batch_tensors(batch, "cpu"))
        return loss, [p.detach() for p in model.parameters()]

    want_loss, want = step(natural)
    with atomics:
        got_loss, got = step(converted)
    assert not atomics.found, sorted(set(atomics.found))
    np.testing.assert_allclose(got_loss.item(), want_loss.item(), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
