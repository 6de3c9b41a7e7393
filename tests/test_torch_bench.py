"""The port's benchmark and batch-scaling probe against the JAX side's.

* The batch: the port's bench batch (``bench.load_batch``) has the real
  edge, atom and molecule counts of the JAX package's ``mol2graph`` on the
  same SMILES, and ``polymer_smiles`` is the root bench.py's
  ``_polymer_smiles``.
* The step: the bench's ``train_setup`` from the JAX ``init_model``
  parameters (``load_jax_params``), two steps against JAX
  ``make_train_step`` with the same targets, Noam schedule and Adam, on
  the default and the copolymer batch: losses, gradient norms and the
  updated parameters within tests/test_torch_train_step.py's rtol 1e-4,
  atol 1e-6, at ``band_precision="highest"`` in both (JAX on the CPU
  computes FP32 whatever its setting).
* The yardstick: loaded with the port model's weights, its first loss
  equals the port step's within 1e-5 relative (the same function, summed
  in another order), so ``vs_baseline`` compares like with like.
* The entry points on the CPU at 16 molecules, hidden 32: the bench's
  last line is JSON with the JAX bench's keys and names the CPU; with
  ``--device cuda`` and no card they raise; the launch check raises on a
  CUDA device where the form's kernels did not launch; the scaling probe
  prints every part at both sizes, then the growth lines.

The kernels themselves are held against their plain versions on the card
by tests/test_torch_kernels_gpu.py and chip_smoke.py (phase 15 runs these
entry points there). The root bench.py is imported, not edited.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.features import FeaturizationConfig as JaxFcfg
from polymer_chemprop_tpu.features import mol2graph as jax_mol2graph
from polymer_chemprop_tpu.models import EncoderConfig as JaxEncoderConfig
from polymer_chemprop_tpu.models import ModelConfig as JaxModelConfig
from polymer_chemprop_tpu.models import init_model
from polymer_chemprop_tpu.train.scheduler import build_optimizer as jax_optimizer
from polymer_chemprop_tpu.train.scheduler import build_schedule as jax_schedule
from polymer_chemprop_tpu.train.step import make_train_step
from polymer_chemprop_tpu_torch import bench
from polymer_chemprop_tpu_torch.models import convert
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from polymer_chemprop_tpu_torch.probes import batch_scaling_probe
from polymer_chemprop_tpu_torch.probes.bench_batch import bench_smiles

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jax_bench  # noqa: E402
from test_torch_threads import torch_threads  # noqa: E402,F401
from test_torch_train_step import _assert_tree_close  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, H, DEPTH = 16, 32, 3
RTOL = 1e-4
KEYS = {"metric", "value", "unit", "vs_baseline", "step_ms", "real_edges",
        "padded_edges"}
SMALL = ["--device", "cpu", "--molecules", str(N), "--hidden", str(H),
         "--trials", "2"]


@pytest.fixture(scope="module", params=["default", "polymer"])
def batches(request):
    """``(polymer, port GraphBatch, JAX GraphBatch)`` of the same SMILES."""
    polymer = request.param == "polymer"
    smiles = jax_bench._polymer_smiles(N) if polymer else bench_smiles(N)
    return (polymer, bench.load_batch(N, polymer),
            jax_mol2graph(smiles, JaxFcfg(polymer=polymer)))


def test_batch_counts_match_jax_mol2graph(batches):
    polymer, gb, jgb = batches
    assert bench.polymer_smiles(40) == jax_bench._polymer_smiles(40)
    edges = bench._edges(gb)
    assert edges["real_edges"] == jgb.n_bonds_real - 1 > 0
    assert gb.n_atoms_real == jgb.n_atoms_real
    assert gb.n_mols == jgb.n_mols == N
    assert edges["padded_edges"] == gb.f_bonds.shape[0]
    # non-unit bond weights only in the copolymer batch
    assert polymer == bool((gb.w_bonds[1:gb.n_bonds_real] != 1).any())


def test_two_steps_match_make_train_step(batches):
    polymer, gb, jgb = batches
    step, batch = bench.train_setup(gb, "cpu", hidden=H, depth=DEPTH,
                                    precision="highest")
    enc = step.model.cfg.encoder
    jcfg = JaxModelConfig(
        encoder=JaxEncoderConfig(atom_fdim=enc.atom_fdim,
                                 bond_fdim=enc.bond_fdim, hidden_size=H,
                                 depth=DEPTH, band_precision="highest"),
        dataset_type="regression", num_tasks=1, ffn_hidden_size=H)
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(0), jcfg))
    convert.load_jax_params(step.model, params)
    tx = jax_optimizer("adam", jax_schedule("noam", **bench.SCHEDULE))
    jstep = make_train_step(jcfg, tx)
    opt_state = tx.init(params)
    ones = jnp.ones((N, 1), jnp.float32)
    jbatch = {"graphs": [jax.tree_util.tree_map(jnp.asarray, jgb.arrays())],
              "targets": jnp.asarray(bench.targets(N)), "mask": ones,
              "weights": ones}
    for _ in range(2):
        params, opt_state, want_loss, want_gnorm = jstep(
            params, opt_state, jbatch, None)
        loss, gnorm = step(batch)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
        np.testing.assert_allclose(gnorm.item(), float(want_gnorm),
                                   rtol=RTOL)
    _assert_tree_close(convert.params_to_jax(step.model), params)


def test_yardstick_first_loss_equals_port_step():
    gb = bench.load_batch(N)
    step, batch = bench.train_setup(gb, "cpu", hidden=H, depth=DEPTH,
                                    precision="highest")
    first = bench.yardstick(step.model, gb, "cpu")().item()
    loss, _ = step(batch)
    np.testing.assert_allclose(first, loss.item(), rtol=1e-5)
    # the yardstick trains copies: the port model took one step alone
    step2, batch2 = bench.train_setup(gb, "cpu", hidden=H, depth=DEPTH,
                                      precision="highest")
    ystep = bench.yardstick(step2.model, gb, "cpu")
    ystep()
    assert ystep().item() != first
    assert step2(batch2)[0].item() == first


@pytest.mark.parametrize("flag", [None, "--predict"])
def test_cli_prints_the_line(flag, capsys):
    lines = bench.main(SMALL + ([flag] if flag else []))
    out = capsys.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    assert last == json.loads(json.dumps(lines[-1]))
    assert KEYS <= set(last)
    assert "cpu" in last["metric"] and "hidden 32" in last["metric"]
    assert last["real_edges"] == bench._edges(bench.load_batch(N))[
        "real_edges"]
    assert any(l.startswith("[spread]") for l in out)
    if flag == "--predict":
        assert last["unit"] == "mol/s" and last["vs_baseline"] is None
    else:
        assert last["unit"] == "edges/s" and last["vs_baseline"] > 0
        assert "form rev, band_precision high" in last["metric"]
        assert any(l.startswith("[bench] kernels per step") for l in out)
        assert np.isfinite(last["first_loss"])


def test_cli_refuses_a_batch_of_another_size():
    with pytest.raises(ValueError, match="8 molecules"):
        bench.main(SMALL, batch=bench.load_batch(8))


@pytest.mark.parametrize("entry", ["bench", "probe"])
def test_cuda_without_a_card_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    main = bench.main if entry == "bench" else batch_scaling_probe.main
    argv = ["--device", "cuda"] + (["--molecules", "16"]
                                   if entry == "bench" else ["16"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(argv)


def test_launch_check_raises_where_the_kernels_did_not_launch():
    before = bench._counts()
    with pytest.raises(RuntimeError, match="did not launch"):
        bench.check_launches("step", before, 1, bench.FORM_KERNELS["rev"],
                             torch.device("cuda"))
    # on the CPU the plain versions run, and nothing is required
    assert bench.check_launches("step", before, 1,
                                bench.FORM_KERNELS["rev"],
                                torch.device("cpu")) == {}
    assert set(bench.FORM_KERNELS["plain"]) <= set(bm.launch_counts())


def test_scaling_probe_prints_every_part_then_the_growth(capsys):
    rows = batch_scaling_probe.main(
        ["--device", "cpu", "--hidden", str(H), "--trials", "1", "--reps",
         "2", "--warm", "2", "16", "32"])
    assert set(rows) == {16, 32}
    for row in rows.values():
        assert set(batch_scaling_probe.PARTS) <= set(row)
        assert all(v > 0 for p in batch_scaling_probe.PARTS
                   for v in row[p].values())
    out = capsys.readouterr().out.splitlines()
    scaling = [l for l in out if l.startswith("[scaling]")]
    growth = [l for l in out if l.startswith("[growth]")]
    assert len(scaling) == 2 * len(batch_scaling_probe.PARTS)
    assert [l.split()[1] for l in growth] == list(batch_scaling_probe.PARTS)
    assert out.index(growth[0]) > out.index(scaling[-1])
    assert all("host clock" in l for l in scaling)
