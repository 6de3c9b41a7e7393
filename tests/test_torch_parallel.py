"""The port's parallel/ against the JAX package's, on the CPU.

The JAX functions run in this process on the 8 virtual CPU devices of
tests/conftest.py, on meshes as large as the port's rank count. The port
runs one launch a rank count (2 and 4 processes with torchrun's
environment on a free port, gloo), started in the background by a module
fixture while the JAX side computes; its
ranks read the same JAX parameters (``models/convert.py``, dropout 0) and
the same featurized batches, and write their results for the tests to
read. Hidden 16, depth 2-3. Tolerances as the JAX package's own tests
(tests/test_parallel.py): rtol 1e-4, atol 1e-5 against the JAX functions;
overlapped against unoverlapped 1e-6 (forward) and 1e-5 / 1e-6 (step);
multihost bit for bit.
"""

import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from polymer_chemprop_tpu import parallel as jpar
from polymer_chemprop_tpu.features import mol2graph
from polymer_chemprop_tpu.models import EncoderConfig as JaxEncoderConfig
from polymer_chemprop_tpu.models import ModelConfig as JaxModelConfig
from polymer_chemprop_tpu.models import init_model
from polymer_chemprop_tpu.train.scheduler import build_optimizer as jax_opt
from polymer_chemprop_tpu_torch import parallel as tpar
from test_torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
SMILES8 = ["CCO", "c1ccccc1", "CC(C)=CCCC(C)=CC(=O)",
           "CCOc1ccc2nc(S(N)(=O)=O)sc2c1", "CCN", "c1ccncc1",
           "CC(=O)Nc1ccc(O)cc1", "C1CCCCC1"]
TARGETS8 = [1.0, -1.0, 0.5, 0.3, -0.2, 2.0, 0.1, 0.7]
SMILES_A = ["CCO", "c1ccccc1", "CC(C)=CCCC(C)=CC(=O)", "CCN"]
SMILES_B = ["CC(=O)Nc1ccc(O)cc1", "C1CCCCC1", "c1ccncc1", "CCOC(C)=O"]
PAD_2D = dict(pad_atoms=96, pad_bonds=192, pad_mols=4)
# the JAX configurations; the port gets the same fields (dropout 0 unless
# named) and band_precision "highest" (FP32, as JAX on the CPU)
CONFIGS = {
    "bonds": dict(atom_fdim=133, bond_fdim=147, hidden_size=16, depth=2),
    "atom_messages": dict(atom_fdim=133, bond_fdim=14, hidden_size=16,
                          depth=3, atom_messages=True),
    "undirected": dict(atom_fdim=133, bond_fdim=147, hidden_size=16,
                       depth=3, undirected=True),
    "dropout": dict(atom_fdim=133, bond_fdim=14, hidden_size=16, depth=3,
                    dropout=0.35, atom_messages=True),
}

WORKER = r'''
import copy, hashlib, os, pickle, sys
import numpy as np, torch
sys.path.insert(0, REPO)
from polymer_chemprop_tpu_torch import parallel as tpar
from polymer_chemprop_tpu_torch.parallel.mesh import world
from polymer_chemprop_tpu_torch.models.convert import (load_jax_params,
                                                      params_to_jax)
from polymer_chemprop_tpu_torch.models.encoder import EncoderConfig
from polymer_chemprop_tpu_torch.models.model import ModelConfig, MoleculeModel
from polymer_chemprop_tpu_torch.ops.sorted_aux import sorted_batch
from polymer_chemprop_tpu_torch.train.scheduler import (build_optimizer,
                                                       constant_schedule)

tpar.initialize_multihost(device="cpu")
rank, size = world()
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}


def model_of(name):
    enc = EncoderConfig(band_precision="highest", **inp["configs"][name])
    model = MoleculeModel(ModelConfig(encoder=enc, dataset_type="regression",
                                      num_tasks=1, ffn_hidden_size=16))
    return load_jax_params(model, inp["params"][name])


def sgd(model):
    return build_optimizer("sgd", model.parameters()), constant_schedule(0.1)


def grads(model):
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad.detach().clone()
    return params_to_jax(g)


def with_aux(arrays):
    return sorted_batch(arrays)


def sha(model):
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def batch(arrays, targets, aux=True):
    t = np.asarray(targets, np.float32).reshape(-1, 1)
    return {"graphs": [with_aux(arrays) if aux else arrays], "targets": t,
            "mask": np.ones_like(t), "weights": np.ones_like(t)}


if size == 2:
    # data parallel at dp 2
    model = model_of("bonds")
    mesh = tpar.make_mesh(2, ("dp",))
    step = tpar.make_dp_train_step(model, *sgd(model), mesh)
    stacked = tpar.stack_device_batches(
        [batch(a, t) for a, t in zip(inp["dp_arrays"], inp["dp_targets"])])
    loss, gnorm = step(tpar.shard_batch(stacked, mesh, "dp", "cpu"))
    out["dp"] = (float(loss), float(gnorm), grads(model),
                 params_to_jax(model))
    # the same step twice more from the seed: each run's SHA-256
    out["dp_repeat"] = []
    for _ in range(2):
        model = model_of("bonds")
        tpar.make_dp_train_step(model, *sgd(model), mesh)(
            tpar.shard_batch(stacked, mesh, "dp", "cpu"))
        out["dp_repeat"].append(sha(model))

    # the four edge-parallel forwards at ep 2
    model = model_of("bonds")
    enc, cfg = model.encoders[0], model.cfg.encoder
    mesh = tpar.make_mesh(2, ("ep",))
    arrays = inp["fwd_arrays"]
    sh, rep = tpar.build_edge_shards(arrays, 2)
    fw = {"psum": tpar.make_edge_parallel_forward(cfg, mesh)(enc, sh, rep)}
    sh, rep = tpar.build_edge_shards_halo(arrays, 2)
    fw["halo"] = tpar.make_edge_parallel_forward_halo(cfg, mesh)(enc, sh,
                                                                 rep)
    shb, repb = tpar.build_edge_shards_halo_band(arrays, 2)
    fw["band"] = tpar.make_edge_parallel_forward_halo_band(cfg, mesh)(
        enc, shb, repb)
    sw = tpar.halo_strip_width(sh)
    fw["overlap"] = tpar.make_edge_parallel_forward_halo_overlap(
        cfg, mesh, sw)(enc, sh, rep)
    out["forwards"] = {k: v.detach().numpy() for k, v in fw.items()}

    # the 1-D halo train step at ep 2
    model = model_of("bonds")
    step = tpar.make_halo_train_step(model, *sgd(model), mesh)
    b = batch(arrays, inp["targets8"], aux=False)
    sh, rep = tpar.build_edge_shards_halo(arrays, 2)
    loss, gnorm = step(sh, rep, b["targets"], b["mask"], b["weights"])
    out["halo_step"] = (float(loss), params_to_jax(model))

    # gspmd over 2 ranks
    model = model_of("bonds")
    step = tpar.make_gspmd_train_step(model, *sgd(model),
                                      tpar.make_mesh(2, ("gp",)))
    loss, _ = step(batch(inp["gspmd_arrays"], inp["targets8"], aux=False))
    out["gspmd"] = (float(loss), params_to_jax(model))

    # window dropout keyed by global atom row: ep 1 (rank 0) against ep 2
    am = inp["dropout_arrays"]
    t = np.asarray(inp["dropout_targets"], np.float32)[None]
    for n_ep in (1, 2):
        mesh = tpar.make_mesh(n_ep, ("dp", "ep"), shape=(1, n_ep))
        if mesh.coords is None:
            continue
        sh, rep = tpar.build_edge_shards_halo_dp([am], n_ep, atom_window=96)
        for drop in (True, False):
            model = model_of("dropout")
            step = tpar.make_halo_dp_train_step(model, *sgd(model), mesh,
                                                dropout_rngs=drop)
            loss, _ = step(sh, rep, t, np.ones_like(t), np.ones_like(t),
                           seeds=np.full((1, n_ep), 7), ffn_seed=9)
            out[f"dropout_ep{n_ep}_{drop}"] = float(loss)

    # multihost: this process's slab of the global batch, 2 Adam steps
    mesh = tpar.make_hybrid_mesh({"dp": size}, {})
    local = tpar.process_batch_indices(inp["mh_order"], 8)[0]
    model = model_of("bonds")
    step = tpar.make_dp_train_step(
        model, build_optimizer("adam", model.parameters()),
        constant_schedule(1e-3), mesh)
    mb = [batch(inp["mh_arrays"][rank], [float(i) for i in local])]
    losses = []
    for _ in range(2):
        loss, _ = step(tpar.global_batch_from_local(
            tpar.stack_device_batches(mb), mesh, "dp", "cpu"))
        losses.append(float(loss))
    out["multihost"] = (losses, params_to_jax(model))

if size == 4:
    # the 2-D (dp 2 x ep 2) halo step, three configurations, both forms
    sh, rep = tpar.build_edge_shards_halo_dp(inp["dp_arrays"], 2,
                                             atom_window=96)
    t = np.asarray(inp["dp_targets"], np.float32)[..., None]
    mesh = tpar.make_mesh(4, ("dp", "ep"), shape=(2, 2))
    for name in ("bonds", "atom_messages", "undirected"):
        for overlap in (False, True):
            model = model_of(name)
            step = tpar.make_halo_dp_train_step(model, *sgd(model), mesh,
                                                overlap=overlap)
            loss, _ = step(sh, rep, t, np.ones_like(t), np.ones_like(t))
            out[f"2d_{name}_{overlap}"] = (float(loss),
                                           params_to_jax(model))
    # the bonds step twice more from the seed: each run's SHA-256
    out["2d_repeat"] = []
    for _ in range(2):
        model = model_of("bonds")
        tpar.make_halo_dp_train_step(model, *sgd(model), mesh)(
            sh, rep, t, np.ones_like(t), np.ones_like(t))
        out["2d_repeat"].append(sha(model))

with open(os.path.join(sys.argv[2], f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
'''


def _jax_cfg(name):
    enc = JaxEncoderConfig(**CONFIGS[name])
    return JaxModelConfig(encoder=enc, dataset_type="regression",
                          num_tasks=1, ffn_hidden_size=16)


class _Launch:
    """``n`` worker processes with torchrun's environment on a free port
    (one launch; no elastic agent to wait for); :meth:`result` waits."""

    def __init__(self, n, inp_path, out_dir, script):
        os.makedirs(out_dir, exist_ok=True)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        self.out_dir, self.n = out_dir, n
        self.logs = [open(os.path.join(out_dir, f"log{r}.txt"), "w")
                     for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, script, inp_path, out_dir], cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                     MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE=str(n)),
            stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        self._results = None

    def result(self):
        if self._results is None:
            rcs = [p.wait(timeout=240) for p in self.procs]
            for f in self.logs:
                f.close()
            logs = "".join(open(f.name).read()[-2000:] for f in self.logs)
            assert rcs == [0] * self.n, logs
            self._results = [pickle.load(open(os.path.join(
                self.out_dir, f"rank{r}.pkl"), "rb")) for r in range(self.n)]
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    params = {name: jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(0), _jax_cfg(name)))
        for name in CONFIGS}
    mh_smiles = ["CCO", "c1ccccc1", "CCN", "CC(=O)O", "c1ccncc1",
                 "C1CCCCC1", "CC(C)O", "CCOCC"]
    import random
    order = list(range(8))
    random.Random(0).shuffle(order)
    inp = {
        "configs": CONFIGS, "params": params,
        "dp_arrays": [mol2graph(SMILES_A, **PAD_2D).arrays(),
                      mol2graph(SMILES_B, **PAD_2D).arrays()],
        "dp_targets": [TARGETS8[:4], TARGETS8[4:]],
        "fwd_arrays": mol2graph(SMILES8, pad_atoms=128, pad_bonds=256,
                                pad_mols=8).arrays(),
        "gspmd_arrays": mol2graph(SMILES8, pad_atoms=64, pad_bonds=128,
                                  pad_mols=8).arrays(),
        "targets8": TARGETS8,
        "dropout_arrays": mol2graph(
            ["CC(=O)Nc1ccc(O)cc1", "CC(C)=CCCC(C)=CC(=O)", "c1ccc2ccccc2c1",
             "CCOC(C)=O", "CCN", "CCCCCC"], pad_atoms=96, pad_bonds=192,
            pad_mols=6).arrays(),
        "dropout_targets": [[0.3], [1.0], [-0.5], [0.2], [0.8], [-1.0]],
        "mh_order": order,
        "mh_arrays": [mol2graph([mh_smiles[i] for i in order[4 * p:4 * p + 4]],
                                pad_atoms=32, pad_bonds=64,
                                pad_mols=4).arrays() for p in range(2)],
    }
    inp_path = str(tmp / "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    script = str(tmp / "worker.py")
    with open(script, "w") as f:
        f.write(f"REPO = {REPO!r}\n" + WORKER)
    launches = {n: _Launch(n, inp_path, str(tmp / f"ranks{n}"), script)
                for n in (2, 4)}
    yield inp, launches
    for launch in launches.values():
        launch.kill()


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=what)


def _mesh(n, names=("ep",), shape=None):
    return jpar.make_mesh(n, names, shape=shape)


def _put(tree, mesh, spec):
    sharding = NamedSharding(mesh, P(*spec))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def _batch(arrays, targets):
    t = np.asarray(targets, np.float32).reshape(-1, 1)
    return {"graphs": [arrays], "targets": t, "mask": np.ones_like(t),
            "weights": np.ones_like(t)}


def _ranks_agree(results, key):
    for r in results[1:]:
        _close(r[key], results[0][key], rtol=0, atol=0,
               what=f"{key}: ranks differ")


def test_edge_parallel_forwards_match_jax(run):
    from jax.experimental.pallas import tpu as pltpu
    inp, launches = run
    cfg = _jax_cfg("bonds").encoder
    enc = inp["params"]["bonds"]["encoders"][0]
    arrays = inp["fwd_arrays"]
    mesh = _mesh(2)
    want = {}
    sh, rep = jpar.build_edge_shards(arrays, 2)
    want["psum"] = jpar.make_edge_parallel_forward(cfg, mesh)(
        enc, _put(sh, mesh, ("ep",)), rep)
    sh, rep = jpar.build_edge_shards_halo(arrays, 2)
    shd = _put(sh, mesh, ("ep",))
    want["halo"] = jpar.make_edge_parallel_forward_halo(cfg, mesh)(enc, shd,
                                                                   rep)
    sw = jpar.halo_strip_width(sh)
    want["overlap"] = jpar.make_edge_parallel_forward_halo_overlap(
        cfg, mesh, sw)(enc, shd, rep)
    shb, repb = jpar.build_edge_shards_halo_band(arrays, 2)
    with pltpu.force_tpu_interpret_mode():
        want["band"] = jpar.make_edge_parallel_forward_halo_band(cfg, mesh)(
            enc, _put(shb, mesh, ("ep",)), repb)
    results = launches[2].result()
    _ranks_agree(results, "forwards")
    got = results[0]["forwards"]
    for name in ("psum", "halo", "band", "overlap"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    # the strip exchange is row-exact against the whole-window one
    np.testing.assert_allclose(got["overlap"], got["halo"], rtol=1e-6,
                               atol=1e-6)


def test_halo_train_step_matches_jax(run):
    inp, launches = run
    params = inp["params"]["bonds"]
    tx = jax_opt("sgd", lambda step: 0.1)
    mesh = _mesh(2)
    sh, rep = jpar.build_edge_shards_halo(inp["fwd_arrays"], 2)
    b = _batch(inp["fwd_arrays"], inp["targets8"])
    step = jpar.make_halo_train_step(_jax_cfg("bonds"), tx, mesh, "ep")
    new, _, loss, _ = step(params, tx.init(params), _put(sh, mesh, ("ep",)),
                           rep, jnp.asarray(b["targets"]),
                           jnp.asarray(b["mask"]), jnp.asarray(b["weights"]))
    results = launches[2].result()
    _ranks_agree(results, "halo_step")
    p_loss, p_new = results[0]["halo_step"]
    np.testing.assert_allclose(p_loss, float(loss), rtol=RTOL)
    _close(p_new, jax.device_get(new), what="halo step")


@pytest.mark.parametrize("name", ["bonds", "atom_messages", "undirected"])
def test_halo_dp_2d_step_matches_jax(run, name):
    inp, launches = run
    params = inp["params"][name]
    tx = jax_opt("sgd", lambda step: 0.1)
    mesh = _mesh(4, ("dp", "ep"), shape=(2, 2))
    sh, rep = jpar.build_edge_shards_halo_dp(inp["dp_arrays"], 2,
                                             atom_window=96)
    t = jnp.asarray(np.asarray(inp["dp_targets"], np.float32)[..., None])
    step = jpar.make_halo_dp_train_step(_jax_cfg(name), tx, mesh)
    new, _, loss, _ = step(params, tx.init(params),
                           _put(sh, mesh, ("dp", "ep")), rep, t,
                           jnp.ones_like(t), jnp.ones_like(t),
                           jnp.zeros((2, 2, 2), jnp.uint32),
                           jax.random.PRNGKey(0))
    results = launches[4].result()
    for overlap in (False, True):
        _ranks_agree(results, f"2d_{name}_{overlap}")
    p_loss, p_new = results[0][f"2d_{name}_False"]
    np.testing.assert_allclose(p_loss, float(loss), rtol=RTOL)
    _close(p_new, jax.device_get(new), what=name)
    o_loss, o_new = results[0][f"2d_{name}_True"]
    assert abs(o_loss - p_loss) < 1e-6
    _close(o_new, p_new, rtol=1e-5, atol=1e-6, what=f"{name} overlap")


def test_dp_step_matches_jax(run):
    inp, launches = run
    params = inp["params"]["bonds"]
    tx = jax_opt("sgd", lambda step: 0.1)
    mesh = _mesh(2, ("dp",))
    stacked = jpar.stack_device_batches(
        [_batch(a, t) for a, t in zip(inp["dp_arrays"], inp["dp_targets"])])
    step = jpar.make_dp_train_step(_jax_cfg("bonds"), tx, mesh, "dp")
    rngs = jnp.asarray(jax.random.split(jax.random.PRNGKey(0), 2))
    new, _, loss, gnorm = step(params, tx.init(params),
                               jpar.shard_batch(stacked, mesh, "dp"), rngs)
    new = jax.device_get(new)
    grads = jax.tree_util.tree_map(lambda p, q: (p - q) / 0.1, params, new)
    results = launches[2].result()
    _ranks_agree(results, "dp")
    p_loss, p_gnorm, p_grads, p_new = results[0]["dp"]
    np.testing.assert_allclose(p_loss, float(loss), rtol=RTOL)
    np.testing.assert_allclose(p_gnorm, float(gnorm), rtol=RTOL)
    _close(p_new, new, what="parameters")
    _close(p_grads, grads, what="gradients")


@pytest.mark.parametrize("key, n", [("dp_repeat", 2), ("2d_repeat", 4)])
def test_two_runs_of_one_seed_agree_bit_for_bit(run, key, n):
    """The dp step (2 ranks) and the 2-D halo step (dp 2 x ep 2), each run
    twice from one seed: the parameters' SHA-256 are equal between the
    runs and on every rank."""
    _, launches = run
    results = launches[n].result()
    assert all(len(r[key]) == 2 for r in results)
    assert len({sha for r in results for sha in r[key]}) == 1


def test_window_dropout_is_invariant_to_the_ep_split(run):
    """Window masks keyed by global atom row (atom_messages: every dropped
    tensor lives on the window): ep 1 and ep 2 take the same step, and
    the masks do fire."""
    _, launches = run
    got = launches[2].result()[0]
    assert abs(got["dropout_ep1_True"] - got["dropout_ep2_True"]) \
        < 1e-5 * max(1.0, abs(got["dropout_ep1_True"]))
    assert abs(got["dropout_ep1_True"] - got["dropout_ep1_False"]) > 1e-6
    assert abs(got["dropout_ep2_False"] - got["dropout_ep1_False"]) < 1e-5


def test_gspmd_step_matches_jax(run):
    inp, launches = run
    params = inp["params"]["bonds"]
    tx = jax_opt("sgd", lambda step: 0.1)
    step = jpar.make_gspmd_train_step(_jax_cfg("bonds"), tx,
                                      _mesh(2, ("gp",)), "gp")
    new, _, loss = step(params, tx.init(params),
                        _batch(inp["gspmd_arrays"], inp["targets8"]),
                        jax.random.PRNGKey(0))
    results = launches[2].result()
    _ranks_agree(results, "gspmd")
    p_loss, p_new = results[0]["gspmd"]
    np.testing.assert_allclose(p_loss, float(loss), rtol=RTOL)
    _close(p_new, jax.device_get(new), what="gspmd")


def test_multihost_two_processes_match_one_bit_for_bit(run):
    """Two processes, one micro-batch each (the 2-rank launch), against one
    process holding both micro-batches: the same losses and parameters
    after two Adam steps, bit for bit (the all-reduce of two ranks and the
    local sum of two micro-batches add the same two gradients)."""
    from polymer_chemprop_tpu_torch.models.convert import (load_jax_params,
                                                          params_to_jax)
    from polymer_chemprop_tpu_torch.models.encoder import EncoderConfig
    from polymer_chemprop_tpu_torch.models.model import (ModelConfig,
                                                        MoleculeModel)
    from polymer_chemprop_tpu_torch.ops.sorted_aux import sorted_batch
    from polymer_chemprop_tpu_torch.train.scheduler import (
        build_optimizer, constant_schedule)
    inp, launches = run
    model = MoleculeModel(ModelConfig(
        encoder=EncoderConfig(band_precision="highest", **CONFIGS["bonds"]),
        dataset_type="regression", num_tasks=1, ffn_hidden_size=16))
    load_jax_params(model, inp["params"]["bonds"])
    mesh = tpar.make_mesh(1, ("dp",))
    step = tpar.make_dp_train_step(
        model, build_optimizer("adam", model.parameters()),
        constant_schedule(1e-3), mesh)
    micro = []
    for p in range(2):
        arrays = inp["mh_arrays"][p]
        micro.append(_batch(sorted_batch(arrays), [
            float(i) for i in inp["mh_order"][4 * p:4 * p + 4]]))
    losses = []
    for _ in range(2):
        loss, _ = step(tpar.shard_batch(tpar.stack_device_batches(micro),
                                        mesh, "dp", "cpu"))
        losses.append(float(loss))
    results = launches[2].result()
    _ranks_agree(results, "multihost")
    got_losses, got = results[0]["multihost"]
    assert got_losses == losses
    _close(got, params_to_jax(model), rtol=0, atol=0, what="multihost")


def test_unshardable_batch_raises_as_jax():
    """A molecule spanning 3+ shards: both partitioners refuse it with the
    same message (the trainer then falls back to the single-device
    step)."""
    ring = "C1" + "C" * 198 + "1"
    arrays = mol2graph([ring], pad_atoms=256, pad_bonds=512,
                       pad_mols=1).arrays()
    msgs = []
    for build in (jpar.build_edge_shards_halo, tpar.build_edge_shards_halo):
        with pytest.raises(ValueError, match="3\\+ edge shards") as exc:
            build(arrays, 8)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_host_partitioners_match_jax():
    """The port's copies of the host partitioners give the JAX package's
    arrays (the port adds ``num_atoms``), and the port's band layout is the
    halo layout plus each shard's CSR."""
    arrays = mol2graph(SMILES8 + ["O", "C"], pad_atoms=128, pad_bonds=256,
                       pad_mols=10).arrays()
    for n in (2, 4):
        for build in ("build_edge_shards", "build_edge_shards_halo"):
            (js, jr), (ts, tr) = (getattr(m, build)(arrays, n)
                                  for m in (jpar, tpar))
            assert set(ts) - set(js) <= {"num_atoms"}
            for k in js:
                np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
            for k in jr:
                np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        sh, _ = tpar.build_edge_shards_halo(arrays, n)
        assert tpar.halo_strip_width(sh) == jpar.halo_strip_width(sh)
        band, _ = tpar.build_edge_shards_halo_band(arrays, n)
        for k in sh:
            np.testing.assert_array_equal(band[k], sh[k], err_msg=k)
        assert band["rowptr"].shape == (n, sh["f_atoms_win"].shape[1] + 2)
    reps = [mol2graph(SMILES_A, **PAD_2D).arrays(),
            mol2graph(SMILES_B, **PAD_2D).arrays()]
    (js, _), (ts, _) = (m.build_edge_shards_halo_dp(reps, 2, atom_window=96)
                        for m in (jpar, tpar))
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
