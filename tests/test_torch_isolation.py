"""The PyTorch port stands alone: no JAX, optax or scikit-learn, nothing
of the JAX package, no silent CPU run, and nothing built or required at
import time."""

import ast
import os
import subprocess
import sys

import pytest
from test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "polymer_chemprop_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "sklearn", "polymer_chemprop_tpu",
             "scripts")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "polymer_chemprop_tpu_torch.ops.band_mpnn" in mods
    # the training modules are covered too
    for name in ("train.trainer", "train.cross_validate", "train.metrics",
                 "train.step", "train.scheduler", "train.loss",
                 "data.splits", "chem.scaffold", "models.init", "cli",
                 "kernels.build", "ops.sorted_aux", "models.encoder",
                 "models.nn", "ops.probe_kernels", "probes.timing",
                 "probes.bench_batch", "probes.band_layer_probe",
                 "probes.fused_matmul_probe", "native_ext",
                 "train.molecule_fingerprint", "features.generators",
                 "features.utils", "chem.smarts", "chem.descriptors",
                 "chem.descriptors.rdkit2d", "ssl",
                 "hyperparameter_optimization", "interpret", "web.app",
                 "web.db", "chem.write", "chem.depict",
                 "utils.torch_import", "parallel", "parallel.mesh",
                 "parallel.dp", "parallel.partition", "parallel.multihost",
                 "parallel.gspmd", "sklearn_train", "sklearn_predict",
                 "baselines", "baselines.pickles", "baselines.tree",
                 "baselines.forest", "baselines.svm", "baselines.linear",
                 "goldens", "eaip", "polymer_goldens",
                 "probes.determinism_probe", "multichip"):
        assert f"polymer_chemprop_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.')"
        f" for f in {FORBIDDEN!r})]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_parallel_starts_no_process_group_and_no_device():
    """Importing the parallel package (and its modules) starts no process
    group and initializes no CUDA context: that happens only when a caller
    asks (``initialize_multihost``)."""
    code = (
        "import torch, torch.distributed as dist\n"
        "import polymer_chemprop_tpu_torch.parallel as p\n"
        "from polymer_chemprop_tpu_torch.parallel import (dp, gspmd, mesh,"
        " multihost, partition)\n"
        "print(dist.is_initialized(), torch.cuda.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, WORLD_SIZE="2", RANK="0"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False"], proc.stdout


def test_forbidden_names_cover_optax_and_sklearn():
    assert _forbidden("optax") and _forbidden("sklearn.metrics")
    assert _forbidden("polymer_chemprop_tpu.train.loss")
    assert not _forbidden("polymer_chemprop_tpu_torch.train.loss")
    assert not _forbidden("scipy.stats")
    # the JAX side's scripts (scripts/tpu_goldens.py among them)
    assert _forbidden("scripts.tpu_goldens")


@pytest.mark.parametrize("path", ["polymer_chemprop_tpu_torch",
                                  "chip_smoke.py"])
def test_no_forbidden_import_in_source(path):
    full = os.path.join(ROOT, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    assert files
    for f in files:
        tree = ast.parse(open(f).read(), filename=f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{f}:{node.lineno} imports {bad}"


def test_entry_point_without_device_cpu_raises_here(tmp_path):
    """The default device is CUDA; without a GPU the port raises instead of
    running on the CPU."""
    import torch

    from polymer_chemprop_tpu_torch.config import PredictConfig
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    test_csv = tmp_path / "t.csv"
    test_csv.write_text("smiles\nCCO\n")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_predictions(PredictConfig(test_path=str(test_csv),
                                       checkpoint_path="unused.ckpt"))


def test_training_without_device_cpu_raises_here(tmp_path):
    """Training defaults to CUDA too and raises without a GPU."""
    import torch

    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    cfg = TrainConfig(data_path=os.path.join(ROOT, "tests", "data",
                                             "regression.csv"),
                      max_data_size=20, epochs=1, quiet=True)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cross_validate(cfg)


def test_goldens_without_device_cpu_raises_here(capsys):
    """The golden runner defaults to CUDA too: without a GPU it raises
    before it trains anything."""
    import torch

    from polymer_chemprop_tpu_torch import goldens
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        goldens.main(["regression"])
    assert "GOLDEN" not in capsys.readouterr().out


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """Only a CPU tensor goes to the plain version; a tensor on any other
    device goes to the kernel path (CUDA) or raises."""
    import torch

    from polymer_chemprop_tpu_torch.ops import band_mpnn
    m = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        band_mpnn.atom_readout(m, torch.zeros(4, device="meta"),
                               torch.zeros(3, dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        band_mpnn.band_rev_bwd(m, torch.zeros(4, device="meta"),
                               torch.zeros(4, dtype=torch.int32,
                                           device="meta"),
                               torch.zeros(3, dtype=torch.int32,
                                           device="meta"))
    # the four plain-band wrappers
    w = torch.zeros(4, device="meta")
    rowptr = torch.zeros(3, dtype=torch.int32, device="meta")
    wh = torch.zeros((8, 8), device="meta")
    # and the two atom_messages ops on the gather entry
    aux = {"w_sorted": w, "rowptr": rowptr, "srev": rowptr[:1].expand(4),
           "src_sorted": torch.zeros(4, dtype=torch.int32, device="meta")}
    h = torch.zeros((2, 8), device="meta")
    for call in (lambda: band_mpnn.band_agg(m, w, rowptr),
                 lambda: band_mpnn.band_bwd(m, w, rowptr),
                 lambda: band_mpnn.band_matmul_act(m, m, wh, w, rowptr,
                                                   "relu"),
                 lambda: band_mpnn.band_matmul(m, wh, w, rowptr),
                 lambda: band_mpnn.atom_neighbor_sum_sorted(h, aux),
                 lambda: band_mpnn.src_readout_sorted(h, aux),
                 lambda: band_mpnn.molecule_readout_sorted(
                     h, w[:2], rowptr[:2], dict(
                         mol_idx=rowptr[:2], mol_rowptr=rowptr,
                         mol_denom=w[:2]), w[:2])):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert band_mpnn.launch_counts() == dict.fromkeys(
        ("band_rev_layer", "band_rev_bwd", "atom_readout", "band_agg",
         "band_bwd", "band_matmul_act", "band_matmul",
         "atom_neighbor_sum_sorted", "src_readout_sorted",
         "molecule_readout_sorted"), 0)
    # the probes' two wrappers count apart from the encoder's ten
    from polymer_chemprop_tpu_torch.ops import probe_kernels
    with pytest.raises(ValueError, match="unsupported device"):
        probe_kernels.band_ctrl(m, m, wh, w, rowptr[:1], rowptr[:1], "noq")
    with pytest.raises(ValueError, match="unsupported device"):
        probe_kernels.fused_matmul(m, wh.to(torch.bfloat16),
                                   wh.to(torch.bfloat16))
    assert probe_kernels.launch_counts() == {"band_ctrl": 0,
                                             "fused_matmul": 0}


def test_kernel_modules_import_without_nvcc(monkeypatch):
    """Importing the wrappers and the builder needs no nvcc: the build runs
    at first launch, and without nvcc it fails loudly there."""
    import importlib

    monkeypatch.setenv("PATH", "/nonexistent")
    build = importlib.import_module("polymer_chemprop_tpu_torch.kernels.build")
    importlib.import_module("polymer_chemprop_tpu_torch.ops.band_mpnn")
    importlib.import_module("polymer_chemprop_tpu_torch.ops.probe_kernels")
    assert build.KERNELS == ("band_rev_layer", "band_rev_bwd", "atom_readout",
                             "band_agg", "band_bwd", "band_matmul",
                             "band_ctrl", "fused_matmul")
    for name in build.KERNELS:
        assert (build.CSRC_DIR / f"{name}.cu").exists()
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.nvcc_path()


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """The library's name hashes its source, every header beside it and the
    flags: an edit of the shared header must not load a stale library."""
    import shutil

    from polymer_chemprop_tpu_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {k: build.library_path(k).name for k in build.KERNELS}
    assert before["band_matmul"] != before["band_rev_layer"]
    with open(csrc / "band_tile.cuh", "a") as f:
        f.write("// edited\n")
    after = {k: build.library_path(k).name for k in build.KERNELS}
    assert all(after[k] != before[k] for k in build.KERNELS)
    with open(csrc / "band_agg.cu", "a") as f:
        f.write("// edited\n")
    last = {k: build.library_path(k).name for k in build.KERNELS}
    assert [k for k in build.KERNELS if last[k] != after[k]] == ["band_agg"]
