"""``polymer_chemprop_tpu_torch.multichip`` (the counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``) and the rules that put one
rank on each card, on the CPU.

The dry run goes through 2 and 4 gloo ranks with torchrun's environment
on a free port, started together in the background by a module fixture,
at a reduced bench-scale section (hidden 32, 512 bond pairs a rank): its
own checks must pass, and its summary must carry the keys of the JAX dry
run's ``DRYRUN_SUMMARY`` (read from ``__graft_entry__.py`` by ``ast``).
The backend rule is checked with the CUDA queries and torchrun's
variables patched; the kernel build's lock with a stand-in compiler.
"""

import ast
import json
import os
import socket
import subprocess
import sys

import pytest
import torch
from test_torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (2, 4)


def _jax_summary_keys(n_devices):
    """The keys of the JAX dry run's ``DRYRUN_SUMMARY`` at ``n_devices``:
    the literal dict it prints and its ``overlap_summary`` (four devices
    or more) and ``am_summary`` (two or more)."""
    tree = ast.parse(open(os.path.join(REPO, "__graft_entry__.py")).read())
    parts = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and node.value.keys and isinstance(node.targets[0], ast.Name):
            parts[node.targets[0].id] = node.value
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and isinstance(node.args[0], ast.Dict):
            parts["summary"] = node.args[0]
    keys = set()
    for name in ["summary"] + (["overlap_summary"] if n_devices >= 4
                               else []) + ["am_summary"]:
        keys |= {k.value for k in parts[name].keys if k is not None}
    return keys


class _Launch:
    """``n`` processes of the dry run with torchrun's environment on a free
    port; :meth:`result` waits and returns the summary and the logs."""

    def __init__(self, n, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        self.n, self.out = n, os.path.join(out_dir, "summary.json")
        self.logs = [open(os.path.join(out_dir, f"log{r}.txt"), "w")
                     for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "polymer_chemprop_tpu_torch.multichip",
             "--device", "cpu", "--bench_hidden", "32", "--bench_pairs",
             "512", "--reps", "2", "--out", self.out], cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                     MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE=str(n)),
            stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]

    def result(self):
        rcs = [p.wait(timeout=240) for p in self.procs]
        for f in self.logs:
            f.close()
        logs = [open(f.name).read() for f in self.logs]
        assert rcs == [0] * self.n, "".join(t[-3000:] for t in logs)
        with open(self.out) as f:
            return json.load(f), logs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multichip")
    runs = {n: _Launch(n, str(tmp / f"ranks{n}")) for n in SIZES}
    yield runs
    for launch in runs.values():
        launch.kill()


@pytest.mark.parametrize("n", SIZES)
def test_dry_run_passes_its_checks_with_the_jax_summary_keys(launches, n):
    summary, logs = launches[n].result()
    assert summary["ok"] and all(summary["checks"].values()), \
        summary["checks"]
    assert summary["n_devices"] == n
    missing = _jax_summary_keys(n) - set(summary)
    assert not missing, missing
    # the checks of every section ran: the 2-D one from four ranks on
    expected = {"dp_loss", "psum_forward", "halo_forward", "halo_step",
                "bench_loss", "bench_params", "bench_elementwise",
                "atom_messages"} | ({"overlap_2d", "step_2d"} if n >= 4
                                    else set())
    assert set(summary["checks"]) == expected
    assert summary["bench_single_loss"] == pytest.approx(
        summary["bench_halo_loss"], rel=1e-4)
    assert summary["bench_max_param_rel_err"] < 1e-2
    # the bench-scale batch's real bonds, each shard's beside its rows
    real = summary["bench_real_bonds_per_shard"]
    assert len(real) == n and 0 < sum(real)
    assert max(real) <= summary["bench_bonds_per_shard"]
    # every rank reports its backend and device; CPU ranks take gloo
    assert [r["rank"] for r in summary["ranks"]] == list(range(n))
    assert {(r["backend"], r["device"]) for r in summary["ranks"]} == {
        ("gloo", "cpu")}
    for r, text in enumerate(logs):
        assert f"multichip rank {r} of {n}: backend gloo, device cpu" \
            in text
    assert "DRYRUN_SUMMARY " in logs[0]
    for key in ("halo_exchange_ms_per_layer", "strip_exchange_ms_per_layer",
                "dp_allreduce_ms", "bench_gp_step_ms",
                "bench_single_step_ms"):
        assert summary[key] > 0, key
    # on the CPU every kernel op runs its plain version: no launch
    assert not any(summary["launches"].values())


@pytest.mark.parametrize("ranks, cards, device, backend, devices", [
    (4, 4, "cuda", "nccl", [f"cuda:{r}" for r in range(4)]),
    (4, 1, "cuda", "gloo", ["cuda:0"] * 4),
    (4, 2, "cuda", "gloo", ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]),
    (4, 0, "cpu", "gloo", ["cpu"] * 4),
])
def test_backend_rule(monkeypatch, ranks, cards, device, backend, devices):
    """NCCL when every rank of the host has a card of its own, gloo on the
    CPU and when ranks share cards; rank r takes card r mod cards."""
    from polymer_chemprop_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(ranks))
    got = []
    for r in range(ranks):
        monkeypatch.setenv("LOCAL_RANK", str(r))
        assert multihost.pick_backend(device) == backend
        got.append(str(multihost.rank_device(device)))
    assert got == devices


@pytest.mark.parametrize("cards, device", [(1, "cuda"), (0, "cpu")])
def test_nccl_without_a_card_a_rank_raises(monkeypatch, cards, device):
    """NCCL asked for where a rank has no card of its own raises before any
    process group starts: nothing falls back to gloo."""
    import torch.distributed as dist

    from polymer_chemprop_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="backend nccl needs"):
        multihost.initialize_multihost(backend="nccl", device=device)
    assert not dist.is_initialized()


BUILD_SCRIPT = r'''
import sys
from pathlib import Path
from polymer_chemprop_tpu_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
build.nvcc_path = lambda: sys.argv[2]
build.build()
'''

FAKE_NVCC = r'''#!/bin/sh
# a stand-in compiler: note the call, take a while, write the output
echo x >> "$(dirname "$0")/calls"
sleep 0.3
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
'''


def test_ranks_starting_cold_build_each_kernel_once(tmp_path):
    """Processes that share a checkout and start with nothing built (the
    ranks of a launch) queue on the build's lock: each library is compiled
    once, and every process finds every library."""
    from polymer_chemprop_tpu_torch.kernels import build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    out = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(out),
                               str(nvcc)], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO))
             for _ in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 4
    calls = (tmp_path / "calls").read_text().split()
    assert len(calls) == len(build.KERNELS)
    for name in build.KERNELS:
        assert (out / build.library_path(name).name).exists()
