"""Fixtures of the benchmark's tests: a copy of the benchmark's data files
at a size the CPU holds (hidden 32, depth 3, short chunks), and torch on
one thread."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "portbench")
TINY = {"hidden_size": 32, "ffn_hidden_size": 32, "depth": 3}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_bench(dst: str) -> str:
    """A copy of the benchmark's configurations, traffic mixes, limits and
    metric readers under ``dst``, every configuration at a tiny width and
    every chunk short."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(dst, sub))
    for name in os.listdir(os.path.join(dst, "configs")):
        path = os.path.join(dst, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TINY)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(dst, "traffic")):
        path = os.path.join(dst, "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        if tr["kind"] == "screen":
            tr.update(chunk=300, warmup_molecules=64, check_sample=4096)
        else:
            tr.update(setup_epochs=2)
        with open(path, "w") as f:
            json.dump(tr, f)
    return dst


@pytest.fixture
def tiny(tmp_path):
    return tiny_bench(str(tmp_path))


@pytest.fixture
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cells_of_kind(kind: str) -> list:
    """Names of the manifest's cells whose traffic mix is of ``kind``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    out = []
    for w in man["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            if json.load(f)["kind"] == kind:
                out.append(w["name"])
    return out
