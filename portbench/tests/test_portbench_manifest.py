"""BENCHMARK.json against the benchmark's contract: names, units and
characters, every entry's keys, the files each entry names, and the
metric folders beside it."""

from __future__ import annotations

import glob
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(manifest):
    assert set(manifest) == KEYS["top"]
    assert manifest["paths"] == ["portbench"]
    assert all(PATH.match(p) for p in manifest["paths"])
    assert 1 <= len(manifest["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    cells = len(manifest["workloads"])
    check = 2 + 14 * 24
    assert check * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 \
        <= 43200, "the full 24 cells would not fit a check"
    assert 1 <= cells <= 24


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_keys(manifest, kind):
    entries = manifest[kind]
    key = {"configs": "config", "workloads": "workload"}.get(kind, kind)
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - KEYS[key] - {"workloads"}
        assert not extra and KEYS[key] <= set(e), (e["name"], extra)
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for field in ("why", "layer", "source"):
            if field in e:
                assert LINE.match(e[field]), (e["name"], field)


def test_metric_names_unique_across_kinds(manifest):
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16


def test_workloads(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        name = w["name"]
        mine = lambda m: "workloads" not in m or name in m["workloads"]
        e2e = [m["name"] for m in manifest["end_to_end"] if mine(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, name
        per = [m for m in manifest["per_layer"] if mine(m)]
        assert per, name
        for m in per:
            assert m["moves"] in e2e, (name, m["name"])


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in manifest["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("metric", [m["name"] for m in _man()["per_layer"]])
def test_metric_folder(manifest, metric):
    """Each per-layer metric has a reader, from its folder or its stem;
    metrics of one stem give one layer; a roofline's listed kernels each
    give their launches and their work."""
    from portbench.harness import cell, work
    m = {x["name"]: x for x in manifest["per_layer"]}[metric]
    assert callable(cell.reader(metric))
    layers = {x["layer"] for x in manifest["per_layer"]
              if x["name"].split(".")[0] == metric.split(".")[0]}
    assert len(layers) == 1
    if metric.split(".")[0].endswith("_roofline"):
        assert m["unit"] == "%"
        kernels = glob.glob(os.path.join(BENCH, "metrics", metric,
                                         "kernels", "*.json"))
        assert kernels
        for path in kernels:
            with open(path) as f:
                k = json.load(f)
            w = work.kernel_work(k, 8, 1, 2, 4)
            assert w["bytes"] > 0 and w["ops"] > 0
            assert k["match"] and work.kernel_calls(k, 6) >= 1
    if "mfu" in metric:
        assert m["unit"] == "%"


def test_files_named_from_name_characters():
    for path in glob.glob(os.path.join(BENCH, "**", "*"), recursive=True):
        rel = os.path.relpath(path, ROOT)
        if "__pycache__" in rel:
            continue
        assert PATH.match(rel), rel
