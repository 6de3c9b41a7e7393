"""Nothing that the harness or the reference loads is JAX, its libraries
or the JAX package (top-level names compared whole), and the reference
loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "polymer_chemprop_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ROOT,
             "OMP_NUM_THREADS": "1"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    top = _loaded(
        "from portbench.reference import model as ref\n"
        "g = ref.featurize(['CCO', 'c1ccccc1'], False)\n"
        "ref.featurize(['[*:1]c1ccc([*:2])cc1.[*:3]c1ccc([*:4])s1|0.5|0.5|"
        "<1-3:0.5:0.5<1-4:0.5:0.5<2-3:0.5:0.5<2-4:0.5:0.5~10'], True)\n")
    assert not top & set(FORBIDDEN)
    assert "polymer_chemprop_tpu_torch" not in top


def test_a_run_loads_no_jax():
    top = _loaded(
        "import time, torch\n"
        "from portbench.harness import cell\n"
        "from portbench.tests.conftest import tiny_bench\n"
        "import tempfile\n"
        "d = tiny_bench(tempfile.mkdtemp() + '/b')\n"
        "rec, line = cell.run('dmpnn_h2400_d6.screen_ens5_b256', 3, 2.0, False,"
        " torch.device('cpu'), time.perf_counter(), bench_dir=d)\n"
        "assert line['correct']\n"
        "assert not cell.forbidden_modules()\n")
    assert not top & set(FORBIDDEN)
    assert "polymer_chemprop_tpu_torch" in top


def test_the_check_compares_whole_names(monkeypatch):
    from portbench.harness import cell
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    monkeypatch.setitem(sys.modules, "polymer_chemprop_tpu_torch_x", sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "polymer_chemprop_tpu.ops", sys)
    assert cell.forbidden_modules() == ["polymer_chemprop_tpu.ops"]
