"""The port's C++ host featurizer (polymer_chemprop_tpu_torch/native_ext.py).

Its arrays must equal the port's Python path (``features/``) bit for bit
(``np.array_equal`` and equal dtypes: no tolerance), and the JAX
package's native library on the same SMILES where that library is built.
The library is compiled once with g++ into ``build/`` under a hash of the
sources, flags, compiler and CPU, and shared by every test process.
"""

import csv
import itertools
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

from polymer_chemprop_tpu_torch import native_ext
from polymer_chemprop_tpu_torch.data import (MoleculeDataLoader,
                                              MoleculeDatapoint,
                                              MoleculeDataset)
from polymer_chemprop_tpu_torch.features import FeaturizationConfig, mol2graph
from test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
FIELDS = ("f_atoms", "f_bonds", "w_atoms", "w_bonds", "b2a", "b2dst",
          "b2revb", "a2mol", "degree_of_polym", "mol_mask")

# the monomers of tests/test_native.py (TestPolymerNative)
MONOMERS = [
    "[*:1]CC[*:2]", "[*:1]c1ccc([*:2])cc1", "[*:1]CO[*:2]",
    "[*:1]C(C)C[*:2]", "[*:1]c1ccc([*:2])cc1C", "[*:1]CC(=O)O[*:2]",
    "[*:1]c1ccc(nc1)[*:2]", "[*:1]C=CC[*:2]", "[*:1]CC(F)(F)[*:2]",
    "[*:1]C[C@@H](C)O[*:2]", "[*:1]c1ccsc1[*:2]", "[*:1]CN(C)C(=O)[*:2]",
    "[*:1]CC([O-])=O[*:2]",
]


def _copolymers():
    """tests/test_native.py's copolymer corpus, and its double-bond
    attachments."""
    out = []
    for i, (m1, m2) in enumerate(itertools.combinations(MONOMERS, 2)):
        m2r = m2.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
        frac = 0.25 + 0.5 * ((i % 3) / 2.0)
        xn = "" if i % 2 else "~%d" % (10 + i)
        out.append(f"{m1}.{m2r}|{frac}|{1 - frac}|"
                   f"<1-3:0.375:0.375<1-4:0.375:0.375<2-3:0.375:0.375"
                   f"<2-4:0.375:0.375{xn}")
    out += [f"{m}|1.0|<1-2:0.5:0.5~25" for m in MONOMERS[:4]]
    return out + ["[*:1]=CC=[*:2]|1.0|<1-2:0.5:0.5~5",
                  "[*:1]=Cc1ccc(C=[*:2])cc1|1.0|<1-2:1.0:1.0"]


def _smiles(fname, n=None):
    with open(os.path.join(DATA, fname)) as f:
        rows = [row[0] for row in csv.reader(f)][1:]
    return rows[:n] if n else rows


# name: (SMILES, FeaturizationConfig, featurize_batch_native kwargs)
CASES = {
    "regression": (lambda: _smiles("regression.csv"),
                   FeaturizationConfig(), {}),
    "classification": (lambda: _smiles("classification.csv"),
                       FeaturizationConfig(), {}),
    "polymer": (_copolymers, FeaturizationConfig(polymer=True),
                dict(polymer=True)),
    "polymer_explicit_h": (
        lambda: _copolymers()[:20],
        FeaturizationConfig(polymer=True, explicit_h=True, adding_h=True),
        dict(polymer=True, keep_h=True, add_h=True)),
    "explicit_h": (
        lambda: _smiles("regression.csv", 120) + [
            "[H]C([H])([H])O[H]", "[2H]C(Cl)Cl", "C[C@H](N)C(=O)O"],
        FeaturizationConfig(explicit_h=True), dict(keep_h=True)),
    "adding_h": (lambda: _smiles("regression.csv", 120),
                 FeaturizationConfig(adding_h=True), dict(add_h=True)),
    **{f"reaction_{mode}": (
        lambda: _smiles("reaction_regression.csv", 40),
        FeaturizationConfig.for_reaction(mode), dict(reaction_mode=mode))
       for mode in ("reac_diff", "reac_prod", "prod_diff")},
    "reaction_balance_adding_h": (
        lambda: _smiles("reaction_regression.csv", 20),
        FeaturizationConfig.for_reaction("reac_prod_balance", explicit_h=True,
                                         adding_h=True),
        dict(reaction_mode="reac_prod_balance", keep_h=True, add_h=True)),
}


def _python_batch(smiles, cfg):
    """The Python path, packed at the width the valid molecules need, and
    those molecules."""
    from polymer_chemprop_tpu_torch.data.csv_io import _parseable
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # stochastic-weight-sum warnings
        smiles = [s for s in smiles if _parseable([s], cfg)]
        return mol2graph(smiles, cfg, align=256), smiles


def _assert_identical(got, want, what=""):
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert np.array_equal(a, b), f"{what}: {k} differs"
    assert (got.n_atoms_real, got.n_bonds_real) == (want.n_atoms_real,
                                                    want.n_bonds_real)


@pytest.mark.parametrize("case", list(CASES))
def test_native_batch_equals_python_bit_for_bit(case):
    make, cfg, kw = CASES[case]
    want, smiles = _python_batch(make(), cfg)
    assert len(smiles) >= 20
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, valid = native_ext.featurize_batch_native(
            smiles, pad_atoms=want.f_atoms.shape[0],
            pad_bonds=want.f_bonds.shape[0], n_threads=4, **kw)
    assert valid.all()
    _assert_identical(got, want, case)
    atoms, bonds = native_ext.count_native(smiles, n_threads=2, **kw)
    assert 1 + atoms.sum() == want.n_atoms_real
    assert 1 + bonds.sum() == want.n_bonds_real


def test_invalid_smiles_are_flagged_in_valid():
    gb, valid = native_ext.featurize_batch_native(
        ["CCO", "not_a_smiles", "c1ccccc1", "C1CC"], pad_atoms=256,
        pad_bonds=256, pad_mols=6)
    assert valid.tolist() == [1, 0, 1, 0]
    assert gb.mol_mask.tolist() == [1, 0, 1, 0, 0, 0]
    assert gb.n_atoms_real == 1 + 3 + 6 and set(gb.a2mol[1:10]) == {0, 2}
    atoms, bonds = native_ext.count_native(["CCO", "xx", "c1ccccc1"])
    assert atoms.tolist() == [3, -1, 6] and bonds.tolist() == [4, -1, 12]
    _, valid = native_ext.featurize_batch_native(
        ["[*:1]CC[*:2]|1.0|<1-2:0.5", "[*:1]CC[*:2]|1.0|<1-2:0.3:0.7~50"],
        pad_atoms=64, pad_bonds=64, polymer=True)
    assert valid.tolist() == [0, 1]
    _, valid = native_ext.featurize_batch_native(
        ["CCO>>CCN", "no_arrows", "xx>>yy"], pad_atoms=64, pad_bonds=128,
        reaction_mode="reac_diff")
    assert valid.tolist() == [1, 0, 0]
    with pytest.raises(ValueError, match="padding envelope"):
        native_ext.featurize_batch_native(["c1ccccc1"], pad_atoms=4,
                                          pad_bonds=64)


def test_bond_parse_order_export():
    """``bond_parse_out``: a directed bond and its reverse share their
    1-based parse index; padding rows read 0."""
    smiles = _smiles("regression.csv", 10)
    want, _ = native_ext.featurize_batch_native(smiles, 512, 1024)
    parse = np.full(1024, -1, np.int32)
    got, _ = native_ext.featurize_batch_native(smiles, 512, 1024,
                                               bond_parse_out=parse)
    _assert_identical(got, want)
    n = got.n_bonds_real
    assert parse[0] == 0 and (parse[n:] == 0).all()
    assert np.array_equal(parse[1:n], parse[got.b2revb[1:n]])
    assert sorted(set(parse[1:n].tolist())) == list(range(1, n // 2 + 1))


# -- the JAX package's library --------------------------------------------

def _jax_native():
    jax_native = pytest.importorskip("polymer_chemprop_tpu.native_ext")
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not built")
    return jax_native


@pytest.mark.parametrize("case", ["regression", "polymer", "explicit_h",
                                  "reaction_reac_diff"])
def test_equals_jax_native_library(case):
    jax_native = _jax_native()
    make, _, kw = CASES[case]
    smiles = make()[:200] + ["not_a_smiles"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for a, b in zip(native_ext.count_native(smiles, **kw),
                        jax_native.count_native(smiles, **kw)):
            assert np.array_equal(a, b)
        got, gv = native_ext.featurize_batch_native(smiles, 8192, 16384,
                                                    pad_mols=256, **kw)
        want, wv = jax_native.featurize_batch_native(smiles, 8192, 16384,
                                                     pad_mols=256, **kw)
    assert np.array_equal(gv, wv) and not gv[-1]
    _assert_identical(got, want, case)


def test_rdkit2d_equals_jax_native_library():
    jax_native = _jax_native()
    smiles = _smiles("regression.csv", 60) + ["not_a_smiles"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, gok = native_ext.rdkit2d_batch_native(smiles, n_threads=2)
        want, wok = jax_native.rdkit2d_batch_native(smiles, n_threads=2)
    assert got.shape == (61, 200) and got.dtype == np.float64
    assert np.array_equal(gok, wok) and gok[:60].all() and not gok[60]
    assert np.array_equal(got, want)


# -- the loader ------------------------------------------------------------

def _loader_batches(data, cfg, use_native, num_workers=2):
    loader = MoleculeDataLoader(data, cfg, batch_size=16, shuffle=True,
                                seed=3, num_workers=num_workers,
                                use_native=use_native)
    assert loader.use_native is bool(use_native)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(loader)


def _assert_same_arrays(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_arrays(a[k], b[k], f"{what} {k}")
        else:
            assert a[k].dtype == b[k].dtype, (what, k)
            assert np.array_equal(a[k], b[k]), f"{what}: {k} differs"


@pytest.mark.parametrize("positions", [1, 2])
def test_loader_native_equals_python(positions):
    smiles = _smiles("regression.csv", 60)
    rows = [[s, smiles[-1 - i]][:positions] for i, s in enumerate(smiles)]
    data = MoleculeDataset([MoleculeDatapoint(r, [float(i)])
                            for i, r in enumerate(rows)])
    cfg = FeaturizationConfig()
    nat, py = (_loader_batches(data, cfg, u) for u in (True, False))
    assert len(nat) == len(py) == 4
    for bn, bp in zip(nat, py):
        assert len(bn.graph_arrays) == positions
        assert "sorted_aux" in bn.graph_arrays[0]
        for pos in range(positions):
            _assert_same_arrays(bn.graph_arrays[pos], bp.graph_arrays[pos],
                                f"position {pos}")
        assert np.array_equal(bn.targets, bp.targets)


def test_loader_native_equals_python_polymer():
    data = MoleculeDataset([MoleculeDatapoint([s], [1.0])
                            for s in _copolymers()[:40]])
    cfg = FeaturizationConfig(polymer=True)
    for bn, bp in zip(_loader_batches(data, cfg, True),
                      _loader_batches(data, cfg, False)):
        _assert_same_arrays(bn.graph_arrays[0], bp.graph_arrays[0],
                            "polymer")


CONFIGS = {
    "standard": (["CCO"], FeaturizationConfig()),
    "two_molecules": (["CCO", "c1ccccc1"], FeaturizationConfig()),
    "explicit_h": (["[H]OC"], FeaturizationConfig(explicit_h=True)),
    "adding_h": (["CCO"], FeaturizationConfig(adding_h=True)),
    "polymer": (["[*:1]CC[*:2]|1.0|<1-2:0.5:0.5~5"],
                FeaturizationConfig(polymer=True, adding_h=True)),
    "reaction": (["[CH3:1][OH:2]>>[CH3:1][O-:2]"],
                 FeaturizationConfig.for_reaction("reac_diff",
                                                  explicit_h=True)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_auto_picks_native_where_the_jax_loader_does(name, monkeypatch):
    from polymer_chemprop_tpu.data import MoleculeDataLoader as JaxLoader
    from polymer_chemprop_tpu.data import MoleculeDatapoint as JaxPoint
    from polymer_chemprop_tpu.data import MoleculeDataset as JaxDataset
    from polymer_chemprop_tpu.features import (
        FeaturizationConfig as JaxFeaturizationConfig,
    )
    jax_native = _jax_native()
    smiles, cfg = CONFIGS[name]
    jax_cfg = JaxFeaturizationConfig(**vars(cfg))
    want = JaxLoader(JaxDataset([JaxPoint(smiles, [1.0])]), jax_cfg,
                     batch_size=1, num_workers=1).use_native
    assert want and jax_native.available()
    data = MoleculeDataset([MoleculeDatapoint(smiles, [1.0])])
    auto = MoleculeDataLoader(data, cfg, batch_size=1, num_workers=1)
    assert auto.use_native is True
    batches = list(auto)
    assert len(batches) == 1 and len(batches[0].graph_arrays) == len(smiles)

    # use_native=False never reaches the C++ library
    def refuse(*args, **kwargs):
        raise AssertionError("the C++ featurizer was called")
    monkeypatch.setattr(native_ext, "featurize_batch_native", refuse)
    monkeypatch.setattr(native_ext, "count_native", refuse)
    off = MoleculeDataLoader(data, cfg, batch_size=1, num_workers=1,
                             use_native=False)
    assert off.use_native is False
    for a, b in zip(list(off)[0].graph_arrays, batches[0].graph_arrays):
        _assert_same_arrays(a, b, name)
    with pytest.raises(AssertionError, match="C\\+\\+ featurizer"):
        list(auto.__class__(data, cfg, batch_size=1, num_workers=1))


# -- the build -------------------------------------------------------------

def test_a_second_load_reuses_the_built_library(monkeypatch):
    lib = native_ext.load()
    path = native_ext.library_path()
    assert path.exists() and path.parent == native_ext.BUILD_DIR
    # the port's own sources, never the repository's native/
    assert native_ext.SRC_DIR.is_relative_to(native_ext.PACKAGE_DIR)
    assert path.name.startswith("libpcp_native-")
    mtime = path.stat().st_mtime_ns

    def no_compiler(*args, **kwargs):
        raise AssertionError("the compiler ran again")
    monkeypatch.setattr(native_ext.subprocess, "run", no_compiler)
    assert native_ext.load() is lib
    assert native_ext.build() < 1.0
    assert path.stat().st_mtime_ns == mtime


def test_threads_racing_on_first_load_share_one_library(monkeypatch):
    """More threads than cores race through ``load()`` from an unloaded
    module (the loader's thread pool does): one handle, equal results."""
    import threading
    import time
    native_ext.load()                  # built; the race is on the load
    monkeypatch.setattr(native_ext, "_LIB", None)
    smiles = _smiles("regression.csv", 50)
    want = native_ext.featurize_batch_native(smiles, 1024, 2048,
                                             n_threads=1)[0]
    monkeypatch.setattr(native_ext, "_LIB", None)
    handles, results = [], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            gb, _ = native_ext.featurize_batch_native(smiles, 1024, 2048,
                                                      n_threads=2)
            handles.append(native_ext._LIB)
            results.append(gb)
        threads = [threading.Thread(target=work)
                   for _ in range(2 * (os.cpu_count() or 4))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert time.monotonic() - t0 < 120
    assert len(results) == len(threads) and len(set(map(id, handles))) == 1
    for gb in results:
        _assert_identical(gb, want)


def test_library_name_covers_sources_flags_compiler_and_cpu(monkeypatch):
    base = native_ext.library_path()
    for attr, value in (("cpu_model", lambda: "another CPU"),
                        ("CXX_FLAGS", native_ext.CXX_FLAGS[1:])):
        monkeypatch.setattr(native_ext, "_PATH", None)
        with monkeypatch.context() as m:
            m.setattr(native_ext, attr, value)
            assert native_ext.library_path() != base
    monkeypatch.setattr(native_ext, "_PATH", None)
    monkeypatch.setattr(native_ext, "compiler", lambda: ["echo", "other"])
    assert native_ext.library_path() != base
    monkeypatch.setattr(native_ext, "_PATH", None)
    monkeypatch.undo()
    assert native_ext.library_path() == base
    assert "-ffp-contract=off" in native_ext.CXX_FLAGS
    assert "-march=native" in native_ext.CXX_FLAGS


def _stub_build_script(src, build_dir):
    """A child process that builds ``src``'s stub library into
    ``build_dir`` through native_ext.build()."""
    return textwrap.dedent(f"""
        from pathlib import Path
        from polymer_chemprop_tpu_torch import native_ext as n
        n.SRC_DIR, n.BUILD_DIR = Path({str(src)!r}), Path({str(build_dir)!r})
        n.build()
        print(n.library_path())
    """)


def test_concurrent_builds_both_succeed(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "pcp_native.cpp").write_text(
        '#include <unistd.h>\nextern "C" int pcp_stub() { return 7; }\n')
    (src / "pcp_descriptors.inc").write_text("")
    build_dir = tmp_path / "build"
    code = _stub_build_script(src, build_dir)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    built = [p.name for p in build_dir.iterdir()]
    assert [n for n in built if n.endswith(".so")] == [
        os.path.basename(paths.pop())]
    assert not [n for n in built if n.endswith(".tmp")]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "pcp_native.cpp").write_text("this is not C++;\n")
    (src / "pcp_descriptors.inc").write_text("")
    proc = subprocess.run(
        [sys.executable, "-c", _stub_build_script(src, tmp_path / "b")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "RuntimeError: building libpcp_native-" in proc.stderr
    assert "error" in proc.stderr
    assert not list((tmp_path / "b").glob("*.so"))


def test_importing_native_ext_builds_nothing(tmp_path):
    """Import with no compiler on the path and an empty build directory:
    nothing is built, loaded or hashed until a call needs the library."""
    code = textwrap.dedent(f"""
        from pathlib import Path
        import polymer_chemprop_tpu_torch.native_ext as n
        import polymer_chemprop_tpu_torch.data.loader
        n.BUILD_DIR = Path({str(tmp_path / 'b')!r})
        assert n._LIB is None and n._PATH is None
        assert not n.BUILD_DIR.exists()
        try:
            n.count_native(["CCO"])
        except RuntimeError as e:
            assert "not usable" in str(e), e
        else:
            raise AssertionError("built without a compiler")
        print("ok")
    """)
    env = dict(os.environ, CXX="/nonexistent/g++")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr
