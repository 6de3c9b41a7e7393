"""The port's C++ host featurizer: built at first use, bound with ctypes.

The port's copy of polymer_chemprop_tpu native_ext.py, on the port's own
copy of the sources (``native/src/pcp_native.cpp``, which includes
``pcp_descriptors.inc``). The first call that needs the library compiles
it into ``build/libpcp_native-<hash>.so`` at the repository root
(``build/`` is git-ignored)::

    g++ -O3 -march=native -ffp-contract=off -std=c++17 -fPIC -shared \\
        -pthread -o build/libpcp_native-<hash>.so native/src/pcp_native.cpp

(``$CXX`` in place of ``g++`` when it is set). ``-ffp-contract=off``
forbids fused multiply-adds, which is what keeps every feature bit for
bit the Python path's (``features/``). The hash covers both sources, the
flags, the compiler's ``--version`` and the CPU (its model and flags in
/proc/cpuinfo, and what the compiler makes of ``-march=native``), which
ties the library to the kind of host that built it: a library built on
one host is never loaded on another. Builds that race (threads of one
process, or processes sharing the checkout) queue on a lock file; each
writes a temporary file and renames it into place. A failed build raises
with the compiler's output; there is no silent fall-back to Python (the
loader takes the Python path only when asked, ``use_native=False``).
Nothing here builds or loads anything at import.

A ctypes call releases the GIL, so the loader's threads featurize batches
side by side; each call also runs ``n_threads`` C++ threads of its own.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shlex
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SRC_DIR = PACKAGE_DIR / "native" / "src"
SOURCES = ("pcp_native.cpp", "pcp_descriptors.inc")
BUILD_DIR = PACKAGE_DIR.parent / "build"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-fPIC", "-shared", "-pthread")

# reaction modes (features/config.py REACTION_MODES): C enum + balance
_RXN_MODE = {"reac_prod": (0, 0), "reac_diff": (1, 0), "prod_diff": (2, 0),
             "reac_prod_balance": (0, 1), "reac_diff_balance": (1, 1),
             "prod_diff_balance": (2, 1)}

_LIB: Optional[ctypes.CDLL] = None
_PATH: Optional[Path] = None
_LOCK = threading.Lock()


def compiler() -> List[str]:
    """The C++ compiler's command: ``$CXX`` if set, else ``g++``."""
    return shlex.split(os.environ.get("CXX") or "g++")


def _cpuinfo(keys) -> Dict[str, str]:
    """The first value of each of ``keys`` in /proc/cpuinfo."""
    found: Dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in keys and key not in found:
                    found[key] = value.strip()
    except OSError:
        pass
    return found


def cpu_model() -> str:
    """The host's CPU as /proc/cpuinfo names it (vendor, family, model,
    model name; ``-march=native`` builds for it)."""
    info = _cpuinfo(("vendor_id", "cpu family", "model", "model name"))
    return " ".join(info.values()) or \
        f"{platform.machine()} {platform.processor()}"


def _compiler_output(*args: str) -> str:
    try:
        return subprocess.run(
            [*compiler(), *args], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(
            f"C++ compiler {' '.join(compiler())!r} not usable ({e}); "
            "set $CXX, or pass use_native_featurizer=False for the "
            "Python featurizer") from e


def library_path() -> Path:
    """``build/libpcp_native-<hash>.so`` of these sources, flags, compiler
    and CPU. The CPU enters three ways: its /proc/cpuinfo model, its
    instruction-set flags there, and the target the compiler resolves
    ``-march=native`` to (a virtualised /proc/cpuinfo may name no
    model)."""
    global _PATH
    if _PATH is None:
        digest = hashlib.sha1()
        for name in SOURCES:
            digest.update((SRC_DIR / name).read_bytes())
        digest.update(" ".join(CXX_FLAGS).encode())
        digest.update(_compiler_output("--version").encode())
        digest.update(cpu_model().encode())
        digest.update(_cpuinfo(("flags",)).get("flags", "").encode())
        digest.update(_compiler_output("-march=native", "-Q",
                                       "--help=target").encode())
        _PATH = BUILD_DIR / f"libpcp_native-{digest.hexdigest()[:12]}.so"
    return _PATH


def build() -> float:
    """Compile the library unless it is built. Returns the wall seconds
    spent (waiting for a concurrent build included); raises with the
    compiler's output when the build fails."""
    t0 = time.perf_counter()
    lib = library_path()
    if lib.exists():
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # one build at a time
        if not lib.exists():
            tmp = lib.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run(
                [*compiler(), *CXX_FLAGS, "-o", str(tmp),
                 str(SRC_DIR / SOURCES[0])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building {lib.name} failed:\n{proc.stdout}")
            os.replace(tmp, lib)
    return time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every entry point; a missing one raises."""
    P, c = ctypes.POINTER, ctypes.c_int
    f, i = P(ctypes.c_float), P(ctypes.c_int)
    u, strs = P(ctypes.c_ubyte), P(ctypes.c_char_p)
    batch = [strs, c, c, c, f, f, f, f, i, i, i, i]   # smiles .. a2mol
    tail = [u, i, c]                                  # valid, counts, threads
    count = [strs, c, i, i, c]
    signatures = {
        "pcp_featurize_batch": batch + tail,
        "pcp_featurize_batch_h": batch + tail + [c, c],
        "pcp_featurize_batch_full": batch + tail + [c, c, i],
        "pcp_featurize_polymer_batch": batch + [f] + tail,
        "pcp_featurize_polymer_batch_h": batch + [f] + tail + [c, c],
        "pcp_featurize_reaction_batch": batch + tail + [c, c, c],
        "pcp_featurize_reaction_batch_h": batch + tail + [c, c, c, c],
        "pcp_count": count,
        "pcp_count_h": count + [c, c],
        "pcp_count_polymer": count,
        "pcp_count_polymer_h": count + [c, c],
        "pcp_count_reaction": count + [c, c, c],
        "pcp_count_reaction_h": count + [c, c, c, c],
        "pcp_rdkit2d_batch": [strs, c, c, P(ctypes.c_double), u],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)    # AttributeError names a missing symbol
        fn.argtypes = argtypes
        fn.restype = c


def load() -> ctypes.CDLL:
    """The ctypes handle of the library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            _declare(lib)
            _LIB = lib
        return _LIB


def _c_strings(smiles: List[str]):
    arr = (ctypes.c_char_p * len(smiles))()
    arr[:] = [s.encode() for s in smiles]
    return arr


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def count_native(smiles: List[str], n_threads: int = 4, polymer: bool = False,
                 reaction_mode: Optional[str] = None, keep_h: bool = False,
                 add_h: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Per-molecule (n_atoms, n_bonds) counts; -1 marks invalid SMILES."""
    lib = load()
    atoms = np.zeros(len(smiles), np.int32)
    bonds = np.zeros(len(smiles), np.int32)
    base = [_c_strings(smiles), len(smiles), _ptr(atoms, ctypes.c_int),
            _ptr(bonds, ctypes.c_int), n_threads]
    if reaction_mode is not None:
        mode, balance = _RXN_MODE[reaction_mode]
        if add_h:
            lib.pcp_count_reaction_h(*base, mode, balance, int(keep_h), 1)
        else:
            lib.pcp_count_reaction(*base, mode, balance, int(keep_h))
    elif polymer and (keep_h or add_h):
        lib.pcp_count_polymer_h(*base, int(keep_h), int(add_h))
    elif polymer:
        lib.pcp_count_polymer(*base)
    elif keep_h or add_h:
        lib.pcp_count_h(*base, int(keep_h), int(add_h))
    else:
        lib.pcp_count(*base)
    return atoms, bonds


def featurize_batch_native(smiles: List[str], pad_atoms: int, pad_bonds: int,
                           pad_mols: Optional[int] = None,
                           n_threads: int = 4, polymer: bool = False,
                           reaction_mode: Optional[str] = None,
                           keep_h: bool = False, add_h: bool = False,
                           bond_parse_out: Optional[np.ndarray] = None):
    """SMILES list -> ``(GraphBatch, valid)``: standard molecules
    (optionally keeping explicit Hs / adding Hs), wD-MPNN polymer ensemble
    strings with ``polymer=True``, or atom-mapped reaction SMILES with
    ``reaction_mode`` set. ``valid`` (uint8, one per SMILES) flags what
    parsed; invalid molecules add no atoms and get ``mol_mask`` 0.
    ``bond_parse_out`` (int32, ``(pad_bonds,)``, standard molecules only)
    receives each directed bond's 1-based parse-order bond index (0 on
    padding), for gathering per-bond extra features."""
    from .features.batching import GraphBatch

    lib = load()
    n = len(smiles)
    M = pad_mols or n
    atom_w, bond_w = (165, 193) if reaction_mode is not None else (133, 147)
    f_atoms = np.zeros((pad_atoms, atom_w), np.float32)
    f_bonds = np.zeros((pad_bonds, bond_w), np.float32)
    w_atoms = np.zeros(pad_atoms, np.float32)
    w_bonds = np.zeros(pad_bonds, np.float32)
    b2a = np.zeros(pad_bonds, np.int32)
    b2dst = np.zeros(pad_bonds, np.int32)
    b2revb = np.zeros(pad_bonds, np.int32)
    a2mol = np.zeros(pad_atoms, np.int32)
    valid = np.zeros(n, np.uint8)
    counts = np.zeros(2, np.int32)
    fp, ip = ctypes.c_float, ctypes.c_int
    common = [_c_strings(smiles), n, pad_atoms, pad_bonds,
              _ptr(f_atoms, fp), _ptr(f_bonds, fp), _ptr(w_atoms, fp),
              _ptr(w_bonds, fp), _ptr(b2a, ip), _ptr(b2dst, ip),
              _ptr(b2revb, ip), _ptr(a2mol, ip)]
    tail = [_ptr(valid, ctypes.c_ubyte), _ptr(counts, ip), n_threads]
    degree_of_polym = np.ones(M, np.float32)
    if reaction_mode is not None:
        mode, balance = _RXN_MODE[reaction_mode]
        if add_h:
            rc = lib.pcp_featurize_reaction_batch_h(
                *common, *tail, mode, balance, int(keep_h), 1)
        else:
            rc = lib.pcp_featurize_reaction_batch(*common, *tail, mode,
                                                  balance, int(keep_h))
    elif polymer:
        dop = np.ones(n, np.float32)
        if keep_h or add_h:
            rc = lib.pcp_featurize_polymer_batch_h(
                *common, _ptr(dop, fp), *tail, int(keep_h), int(add_h))
        else:
            rc = lib.pcp_featurize_polymer_batch(*common, _ptr(dop, fp),
                                                 *tail)
        degree_of_polym[:n] = dop
    elif bond_parse_out is not None:
        if bond_parse_out.shape != (pad_bonds,) or \
                bond_parse_out.dtype != np.int32:
            raise ValueError("bond_parse_out must be int32 of shape "
                             f"({pad_bonds},)")
        rc = lib.pcp_featurize_batch_full(
            *common, *tail, int(keep_h), int(add_h),
            _ptr(bond_parse_out, ip))
    elif keep_h or add_h:
        rc = lib.pcp_featurize_batch_h(*common, *tail, int(keep_h),
                                       int(add_h))
    else:
        rc = lib.pcp_featurize_batch(*common, *tail)
    if rc != 0:
        raise ValueError("batch exceeds padding envelope (native)")
    mol_mask = np.zeros(M, np.float32)
    mol_mask[:n] = valid
    return GraphBatch(
        f_atoms=f_atoms, f_bonds=f_bonds, w_atoms=w_atoms, w_bonds=w_bonds,
        b2a=b2a, b2dst=b2dst, b2revb=b2revb, a2mol=a2mol,
        degree_of_polym=degree_of_polym, mol_mask=mol_mask,
        n_atoms_real=int(counts[0]), n_bonds_real=int(counts[1])), valid


def rdkit2d_batch_native(smiles: List[str], n_threads: int = 2
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The 200 raw rdkit_2d descriptors of each SMILES: ``(values (n, 200)
    float64, ok (n,) bool)``; rows with ``ok`` False did not parse."""
    lib = load()
    n = len(smiles)
    out = np.zeros((n, 200), np.float64)
    ok = np.zeros(n, np.uint8)
    lib.pcp_rdkit2d_batch(_c_strings(smiles), n, n_threads,
                          _ptr(out, ctypes.c_double),
                          _ptr(ok, ctypes.c_ubyte))
    return out, ok.astype(bool)
