"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
(with the headers ``csrc/*.cuh`` it may include) into
``build/lib<name>-<hash>.so`` at the repository root (``build/`` is
git-ignored), for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The hash is taken over the source, every header in ``csrc/`` and the
flags, so an edited kernel or header is rebuilt and a built one is reused.
Nothing here runs when the module is imported: the CPU tests import it on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
KERNELS = ("band_rev_layer", "band_rev_bwd", "atom_readout", "band_agg",
           "band_bwd", "band_matmul", "band_ctrl", "fused_matmul")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU, with the CUDA toolkit installed")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every stale kernel library, one ``nvcc`` per source, all
    started together. Returns the wall seconds spent; raises with the
    compiler's output when a build fails. Processes that share the
    checkout (the ranks of a launch, starting cold together) queue on one
    lock file, so each library is built once and the others find it."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "kernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_stale(names)
    return time.perf_counter() - t0


def _build_stale(names: Iterable[str]) -> None:
    procs: List[tuple] = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{output}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _declare(name, lib)
            _LIBS[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """argtypes/restype of each C entry point: every pointer and the stream
    as c_void_p (a bare Python int would be cut to 32 bits)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "band_rev_layer":
        lib.band_rev_layer_f32.argtypes = [p, p, p, p, p, p, p, p, p,
                                           i, i, i, p]
        lib.band_rev_layer_f32.restype = i
        lib.band_rev_layer_tc.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                          i, i, i, i, p]
        lib.band_rev_layer_tc.restype = i
        lib.band_rev_layer_smem_bytes.argtypes = [i]
        lib.band_rev_layer_smem_bytes.restype = ctypes.c_size_t
    elif name == "band_rev_bwd":
        lib.band_rev_bwd_f32.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.band_rev_bwd_f32.restype = i
    elif name == "atom_readout":
        lib.atom_readout_f32.argtypes = [p, p, p, p, i, i, p]
        lib.atom_readout_f32.restype = i
        lib.atom_gather_readout_f32.argtypes = [p, p, p, p, p, p, i, i, p]
        lib.atom_gather_readout_f32.restype = i
        lib.molecule_readout_f32.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                             ctypes.c_float, p]
        lib.molecule_readout_f32.restype = i
    elif name == "band_agg":
        lib.band_agg_f32.argtypes = [p, p, p, p, i, i, i, p]
        lib.band_agg_f32.restype = i
    elif name == "band_bwd":
        lib.band_bwd_f32.argtypes = [p, p, p, p, i, i, i, p]
        lib.band_bwd_f32.restype = i
    elif name == "band_matmul":
        lib.band_matmul_act_f32.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, i, p]
        lib.band_matmul_act_f32.restype = i
        lib.band_matmul_f32.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.band_matmul_f32.restype = i
        lib.band_matmul_smem_bytes.argtypes = [i]
        lib.band_matmul_smem_bytes.restype = ctypes.c_size_t
        lib.band_matmul_act_tc.argtypes = [p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, p]
        lib.band_matmul_act_tc.restype = i
        lib.band_matmul_tc.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.band_matmul_tc.restype = i
        lib.band_matmul_tc_smem_bytes.argtypes = []
        lib.band_matmul_tc_smem_bytes.restype = ctypes.c_size_t
        lib.band_matmul_tc_scratch_bytes.argtypes = [i]
        lib.band_matmul_tc_scratch_bytes.restype = ctypes.c_size_t
    elif name == "band_ctrl":
        lib.band_ctrl_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.band_ctrl_f32.restype = i
    elif name == "fused_matmul":
        lib.fused_matmul_f32.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.fused_matmul_f32.restype = i
        lib.fused_matmul_scratch_bytes.argtypes = [i, i]
        lib.fused_matmul_scratch_bytes.restype = ctypes.c_size_t
    else:
        raise ValueError(f"unknown kernel library {name!r}")
