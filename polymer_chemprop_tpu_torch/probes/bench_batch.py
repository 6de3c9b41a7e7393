"""The bench batch the probes and chip_smoke.py's kernel phase run on.

The port's copy of the JAX package's ``bench._load_batch`` (bench.py:56-80):
the first ``n_molecules`` of tests/data/regression.csv, repeated as often as
needed, featurized with the port's own ``features``. Padding is the port's
default: 1,024 molecules give B = 28,032 padded bonds and A = 13,696 atoms.
``bench._load_batch`` rounds both up to a multiple of 1,024 (B = 28,672) for
the TPU kernels' 256-row tiles; the CUDA kernels need no such alignment.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..features import GraphBatch, mol2graph
from ..ops.sorted_aux import SortedBondAux, build_sorted_aux

REGRESSION_CSV = (Path(__file__).resolve().parents[2] / "tests" / "data"
                  / "regression.csv")


def bench_smiles(n_molecules: int) -> List[str]:
    """The first ``n_molecules`` SMILES of regression.csv, repeated."""
    with open(REGRESSION_CSV) as f:
        smiles = [row[0] for row in csv.reader(f)][1:]
    return (smiles * (n_molecules // len(smiles) + 1))[:n_molecules]


def bench_batch(n_molecules: int = 1024) -> GraphBatch:
    """The featurized bench batch; prints the host's featurization time."""
    smiles = bench_smiles(n_molecules)
    t0 = time.perf_counter()
    gb = mol2graph(smiles)
    print(f"[host] featurized {len(smiles)} molecules in "
          f"{time.perf_counter() - t0:.3f} s (pure Python, one thread)",
          flush=True)
    return gb


def bench_aux(gb: GraphBatch,
              w_bonds: Optional[np.ndarray] = None) -> SortedBondAux:
    """The batch's dst-sorted layout (ops/sorted_aux.py), with its own bond
    weights unless ``w_bonds`` is given."""
    w = gb.w_bonds if w_bonds is None else w_bonds
    return build_sorted_aux(gb.b2dst, gb.b2revb, w,
                            num_atoms=gb.f_atoms.shape[0])
