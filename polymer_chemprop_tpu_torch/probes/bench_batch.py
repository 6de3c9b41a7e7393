"""The bench batch the probes and chip_smoke.py's kernel phase run on, and
the synthetic copolymers they serve and train on.

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


def copolymer_csv(path, n: int = 200, seed: int = 0,
                  with_target: bool = False) -> None:
    """``n`` synthetic copolymer ensemble strings as in
    tests/test_integration.py:71-82 (two of five monomers, weights 0.25 /
    0.5 / 0.75, Xn from 2 to 199) into a CSV at ``path``; ``with_target``
    adds a column that depends on composition and chain length, to train
    on."""
    rng = np.random.default_rng(seed)
    mons = ["[*:1]CC[*:2]", "[*:1]c1ccc([*:2])cc1", "[*:1]CO[*:2]",
            "[*:1]C(C)C[*:2]", "[*:1]c1ccc([*:2])cc1C"]
    rows = ["smiles,target" if with_target else "smiles"]
    for _ in range(n):
        i1, i2 = rng.choice(len(mons), 2, replace=False)
        m1 = mons[i1]
        m2 = mons[i2].replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
        w = rng.choice([0.25, 0.5, 0.75])
        xn = rng.integers(2, 200)
        row = f'"{m1}.{m2}|{w}|{1 - w}|<1-3:0.5:0.5<2-4:0.5:0.5~{xn}"'
        if with_target:
            row += f",{w * i1 + (1 - w) * i2 + 0.5 * np.log10(xn):.4f}"
        rows.append(row)
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
