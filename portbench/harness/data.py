"""Inputs of a cell, made by the benchmark: the molecule pools a
configuration names, the target scaling, the order of each pass over a
pool, and the weights of a model, all from ``--seed``. Nothing here
imports the program; the program and the reference are handed the same
inputs."""

from __future__ import annotations

import csv
import os
from random import Random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import eaip

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def _read_csv(names: Sequence[str], targets: Optional[Sequence[str]]):
    smiles, ys = [], []
    for name in names:
        with open(os.path.join(DATA_DIR, name), newline="") as f:
            for row in csv.DictReader(f):
                smiles.append(row["smiles"])
                if targets:
                    ys.append([float(row[t]) for t in targets])
    return smiles, (np.asarray(ys, np.float64) if targets else None)


def pool(config: dict, part: str) -> Tuple[List[str], Optional[np.ndarray]]:
    """``(smiles, targets)`` of a configuration's ``part`` ("train" or
    "library"): the copolymers of the frozen EA/IP generator, or the rows
    of the CSV files under ``portbench/data/`` that the configuration
    names. ``targets`` is ``(n, T)`` float64, or None for a library with
    no targets."""
    spec = config["dataset"]
    if spec.get("generator") == "eaip":
        rows = eaip.generate()
        return ([r[0] for r in rows],
                np.asarray([[r[1], r[2]] for r in rows], np.float64))
    part_spec = spec[part]
    return _read_csv(part_spec["csv"], part_spec.get("targets"))


def num_tasks(config: dict) -> int:
    spec = config["dataset"]
    if spec.get("generator") == "eaip":
        return len(spec["targets"])
    return len(spec["train"]["targets"])


def scaler_stats(config: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Means and standard deviations of the training targets (Chemprop
    scales regression targets by them, and a checkpoint carries them)."""
    _, y = pool(config, "train")
    return y.mean(0), y.std(0)


def passes(n: int, seed: int) -> Iterator[int]:
    """Indices into a pool of ``n``: pass after pass over the whole pool,
    each pass in its own order drawn from ``seed``. Every seed sees the
    same molecules, pass by pass, in another order."""
    rng = Random(seed)
    while True:
        order = list(range(n))
        rng.shuffle(order)
        yield from order


def leaf_seed(seed: int, member: int) -> int:
    """The generator seed of a model's weights: 64 bits from ``seed``
    (any whole number) and the ensemble member."""
    return (seed * 1000003 + member * 7919 + 12345) % (2 ** 63)


def make_weights(shapes: Sequence[tuple], seed: int, member: int,
                 device) -> List[torch.Tensor]:
    """Xavier-normal weights and zero biases (Chemprop nn_utils.py:102-112)
    of the given leaf shapes, drawn on ``device`` with one generator in one
    call and split."""
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, member))
    sizes = [int(np.prod(s)) for s in shapes if len(s) == 2]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    leaves, off = [], 0
    for s in shapes:
        if len(s) == 1:
            leaves.append(torch.zeros(s, device=device))
            continue
        n = s[0] * s[1]
        std = (2.0 / (s[0] + s[1])) ** 0.5
        leaves.append(flat[off:off + n].view(s).mul_(std))
        off += n
    return leaves


def jax_tree(leaves: Sequence[torch.Tensor], names: Sequence[str]) -> Dict:
    """Leaves in the layout of a checkpoint's parameter tree (host arrays):
    ``{"encoders": [{"W_i": {"w"}, "W_h": {"w"}, "W_o": {"w", "b"}}],
    "ffn": [{"w", "b"}, ...]}``."""
    enc: Dict = {}
    ffn: List[Dict] = []
    for name, leaf in zip(names, leaves):
        layer, kind = name.split(".")
        arr = leaf.detach().cpu().numpy()
        if layer.startswith("ffn"):
            j = int(layer[3:])
            while len(ffn) <= j:
                ffn.append({})
            ffn[j][kind] = arr
        else:
            enc.setdefault(layer, {})[kind] = arr
    return {"encoders": [enc], "ffn": ffn}
