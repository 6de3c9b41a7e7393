"""The inputs are a function of the seed: the library's passes, the
sampler's epochs and the weights."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from portbench.harness import data
from portbench.reference import model as ref


def _take(it, n):
    return list(itertools.islice(it, n))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 77, -5])
def test_passes_follow_the_seed(seed):
    a = _take(data.passes(50, seed), 200)
    b = _take(data.passes(50, seed), 200)
    c = _take(data.passes(50, seed + 1), 200)
    assert a == b and a != c
    for k in range(4):      # every pass holds the whole pool once
        assert sorted(a[50 * k:50 * (k + 1)]) == list(range(50))


def test_epoch_orders_follow_the_seed():
    a = ref.epoch_orders(30, 2 ** 31 + 1, 3)
    assert a == ref.epoch_orders(30, 2 ** 31 + 1, 3)
    assert a != ref.epoch_orders(30, 2 ** 31 + 2, 3)
    assert all(sorted(o) == list(range(30)) for o in a)


def test_weights_follow_the_seed():
    shapes = [(6, 4), (4, 4), (4,)]
    a = data.make_weights(shapes, 2 ** 31 + 3, 0, torch.device("cpu"))
    b = data.make_weights(shapes, 2 ** 31 + 3, 0, torch.device("cpu"))
    c = data.make_weights(shapes, 2 ** 31 + 3, 1, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert [tuple(x.shape) for x in a] == shapes
    assert torch.count_nonzero(a[2]) == 0


def test_xavier_scale():
    w = data.make_weights([(400, 600)], 11, 0, torch.device("cpu"))[0]
    assert abs(float(w.std()) - (2.0 / 1000) ** 0.5) < 0.002


def test_pools():
    import json
    import os
    from conftest import BENCH
    sizes = {}
    for name in ("wdmpnn_h2400_d6", "dmpnn_h2400_d6"):
        with open(os.path.join(BENCH, "configs", name + ".json")) as f:
            cfg = json.load(f)
        smiles, y = data.pool(cfg, "train")
        lib, _ = data.pool(cfg, "library")
        sizes[name] = (len(smiles), y.shape, len(lib))
        means, stds = data.scaler_stats(cfg)
        assert np.all(stds > 0)
    assert sizes["wdmpnn_h2400_d6"] == (972, (972, 2), 972)
    assert sizes["dmpnn_h2400_d6"][:2] == (500, (500, 1))
    assert sizes["dmpnn_h2400_d6"][2] >= 999
