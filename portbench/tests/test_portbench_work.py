"""The yardstick's operation and byte counts against hand counts."""

from __future__ import annotations

import json
import os

from conftest import BENCH
from portbench.harness import work

CFG = {"hidden_size": 4, "ffn_hidden_size": 3, "depth": 3,
       "ffn_num_layers": 3}


def test_linear_flops_by_hand():
    # 1 molecule, 2 atoms, 2 directed bonds; atom_fdim 5, bond_fdim 7,
    # one task. W_i: 2 bonds x 7 x 4; W_h: 2 updates x 2 bonds x 4 x 4;
    # W_o: 2 atoms x (5 + 4) x 4; FFN: 4x3 + 3x3 + 3x1
    macs = 2 * 7 * 4 + 2 * 2 * 4 * 4 + 2 * 9 * 4 + (12 + 9 + 3)
    assert work.linear_flops(CFG, 5, 7, 1, 1, 2, 2) == 2 * macs


def test_aggregation_flops_by_hand():
    # two updates of 3 ops a bond element, the atom readout's fma a bond
    # element, the molecule readout's fma an atom element, 3 a molecule
    want = 2 * 3 * 2 * 4 + 2 * 2 * 4 + 2 * 2 * 4 + 3 * 1 * 4
    assert work.aggregation_flops(CFG, 1, 2, 2) == want


def test_unit_flops_training_triples_the_linear_layers():
    lin = work.linear_flops(CFG, 5, 7, 1, 1, 2, 2)
    agg = work.aggregation_flops(CFG, 1, 2, 2)
    assert work.unit_flops(CFG, 5, 7, 1, (1, 2, 2), True) == 3 * lin + 2 * agg
    assert work.unit_flops(CFG, 5, 7, 1, (1, 2, 2), False) == lin + agg


def _kernel(name: str, metric: str = "mp_kernel_roofline.train") -> dict:
    with open(os.path.join(BENCH, "metrics", metric, "kernels",
                           name + ".json")) as f:
        return json.load(f)


def test_kernel_bytes_by_hand():
    H, M, A, B = 8, 2, 5, 12
    # band_agg: m and z (B, H), w (B,), rowptr (A + 1,), float32
    agg = work.kernel_work(_kernel("band_agg"), H, M, A, B)
    assert agg["bytes"] == 4 * (2 * B * H + B + A + 1)
    assert agg["ops"] == 3 * B * H and agg["peak"] == work.PEAK_FP32_FLOPS
    assert work.kernel_work(_kernel("band_bwd"), H, M, A, B)["ops"] == \
        3 * B * H
    # atom readout: the bond rows and weights read, (A, H) written, rowptr
    assert work.kernel_work(_kernel("atom_readout"), H, M, A, B)["bytes"] \
        == 4 * (B * H + B + A * H + A + 1)
    # molecule readout: atom rows, index and weight, (M, H) out, rowptr,
    # the denominator and the degree of polymerisation
    w = work.kernel_work(_kernel("molecule_readout"), H, M, A, B)
    assert w["bytes"] == 4 * (A * H + M * H + 2 * A + M + 1 + 2 * M)
    assert w["ops"] == 2 * A * H + 3 * M * H
    # the updates' kernels run depth - 1 times a unit, the readouts once
    assert work.kernel_calls(_kernel("band_agg"), 6) == 5
    assert work.kernel_calls(_kernel("band_bwd"), 6) == 5
    assert work.kernel_calls(_kernel("molecule_readout"), 6) == 1


def test_kernel_files_of_both_rooflines_agree():
    for name in ("atom_readout", "band_agg", "molecule_readout"):
        assert _kernel(name) == _kernel(name, "mp_kernel_roofline.screen")


def test_least_seconds_takes_the_slower_bound():
    w = {"bytes": 3.35e12, "ops": 1.0, "peak": 67e12}
    assert work.least_seconds(w) == 1.0
    w = {"bytes": 1.0, "ops": 134e12, "peak": 67e12}
    assert work.least_seconds(w) == 2.0


class _Trace:
    device = True

    def __init__(self, launches):
        self.launches = launches

    def kernel_seconds(self, match):
        return 1e-3, self.launches[match[0]]


class _Units(list):
    @property
    def counts(self):
        return list(self)


class _Rec:
    cfg = {"hidden_size": 8, "depth": 3}

    def __init__(self, launches):
        self.trace = _Trace(launches)
        self.units = _Units([(2, 5, 12), (1, 4, 10)])


def test_roofline_counts_every_listed_kernel_or_none(capsys):
    """With each kernel's launches as listed the reading counts them all;
    one kernel off by a launch (fused, split, off the path) leaves the
    metric unread and names the kernel."""
    from portbench.harness import readings
    kernels = os.path.join(BENCH, "metrics", "mp_kernel_roofline.screen",
                           "kernels")
    sound = {"atom_readout_kernel": 2, "band_agg_kernel": 4}
    value = readings.kernel_roofline(_Rec(sound), kernels)
    least = sum(
        work.kernel_calls(_kernel(k, "mp_kernel_roofline.screen"), 3)
        * work.least_seconds(work.kernel_work(
            _kernel(k, "mp_kernel_roofline.screen"), 8, *c))
        for k in ("atom_readout", "band_agg", "molecule_readout")
        for c in [(2, 5, 12), (1, 4, 10)])
    # the two readouts share the matched name, so 3 x 1 ms of device time
    assert value == 100.0 * least / 3e-3
    off = dict(sound, band_agg_kernel=3)
    assert readings.kernel_roofline(_Rec(off), kernels) is None
    assert "band_agg.json" in capsys.readouterr().err
