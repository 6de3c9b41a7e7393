"""The probes' kernels and entry points vs the JAX package's probes.

* ``band_ctrl_plain`` (both modes, unit and polymer weights) against
  scripts/band_mxu_probe.py ``_ctrl_apply``, whose Pallas kernel runs in
  interpret mode, with the port's ranges derived from the JAX ``rs_rev``
  windows. Tolerance 1e-4 of max|JAX|: the TPU control runs at
  ``Precision.HIGH`` (3-pass bf16, about 1.5e-5 relative error) and the
  port in FP32.
* ``fused_matmul_plain`` against scripts/fused_matmul_probe.py
  ``_fused_kernel`` in a ``pallas_call`` (interpret mode) and against
  ``pallas_mpnn._dot_band`` at ``Precision.HIGH``. Tolerance 1e-5 of max:
  the same exact bf16 x bf16 products, summed in another order.
* ``split_bf16`` bit for bit against the JAX split.
* The probes' entry points on the CPU at a tiny size, and the wrappers on a
  device that is neither CPU nor CUDA.
* The shared-memory and scratch arithmetic that the Python side mirrors.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py. Nothing in
``scripts/`` is edited: it is put on ``sys.path`` to import the probes.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polymer_chemprop_tpu.features import mol2graph as jax_mol2graph
from polymer_chemprop_tpu.ops import pallas_mpnn as pm
from polymer_chemprop_tpu_torch.features import mol2graph
from polymer_chemprop_tpu_torch.ops import probe_kernels as pk
from polymer_chemprop_tpu_torch.ops.sorted_aux import build_sorted_aux
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from polymer_chemprop_tpu_torch.probes import (band_layer_probe,
                                               csr_rows_probe,
                                               fused_matmul_probe,
                                               stage_probe)
from polymer_chemprop_tpu_torch.probes.bench_batch import bench_smiles

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import band_mxu_probe  # noqa: E402
import fused_matmul_probe as jax_fused_probe  # noqa: E402
from test_torch_threads import torch_threads  # noqa: E402,F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_MOLECULES, PAD_BONDS = 40, 1536     # six distinct rs_rev windows
H, HP = 48, 128                       # port width, JAX lane padding


@pytest.fixture(scope="module")
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(scope="module")
def ctrl_batch():
    """The same molecules in both packages' sorted layouts."""
    smiles = bench_smiles(N_MOLECULES)
    kw = dict(pad_atoms=PAD_BONDS // 2, pad_bonds=PAD_BONDS,
              pad_mols=N_MOLECULES)
    jgb, gb = jax_mol2graph(smiles, **kw), mol2graph(smiles, **kw)
    assert (pk.TPU_TILE, pk.TPU_WINDOW) == (pm.TILE_B,
                                           pm._EXT_FOR[pm.TILE_B])
    jaux = pm.build_sorted_aux(jgb.b2dst, jgb.b2revb, jgb.w_bonds,
                               num_atoms=PAD_BONDS // 2)
    aux = build_sorted_aux(gb.b2dst, gb.b2revb, gb.w_bonds,
                           num_atoms=PAD_BONDS // 2)
    np.testing.assert_array_equal(aux.w_sorted, jaux.w_sorted)
    assert jaux.rs_rev is not None
    assert len(np.unique(jaux.rs_rev)) >= 2, jaux.rs_rev
    return jaux, aux


def _pad(a, rows, cols):
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))


@pytest.mark.parametrize("mode", ["noq", "pure"])
@pytest.mark.parametrize("weights", ["unit", "polymer"])
def test_band_ctrl_plain_matches_jax_control(interpret_mode, ctrl_batch,
                                             weights, mode):
    jaux, aux = ctrl_batch
    B = PAD_BONDS
    rng = np.random.default_rng(0)
    w = aux.w_sorted
    if weights == "polymer":
        # bf16-exact, as the control's w_exact=True assumes
        w = np.where(w > 0, rng.choice([0.25, 0.5, 0.75], w.shape),
                     0.0).astype(np.float32)
    m = rng.normal(size=(B, H)).astype(np.float32)
    inp = rng.normal(size=(B, H)).astype(np.float32)
    wh = (rng.normal(size=(H, H)) * 0.1).astype(np.float32)
    jaux_d = {k: jnp.asarray(v) for k, v in jaux._asdict().items()
              if v is not None}
    jaux_d["w_sorted"] = jnp.asarray(w)
    want = np.asarray(band_mxu_probe._ctrl_apply(
        jnp.asarray(_pad(m, B, HP)), jaux_d, jnp.asarray(_pad(wh, HP, HP)),
        jnp.asarray(_pad(inp, B, HP)), mode))[:, :H]
    lo, hi = pk.window_ranges(jaux.rs_rev, B)
    got = pk.band_ctrl(torch.from_numpy(m), torch.from_numpy(inp),
                       torch.from_numpy(wh), torch.from_numpy(w), lo, hi,
                       mode).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert pk.band_ctrl.launches == 0     # the CPU runs the plain version


def test_band_ctrl_plain_sums_each_blocks_range():
    """One row per block, the range's weighted sum; ragged last block."""
    rng = np.random.default_rng(1)
    B, Hs = 70, 5
    m = torch.from_numpy(rng.normal(size=(B, Hs)).astype(np.float32))
    w = torch.from_numpy(rng.choice([0.0, 0.5, 1.0], B).astype(np.float32))
    lo = torch.tensor([3, 0, 60], dtype=torch.int32)
    hi = torch.tensor([9, 0, 90], dtype=torch.int32)   # empty, past the end
    z = pk.band_ctrl_z_plain(m, w, lo, hi).numpy()
    mw = m.numpy() * w.numpy()[:, None]
    want = np.concatenate([np.repeat(mw[3:9].sum(0)[None], 32, 0),
                           np.zeros((32, Hs), np.float32),
                           np.repeat(mw[60:70].sum(0)[None], 6, 0)])
    np.testing.assert_allclose(z, want, rtol=1e-6, atol=1e-6)
    own_lo, own_hi = pk.own_row_ranges(B)
    assert own_lo.tolist() == [0, 32, 64] and own_hi.tolist() == [32, 64, 70]


def test_fused_matmul_plain_matches_jax_kernel_and_dot_band(interpret_mode):
    from jax.experimental import pallas as pl
    N, K, tile = 1024, 128, 512
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, K)).astype(np.float32)
    w = (rng.normal(size=(K, K)) * 0.05).astype(np.float32)
    w_hi = jnp.asarray(w, jnp.bfloat16)
    w_lo = (jnp.asarray(w) - w_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    fused = pl.pallas_call(
        jax_fused_probe._fused_kernel, grid=(N // tile,),
        in_specs=[pl.BlockSpec((tile, K), lambda j: (j, 0)),
                  pl.BlockSpec((K, K), lambda j: (0, 0)),
                  pl.BlockSpec((K, K), lambda j: (0, 0))],
        out_specs=pl.BlockSpec((tile, K), lambda j: (j, 0)),
        out_shape=jax.ShapeDtypeStruct((N, K), jnp.float32))
    want_kernel = np.asarray(fused(jnp.asarray(x), w_hi, w_lo))
    want_dot = np.asarray(pm._dot_band(jnp.asarray(x), jnp.asarray(w),
                                       jax.lax.Precision.HIGH, False))
    b_hi, b_lo = pk.split_bf16(torch.from_numpy(w))
    got = pk.fused_matmul(torch.from_numpy(x), b_hi, b_lo).numpy()
    for want in (want_kernel, want_dot):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert pk.fused_matmul.launches == 0


def test_split_bf16_is_the_jax_split_bit_for_bit():
    rng = np.random.default_rng(3)
    w = np.concatenate([
        rng.normal(size=4096) * scale for scale in (1e-30, 1e-3, 1.0, 1e20)]
        + [np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0,
                     -0.0, 3.0e38, 1e-40])]).astype(np.float32)
    hi, lo = pk.split_bf16(torch.from_numpy(w))
    j_hi = jnp.asarray(w).astype(jnp.bfloat16)
    j_lo = (jnp.asarray(w) - j_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    for got, want in ((hi, j_hi), (lo, j_lo)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def test_band_layer_probe_runs_on_the_cpu(capsys):
    out = band_layer_probe.main(["--device", "cpu", "--molecules", "16",
                                 "--hidden", "32", "--reps", "2",
                                 "--peak_n", "64"])
    printed = capsys.readouterr().out
    rows = ("full", "noq", "pure", "noq_plain", "library_same",
            "library_same_pure", "peak_fp32", "peak_tf32", "peak_bf16")
    assert tuple(out["rows"]) == rows
    for name in rows:
        assert f"\n{name} " in printed
        assert out["rows"][name]["ms"] > 0
        # a host time is never reported as a device rate
        assert "tflops" not in out["rows"][name]
    assert "TFLOP/s" not in printed and "host clock (cpu)" in printed
    assert "the layer's split (host ms)" in printed
    split = out["split"]
    assert sum(split.values()) == pytest.approx(out["rows"]["full"]["ms"])


def test_fused_matmul_probe_runs_on_the_cpu(capsys):
    out = fused_matmul_probe.main(["--device", "cpu", "--molecules", "16",
                                   "--hidden", "32", "--reps", "2",
                                   "--jax_rows", "256", "--jax_hidden", "48"])
    printed = capsys.readouterr().out
    assert (out["bench"]["N"], out["bench"]["H"]) == (512, 32)
    assert (out["jax_shape"]["N"], out["jax_shape"]["H"]) == (256, 48)
    for shape in out.values():
        assert tuple(shape["rows"]) == ("fused_matmul", "plain", "mm_fp32",
                                        "mm_tf32")
        err = shape["errors"]
        # on the CPU the wrapper is the plain version
        assert err["kernel_vs_plain"] == 0.0
        assert err["kernel_vs_fp64"] < 1e-4
        assert err["kernel_vs_fp64_split"] < 1e-6
    for name in ("fused_matmul", "plain", "mm_fp32", "mm_tf32"):
        assert f"\n{name} " in printed
    assert "TFLOP/s" not in printed


def test_probe_wrappers_raise_on_other_devices():
    m = torch.zeros((40, 8), device="meta")
    w = torch.zeros(40, device="meta")
    wh = torch.zeros((8, 8), device="meta")
    r = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.band_ctrl(m, m, wh, w, r, r, "noq")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.fused_matmul(m, wh.to(torch.bfloat16), wh.to(torch.bfloat16))
    # too wide for the block's shared memory, on any device
    wide, r_cpu = torch.zeros((40, 1496)), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        pk.band_ctrl(wide, wide, torch.zeros((1496, 1496)), torch.zeros(40),
                     r_cpu, r_cpu, "pure")
    with pytest.raises(ValueError, match="mode"):
        pk.band_ctrl(m, m, wh, w, r, r, "full")
    assert pk.launch_counts() == {"band_ctrl": 0, "fused_matmul": 0}


@pytest.mark.parametrize("probe", [band_layer_probe, fused_matmul_probe])
def test_probe_with_device_cuda_raises_without_a_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        probe.main(["--molecules", "4"])


@pytest.fixture(scope="module")
def csr_probe_out():
    return csr_rows_probe.main(["--device", "cpu", "--molecules", "16",
                                "--wide", "40", "--reps", "2"])


@pytest.mark.parametrize("kernel", csr_rows_probe.KERNELS)
def test_csr_rows_probe_runs_on_cpu(csr_probe_out, kernel):
    """The CSR-row probe's entry point on the CPU (plain versions, host
    clock): three shapes, their run-length histograms, the bytes each
    kernel must move, an output hash, no rate off the card; band_rev_bwd
    is not timed at the wide shape."""
    out = csr_probe_out
    assert set(out) == {"bench", "train", "wide"}
    assert (out["train"]["B"], out["train"]["A"]) == (1792, 768)
    for shape, row in out.items():
        hist = np.asarray(row["hist"])
        assert hist.sum() == row["A"]
        assert (np.arange(hist.shape[0]) * hist).sum() == row["n_real"]
        assert row["H"] == (40 if shape == "wide" else 300)
        if shape == "wide" and kernel in csr_rows_probe.NARROW_ONLY:
            assert kernel not in row
            continue
        r = row[kernel]
        assert r["ms"] > 0 and "gbps" not in r
        assert r["bytes"] == csr_rows_probe.kernel_bytes(
            kernel, row["B"], row["A"], row["H"], row["n_real"])
        assert len(r["sha256"]) == 64 and int(r["sha256"], 16) >= 0
        assert ("in_order" in r) == (kernel == "band_rev_bwd")


def test_readout_probe_runs_on_the_cpu(capsys):
    """The readout probe's entry point on the CPU (plain versions, host
    clock): both shapes, every use of the gather entry timed cold and warm
    beside its bytes bound and hashed; the molecule readout op equals its
    plain version's output, and 3a equals 3b at unit weights."""
    from polymer_chemprop_tpu_torch.probes import readout_probe
    out = readout_probe.main(["--device", "cpu", "--molecules", "16",
                              "--hidden", "32", "--reps", "2", "--warm",
                              "2"])
    printed = capsys.readouterr().out
    assert set(out) == {"bench", "train"}
    for shape, rows in out.items():
        assert set(rows) == {"mol gather", "mol op", "mol op+vjp",
                             "mol plain", "3a", "3b", "3b vjp",
                             "3a distinct"}
        for label, r in rows.items():
            assert r["cold"] > 0 and r["warm"] > 0 and r["bound_ms"] > 0
            assert len(r["sha256"]) == 64
            assert f"[readout] {shape:5s} {label:18s}" in printed
        assert rows["mol op"]["sha256"] == rows["mol plain"]["sha256"]
        assert rows["3a"]["sha256"] == rows["3b"]["sha256"]
    # the atom rows in the molecule CSR's runs, not the padded table
    assert readout_probe.readout_bytes(700, 50, 300) == 4 * (
        700 * 300 + 50 * 300 + 2 * 700 + 51 + 2 * 50) == 906204


def test_fp32_stage_fills_the_block_at_the_widest_fused_width():
    """The FP32 stage's shared memory (band_tile.cuh smem_bytes) is the
    card's whole 227 KiB opt-in at hidden 1,495, so the fused forms stop
    there."""
    assert bm.fused_layer_smem_bytes(1495) == 232448 == bm.SMEM_PER_BLOCK
    assert bm.fused_layer_fits(1495) and not bm.fused_layer_fits(1496)


@pytest.mark.parametrize("K, M, slices", [(300, 300, 5), (384, 384, 12),
                                          (300, 96, 5), (96, 300, 2),
                                          (33, 610, 3), (64, 304, 1),
                                          (65, 305, 4)])
def test_fused_matmul_scratch_holds_one_slice_per_pass_and_chunk(K, M,
                                                                slices):
    """Column passes of 304 by depth chunks of 64, each slice the hi and
    lo halves of 304 x 64 bf16 (csrc/fused_matmul.cu scratch_bytes)."""
    assert pk.fused_matmul_scratch_bytes(K, M) == slices * 2 * 2 * 304 * 64


def test_stage_probe_runs_on_the_cpu(capsys):
    """The stage probe's entry point on the CPU (plain versions, host
    clock): every row timed and hashed, z hashed where it is written and
    equal across precisions, and the wgmma stage's split."""
    out = stage_probe.main(["--device", "cpu", "--molecules", "16",
                            "--hidden", "32", "--reps", "2"])
    printed = capsys.readouterr().out
    rows = out["rows"]
    assert len(rows) == 3 * 5 + 3
    for name, row in rows.items():
        assert row["ms"] > 0 and len(row["sha256"]) == 64
        assert f"\n{name} " in printed
        assert ("z_sha256" in row) == (name.endswith("_z")
                                       or name.startswith("band_matmul "))
    for form in ("band_rev_layer", "band_matmul_act"):
        # z is the FP32 aggregation at every precision, and writing it
        # leaves the output as it is
        assert len({rows[f"{form} {p}_z"]["z_sha256"]
                    for p in stage_probe.PRECISIONS}) == 1
        for p in stage_probe.PRECISIONS:
            assert rows[f"{form} {p}"]["sha256"] \
                == rows[f"{form} {p}_z"]["sha256"]
    assert rows["band_matmul highest"]["z_sha256"] \
        == rows["band_matmul_act highest_z"]["z_sha256"]
    for form, split in out["split"].items():
        assert split["product"] == rows["fused_matmul"]["ms"]
        assert split["product"] + split["build_epilogue"] \
            == pytest.approx(rows[f"{form} high"]["ms"])
    assert "TFLOP/s" not in printed and "GB/s" not in printed
