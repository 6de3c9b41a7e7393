#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (polymer_chemprop_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100 (Hopper) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Print the card (``nvidia-smi`` name and power limit, torch's device
   name) and build every CUDA kernel with ``nvcc`` (one process per
   source, started together).
2. Hold each kernel against its plain PyTorch version on the card, on a
   featurized batch of 1024 molecules (about 28k dst-sorted bonds) at
   hidden 300, with unit and polymer (0.25/0.5/0.75) bond weights and
   several activations. Tolerance: FP32 with another summation order, so
   max|kernel - plain| <= 1e-5 * max|plain| + 1e-6. Time kernel, plain
   version and a PyTorch library yardstick with CUDA events, each launch
   after an L2 flush, and compute each kernel's bound from this batch.
3. Main path: write full-width checkpoints (hidden 300, depth 3, FFN
   2 x 300, seeded random weights) in the JAX package's ``.ckpt`` format,
   one for regression and one for polymer regression, and run the port's
   ``make_predictions`` on the card on tests/data/regression.csv (500
   molecules) and on 200 synthetic copolymer strings, timing each run end
   to end (host featurization included). The kernels' launch
   counts must equal (depth - 1) x batches and batches; the predictions
   must be finite and match the same run on the CPU (plain versions)
   within rtol 1e-4, atol 1e-5 (FP32 through five layers, sums in another
   order on each side).

The second-to-last line of output is a JSON object with each kernel's
numbers; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")   # git-ignored
HIDDEN, DEPTH, SEED = 300, 3, 0
BATCH_SIZE = 50          # the predict CLI's default
N_POLYMERS = 200
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): FP32 without
# tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def kernel_tolerance(ref: torch.Tensor) -> float:
    return 1e-5 * ref.abs().max().item() + 1e-6


# -- phase 1 ----------------------------------------------------------------

def card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from polymer_chemprop_tpu_torch.kernels import build
    seconds = build.build()
    log(f"[build] {len(build.KERNELS)} kernels built in {seconds:.2f} s")
    return card


# -- phase 2 ----------------------------------------------------------------

def read_smiles(path):
    import csv
    with open(path) as f:
        return [row[0] for row in csv.reader(f)][1:]


def bench_batch():
    """1024 molecules from regression.csv (repeated), dst-sorted."""
    from polymer_chemprop_tpu_torch.features import mol2graph
    smiles = read_smiles(os.path.join(ROOT, "tests", "data",
                                      "regression.csv"))
    smiles = (smiles * 3)[:1024]
    t0 = time.perf_counter()
    gb = mol2graph(smiles)
    log(f"[host] featurized {len(smiles)} molecules in "
        f"{time.perf_counter() - t0:.3f} s (pure Python, one thread)")
    return gb


def timed_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median device time of one call, each after an L2 flush."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev):
    from polymer_chemprop_tpu_torch.models.nn import get_activation
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.ops.sorted_aux import build_sorted_aux

    gb = bench_batch()
    A, B = gb.f_atoms.shape[0], gb.f_bonds.shape[0]
    H = HIDDEN
    rng = np.random.default_rng(SEED)
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)   # > 50 MB of L2
    results = {}
    for weights in ("unit", "polymer"):
        w = gb.w_bonds
        if weights == "polymer":
            w = np.where(w > 0, rng.choice([0.25, 0.5, 0.75], w.shape),
                         0.0).astype(np.float32)
        aux = build_sorted_aux(gb.b2dst, gb.b2revb, w, num_atoms=A)
        n_real = int(aux.rowptr[-1])
        real = np.zeros((B, 1), np.float32)
        real[:n_real] = 1.0
        T = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
        m = T(rng.normal(size=(B, H)).astype(np.float32) * real)
        inp = T(rng.normal(size=(B, H)).astype(np.float32) * real)
        wh = T((rng.normal(size=(H, H)) * (2.0 / (2 * H)) ** 0.5)
               .astype(np.float32))
        ws, src, srev, rp = (T(aux.w_sorted), T(aux.src_sorted),
                             T(aux.srev), T(aux.rowptr))
        dst = T(aux.dst_sorted.astype(np.int64))
        for act in ("relu", "tanh", "selu"):
            got = bm.band_rev_layer(m, inp, wh, ws, src, srev, rp, act)
            ref = bm.band_rev_layer_plain(m, inp, wh, ws, src, srev, rp, act)
            torch.cuda.synchronize()
            err, tol = (got - ref).abs().max().item(), kernel_tolerance(ref)
            pad_max = got[n_real:].abs().max().item() if n_real < B else 0.0
            log(f"[kernel] band_rev_layer {weights} {act}: max_abs_err "
                f"{err:.3e} (tol {tol:.3e}), padding rows max {pad_max}")
            check(err <= tol, "band_rev_layer disagrees with its plain version")
            check(pad_max == 0.0, "padding rows must stay exactly zero")
            results.setdefault("band_rev_layer", {"max_abs_err": 0.0})
            r = results["band_rev_layer"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
        got = bm.atom_readout(m, ws, rp)
        ref = bm.atom_readout_plain(m, ws, rp)
        torch.cuda.synchronize()
        err, tol = (got - ref).abs().max().item(), kernel_tolerance(ref)
        log(f"[kernel] atom_readout {weights}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        check(err <= tol, "atom_readout disagrees with its plain version")
        results.setdefault("atom_readout", {"max_abs_err": 0.0})
        r = results["atom_readout"]
        r["max_abs_err"] = max(r["max_abs_err"], err)

        if weights != "unit":
            continue
        # timings and bounds at the bench shape, relu, unit weights
        relu = get_activation("relu")

        def library_layer():
            a = m.new_zeros((A, H)).index_add_(0, dst, m * ws[:, None])
            z = a[src.long()] - m[srev.long()]
            return relu(torch.addmm(inp, z, wh))

        def library_readout():
            return m.new_zeros((A, H)).index_add_(0, dst, m * ws[:, None])

        run_len = (aux.rowptr[aux.src_sorted + 1]
                   - aux.rowptr[aux.src_sorted]).astype(np.int64).sum()
        b_bytes = 4 * (3 * B * H + H * H + 3 * B + (A + 1))
        b_ops = 2 * B * H * H + 2 * int(run_len) * H + B * H
        r_bytes = 4 * (n_real * H + n_real + A * H + (A + 1))
        r_ops = 2 * n_real * H
        for name, kern, plain, lib, nbytes, ops in (
                ("band_rev_layer",
                 lambda: bm.band_rev_layer(m, inp, wh, ws, src, srev, rp,
                                           "relu"),
                 lambda: bm.band_rev_layer_plain(m, inp, wh, ws, src, srev,
                                                 rp, "relu"),
                 library_layer, b_bytes, b_ops),
                ("atom_readout", lambda: bm.atom_readout(m, ws, rp),
                 lambda: bm.atom_readout_plain(m, ws, rp),
                 library_readout, r_bytes, r_ops)):
            r = results[name]
            r["ms"] = timed_ms(kern, flush)
            r["plain_ms"] = timed_ms(plain, flush)
            r["library_ms"] = timed_ms(lib, flush)
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
            log(f"[time] {name} at B={B} A={A} H={H}: kernel_ms "
                f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
                f"({r['bound_by']}: {nbytes} bytes, {ops} operations)")
    return results, B, A


# -- phase 3 ----------------------------------------------------------------

def write_checkpoint(path, polymer: bool):
    """A full-width checkpoint in the JAX package's .ckpt format, from
    seeded numpy weights (Xavier-normal, as the JAX init draws them)."""
    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.data import StandardScaler
    from polymer_chemprop_tpu_torch.features import FeaturizationConfig
    from polymer_chemprop_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(SEED + (1 if polymer else 0))

    def linear(i, o, bias=True):
        p = {"w": (rng.normal(size=(i, o)) * (2.0 / (i + o)) ** 0.5)
             .astype(np.float32)}
        if bias:
            p["b"] = (rng.normal(size=(o,)) * 0.01).astype(np.float32)
        return p

    fc = FeaturizationConfig(polymer=polymer)
    H = HIDDEN
    params = {
        "encoders": [{"W_i": linear(fc.bond_fdim(), H, bias=False),
                      "W_h": linear(H, H, bias=False),
                      "W_o": linear(fc.atom_fdim + H, H)}],
        "ffn": [linear(H, H), linear(H, 1)],
    }
    tcfg = TrainConfig(hidden_size=H, depth=DEPTH, ffn_num_layers=2,
                       ffn_hidden_size=H, polymer=polymer,
                       target_columns=["target"], seed=SEED)
    scaler = StandardScaler(np.array([0.0]), np.array([2.0]))
    save_checkpoint(path, params, tcfg.to_dict(),
                    scalers={"data_scaler": scaler})


def polymer_csv(path):
    """Synthetic copolymer ensemble strings as in
    tests/test_integration.py:71-82."""
    rng = np.random.default_rng(SEED)
    mons = ["[*:1]CC[*:2]", "[*:1]c1ccc([*:2])cc1", "[*:1]CO[*:2]",
            "[*:1]C(C)C[*:2]", "[*:1]c1ccc([*:2])cc1C"]
    rows = ["smiles"]
    for _ in range(N_POLYMERS):
        m1, m2 = rng.choice(mons, 2, replace=False)
        m2 = m2.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
        w = rng.choice([0.25, 0.5, 0.75])
        rows.append(f'"{m1}.{m2}|{w}|{1 - w}|'
                    f'<1-3:0.5:0.5<2-4:0.5:0.5~{rng.integers(2, 200)}"')
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def main_path(card):
    from polymer_chemprop_tpu_torch.config import PredictConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = []
    reg_ckpt = os.path.join(OUT_DIR, "regression", "model.ckpt")
    write_checkpoint(reg_ckpt, polymer=False)
    jobs.append(("regression", os.path.join(ROOT, "tests", "data",
                                            "regression.csv"), reg_ckpt))
    poly_ckpt = os.path.join(OUT_DIR, "polymer", "model.ckpt")
    write_checkpoint(poly_ckpt, polymer=True)
    poly_csv = os.path.join(OUT_DIR, "polymers.csv")
    polymer_csv(poly_csv)
    jobs.append(("polymer", poly_csv, poly_ckpt))

    launches = {"band_rev_layer": 0, "atom_readout": 0}
    for name, test_path, ckpt in jobs:
        def run(device, tag):
            return np.asarray(make_predictions(PredictConfig(
                test_path=test_path, checkpoint_path=ckpt,
                preds_path=os.path.join(OUT_DIR, f"{name}_{tag}.csv"),
                batch_size=BATCH_SIZE, num_workers=4, device=device)),
                dtype=float)

        bm.reset_launch_counts()
        t0 = time.perf_counter()
        got = run("cuda", "gpu")          # cold: featurization included
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = bm.launch_counts()
        n = got.shape[0]
        batches = math.ceil(n / BATCH_SIZE)
        log(f"[main] {name}: {n} molecules, {batches} batches, launches "
            f"{counts}, {n / seconds:.1f} molecules/s end to end "
            f"({seconds:.3f} s, featurization included) on {card}")
        want = run("cpu", "cpu")          # the plain versions on the CPU
        check(counts["band_rev_layer"] == (DEPTH - 1) * batches, counts)
        check(counts["atom_readout"] == batches, counts)
        for k in launches:
            launches[k] += counts[k]
        check(got.shape == want.shape == (n, 1), (got.shape, want.shape))
        check(np.isfinite(got).all(), "non-finite predictions")
        err = np.abs(got - want).max()
        log(f"[main] {name}: max |gpu - cpu| {err:.3e}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return launches


def main() -> int:
    # the synthetic edge rules (as in the integration tests) sum to 0.5
    warnings.filterwarnings("ignore", message="sum of weights of incoming")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available; this script runs only "
              "on the GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    card = card_and_build()
    results, B, A = kernel_phase(dev)
    launches = main_path(card)
    sources = {
        "band_rev_layer": ("polymer_chemprop_tpu_torch/csrc/band_rev_layer.cu",
                           "polymer_chemprop_tpu/ops/pallas_mpnn.py:1009"),
        "atom_readout": ("polymer_chemprop_tpu_torch/csrc/atom_readout.cu",
                         "polymer_chemprop_tpu/ops/pallas_mpnn.py:1278"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"(kernel shape B={B} A={A} H={HIDDEN})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
