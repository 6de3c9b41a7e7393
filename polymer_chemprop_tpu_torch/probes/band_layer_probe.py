"""Where the band layer's time goes on the card: the layer against its
control, at the bench shape.

The port's counterpart of the JAX package's two MXU probes,
scripts/band_mxu_probe.py and scripts/band_mxu_probe2.py. Rows, each timed
with CUDA events after an L2 flush (:mod:`.timing`), operands built before
any timed region:

* ``full``: the layer, :func:`~..ops.band_mpnn.band_rev_layer`
  (csrc/band_rev_layer.cu), ``relu(inp + z @ W_h)`` with the CSR z build;
* ``noq``: the control, :func:`~..ops.probe_kernels.band_ctrl`
  (csrc/band_ctrl.cu), with each 32-row block's range its own rows: the
  same grid, product stage and epilogue, no rowptr/src/srev reads and no
  data-dependent loop;
* ``pure``: the control without the epilogue, ``out = z @ W_h``;
* ``noq_plain``: the control's plain PyTorch version (the ``noq`` row's
  arithmetic in torch ops; no yardstick of speed);
* ``library_same`` and ``library_same_pure``: cuBLAS FP32 (TF32 off) at
  the same shapes, ``relu(addmm(inp, z, W_h))`` and ``mm(z, W_h)``;
* ``peak_fp32``, ``peak_tf32``, ``peak_bf16``: cuBLAS ``torch.mm`` at
  ``--peak_n`` cubed (4,096), the calibration rows. Library calls, timed
  only.

It prints each row's ms, TFLOP/s and share of the H100 SXM data-sheet
peak for its type (FP32 67, TF32 495, bf16 989 TFLOP/s dense), and the
layer's split: build = full - noq, epilogue = noq - pure, product = pure.
The layer rows count the ``2 B H^2`` operations of ``z @ W_h``.

    python -m polymer_chemprop_tpu_torch.probes.band_layer_probe \\
        [--device cuda|cpu] [--molecules 1024] [--hidden 300] [--reps 20]

With ``--device cpu`` the rows run their plain versions under a host clock
(for tests); their times are host times and no rate or peak share is
printed.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..features import GraphBatch
from ..ops import band_mpnn as bm
from ..ops import probe_kernels as pk
from ..train.predict import resolve_device
from .bench_batch import bench_aux, bench_batch
from .timing import flush_buffer, timed_ms

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--molecules", type=int, default=1024)
    p.add_argument("--hidden", type=int, default=300)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--peak_n", type=int, default=4096,
                   help="side of the calibration products")
    return p.parse_args(argv)


def report(name: str, ms: float, ops: float, kind: str, on_card: bool
           ) -> dict:
    """One printed row; rate and peak share only for a device time."""
    row = {"ms": ms, "ops": ops, "type": kind}
    if on_card:
        row["tflops"] = ops / ms * 1e-9
        row["peak_share"] = ops / ms * 1e3 / PEAK_FLOPS[kind]
        print(f"{name:18s} {ms:9.4f} ms {row['tflops']:8.2f} TFLOP/s "
              f"{100 * row['peak_share']:6.2f}% of {kind} peak", flush=True)
    else:
        print(f"{name:18s} {ms:9.4f} ms host clock (cpu)", flush=True)
    return row


def main(argv: Optional[Sequence[str]] = None,
         batch: Optional[GraphBatch] = None) -> dict:
    """Runs the probe and returns ``{"B", "H", "rows", "split"}``;
    ``batch`` replaces the featurized bench batch (chip_smoke.py passes
    its own)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    gb = batch if batch is not None else bench_batch(args.molecules)
    aux = bench_aux(gb)
    B, H = gb.f_bonds.shape[0], args.hidden
    rng = np.random.default_rng(SEED)
    T = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    m = T(rng.normal(size=(B, H)).astype(np.float32))
    inp = T(rng.normal(size=(B, H)).astype(np.float32))
    wh = T((rng.normal(size=(H, H)) * 0.05).astype(np.float32))
    ws, src, srev, rp = (T(aux.w_sorted), T(aux.src_sorted), T(aux.srev),
                         T(aux.rowptr))
    lo, hi = pk.own_row_ranges(B, dev)
    z = pk.band_ctrl_z_plain(m, ws, lo, hi)
    flush = flush_buffer(dev)
    clock = "device" if on_card else "host"
    print(f"[probe] band layer at B={B} H={H} on {dev} ({clock} times, "
          f"median of {args.reps})", flush=True)

    layer_ops = 2.0 * B * H * H
    rows = {}
    with pk.float32_matmul_precision("highest"):
        for name, fn in (
                ("full", lambda: bm.band_rev_layer(m, inp, wh, ws, src, srev,
                                                   rp, "relu")),
                ("noq", lambda: pk.band_ctrl(m, inp, wh, ws, lo, hi, "noq")),
                ("pure", lambda: pk.band_ctrl(m, None, wh, ws, lo, hi,
                                              "pure")),
                ("noq_plain", lambda: pk.band_ctrl_plain(m, inp, wh, ws, lo,
                                                         hi, "noq")),
                ("library_same",
                 lambda: torch.relu(torch.addmm(inp, z, wh))),
                ("library_same_pure", lambda: torch.mm(z, wh))):
            ms = timed_ms(f"band layer {name}", fn, flush, args.reps)
            rows[name] = report(name, ms, layer_ops, "fp32", on_card)

    n = args.peak_n
    gen = torch.Generator(dev).manual_seed(SEED)
    a = torch.randn((n, n), device=dev, generator=gen)
    b = torch.randn((n, n), device=dev, generator=gen)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    for name, kind, level, x, y in (
            ("peak_fp32", "fp32", "highest", a, b),
            ("peak_tf32", "tf32", "high", a, b),
            ("peak_bf16", "bf16", "highest", a16, b16)):
        with pk.float32_matmul_precision(level):
            ms = timed_ms(f"{name} mm at {n}^3", lambda: torch.mm(x, y),
                          flush, args.reps)
        rows[name] = report(name, ms, 2.0 * n ** 3, kind, on_card)

    full, noq, pure = (rows[k]["ms"] for k in ("full", "noq", "pure"))
    split = {"build": full - noq, "epilogue": noq - pure, "product": pure}
    print("[probe] the layer's split ({} ms): ".format(clock) + ", ".join(
        f"{k} {v:.4f} ms ({100 * v / full:.1f}%)" for k, v in split.items())
        + f", full {full:.4f} ms", flush=True)
    return {"B": B, "H": H, "device": str(dev), "rows": rows, "split": split}


if __name__ == "__main__":
    main()
