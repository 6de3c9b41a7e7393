"""Does a split-bf16 product on the tensor cores beat FP32 at the band
layer's shape, and is it accurate enough?

The port's counterpart of the JAX package's scripts/fused_matmul_probe.py.
First the check: the max error, relative to the largest entry, of
:func:`~..ops.probe_kernels.fused_matmul` (csrc/fused_matmul.cu, three
bf16 passes on the tensor cores) against its plain version, and of both
against an FP64 product of the float32 operands (the function the split
approximates) and of the split operands (the split's own exact value). Then
the time (CUDA events after an L2 flush, :mod:`.timing`) of the kernel, of
its plain version, of cuBLAS ``torch.mm`` in FP32 (TF32 off) and of
``torch.mm`` with TF32 on, at (B, H) x (H, H) with B the bench batch's
padded bonds, and once more at the JAX probe's own shape (28,672, 384) x
(384, 384). The kernel's rate counts its three passes against the bf16
tensor-core peak (989 TFLOP/s, H100 SXM data sheet, dense); the FP32 and
TF32 rows count one product against 67 and 495 TFLOP/s.

    python -m polymer_chemprop_tpu_torch.probes.fused_matmul_probe \\
        [--device cuda|cpu] [--molecules 1024] [--hidden 300] [--reps 20]

With ``--device cpu`` the kernel row runs its plain version under a host
clock (for tests); no rate or peak share is printed.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..features import GraphBatch
from ..ops import probe_kernels as pk
from ..train.predict import resolve_device
from .band_layer_probe import report
from .bench_batch import bench_batch
from .timing import flush_buffer, timed_ms

SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--molecules", type=int, default=1024)
    p.add_argument("--hidden", type=int, default=300)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--jax_rows", type=int, default=28672,
                   help="rows of the JAX probe's shape")
    p.add_argument("--jax_hidden", type=int, default=384,
                   help="width of the JAX probe's shape")
    return p.parse_args(argv)


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, in float64."""
    want = want.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def probe_shape(N: int, H: int, dev: torch.device, flush: torch.Tensor,
                reps: int) -> dict:
    """The check and the timed rows at (N, H) x (H, H)."""
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.normal(size=(N, H)).astype(np.float32),
                        device=dev)
    w = torch.as_tensor((rng.normal(size=(H, H)) * 0.05).astype(np.float32),
                        device=dev)
    b_hi, b_lo = pk.split_bf16(w)
    got = pk.fused_matmul(x, b_hi, b_lo)
    plain = pk.fused_matmul_plain(x, b_hi, b_lo)
    x_hi, x_lo = (t.double() for t in pk.split_bf16(x))
    exact_split = x_hi @ b_hi.double() + x_hi @ b_lo.double() \
        + x_lo @ b_hi.double()
    exact = x.double() @ w.double()
    err = {"kernel_vs_plain": max_rel(got, plain),
           "kernel_vs_fp64": max_rel(got, exact),
           "plain_vs_fp64": max_rel(plain, exact),
           "kernel_vs_fp64_split": max_rel(got, exact_split),
           "plain_vs_fp64_split": max_rel(plain, exact_split)}
    print(f"[probe] fused_matmul at ({N}, {H}) x ({H}, {H}) on {dev}: "
          "max error / max|reference|: " + ", ".join(
              f"{k} {v:.3e}" for k, v in err.items()), flush=True)

    ops = 2.0 * N * H * H
    rows = {}
    for name, level, kind, work, fn in (
            ("fused_matmul", "highest", "bf16", 3 * ops,
             lambda: pk.fused_matmul(x, b_hi, b_lo)),
            ("plain", "highest", "fp32", 3 * ops,
             lambda: pk.fused_matmul_plain(x, b_hi, b_lo)),
            ("mm_fp32", "highest", "fp32", ops, lambda: torch.mm(x, w)),
            ("mm_tf32", "high", "tf32", ops, lambda: torch.mm(x, w))):
        with pk.float32_matmul_precision(level):
            ms = timed_ms(f"{name} at ({N}, {H})", fn, flush, reps)
        rows[name] = report(name, ms, work, kind, on_card)
    return {"N": N, "H": H, "errors": err, "rows": rows}


def main(argv: Optional[Sequence[str]] = None,
         batch: Optional[GraphBatch] = None) -> dict:
    """Runs the probe and returns ``{"bench": ..., "jax_shape": ...}``, each
    with its shape, errors and rows; ``batch`` replaces the featurized
    bench batch, of which only the padded bond count is used."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    gb = batch if batch is not None else bench_batch(args.molecules)
    flush = flush_buffer(dev)
    return {"bench": probe_shape(gb.f_bonds.shape[0], args.hidden, dev,
                                 flush, args.reps),
            "jax_shape": probe_shape(args.jax_rows, args.jax_hidden, dev,
                                     flush, args.reps)}


if __name__ == "__main__":
    main()
