"""The two W_h product stages of the fused band kernels: their times, their
controls, and a SHA-256 of every output.

The FP32 stage (csrc/band_tile.cuh, ``band_precision="highest"``) serves
``band_rev_layer`` (row 1 of PERF.md's kernel table), ``band_matmul_act``
(row 4) and ``band_matmul`` (row 7); its control ``band_ctrl`` (row 8,
modes ``noq`` and ``pure``) runs it without the CSR z build. The
``wgmma`` stage (csrc/band_tile_sm90.cuh, "high" and "default") serves
the same three; ``fused_matmul`` (row 10, csrc/fused_matmul.cu) runs its
machinery on a dense x, the product alone. At the bench shape (1,024
molecules of regression.csv, B = 28,032, H = 300, seeded operands) the
probe times each of:

* rows 1, 4 and 7 at "highest", "high" and "default", rows 1 and 4 with
  and without z written (row 7 always writes it);
* row 8 in both modes, with each 32-row block's range its own rows;
* row 10 at (B, H) x (H, H);

each the median of ``--reps`` launches after an L2 flush
(:mod:`.timing`), and prints a SHA-256 of each output (and of z), so that
two checkouts' runs show whether a redesign changed any bit. It then
prints the ``wgmma`` stage's split: row 10 is the product, and each of
rows 1, 4 and 7 at "high" less row 10 is its z build and epilogue.

    python3 -m polymer_chemprop_tpu_torch.probes.stage_probe \\
        [--device cuda|cpu] [--molecules 1024] [--hidden 300] [--reps 20]

Run as a file, it imports the ``polymer_chemprop_tpu_torch`` that comes
first on ``PYTHONPATH``, so that another checkout's kernels are timed and
hashed by the same code::

    PYTHONPATH=<checkout> python3 polymer_chemprop_tpu_torch/probes/stage_probe.py

With ``--device cpu`` the wrappers run their plain versions under a host
clock (for tests); those are host times and their hashes are the plain
versions'.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Optional, Sequence

import numpy as np
import torch

from polymer_chemprop_tpu_torch.features import GraphBatch
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from polymer_chemprop_tpu_torch.ops import probe_kernels as pk
from polymer_chemprop_tpu_torch.probes.bench_batch import (bench_aux,
                                                           bench_batch)
from polymer_chemprop_tpu_torch.probes.timing import flush_buffer, timed_ms
from polymer_chemprop_tpu_torch.train.predict import resolve_device

SEED = 0
PRECISIONS = ("highest", "high", "default")
TC_ROWS = ("band_rev_layer", "band_matmul_act", "band_matmul")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--molecules", type=int, default=1024)
    p.add_argument("--hidden", type=int, default=300)
    p.add_argument("--reps", type=int, default=20)
    return p.parse_args(argv)


def output_sha256(out: torch.Tensor) -> str:
    """SHA-256 of a float32 tensor's bytes, row-major."""
    return hashlib.sha256(out.detach().cpu().numpy().tobytes()).hexdigest()


def main(argv: Optional[Sequence[str]] = None,
         batch: Optional[GraphBatch] = None) -> dict:
    """Runs the probe and returns ``{"B", "H", "rows": {name: {"ms",
    "sha256", "z_sha256" (where z is written)}}, "split": {row: {"product",
    "build_epilogue"}}}``; ``batch`` replaces the featurized bench batch."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
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
    b_hi, b_lo = pk.split_bf16(wh)

    calls = {}
    for prec in PRECISIONS:
        for want_z in (False, True):
            tag = f"{prec}{'_z' if want_z else ''}"
            calls[f"band_rev_layer {tag}"] = (
                lambda p=prec, z=want_z: bm.band_rev_layer_forward(
                    m, inp, wh, ws, src, srev, rp, "relu", z, p))
            calls[f"band_matmul_act {tag}"] = (
                lambda p=prec, z=want_z: bm.band_matmul_act_forward(
                    m, inp, wh, ws, rp, "relu", z, p))
        calls[f"band_matmul {prec}"] = (
            lambda p=prec: bm.band_matmul_forward(m, wh, ws, rp, p))
    calls["band_ctrl noq"] = lambda: pk.band_ctrl(m, inp, wh, ws, lo, hi,
                                                  "noq")
    calls["band_ctrl pure"] = lambda: pk.band_ctrl(m, None, wh, ws, lo, hi,
                                                   "pure")
    calls["fused_matmul"] = lambda: pk.fused_matmul(m, b_hi, b_lo)

    if dev.type == "cuda":   # one nvcc per source, all started together
        from polymer_chemprop_tpu_torch.kernels import build
        build.build(("band_rev_layer", "band_matmul", "band_ctrl",
                     "fused_matmul"))
    flush = flush_buffer(dev)
    clock = "device" if dev.type == "cuda" else "host (cpu)"
    print(f"[probe] product stages at B={B} H={H} on {dev}, {clock} times, "
          f"median of {args.reps}", flush=True)
    rows = {}
    with pk.float32_matmul_precision("highest"):
        for name, fn in calls.items():
            ms = timed_ms(name, fn, flush, args.reps)
            got = fn()
            out, z = got if isinstance(got, tuple) else (got, None)
            row = {"ms": ms, "sha256": output_sha256(out)}
            line = f"{name:24s} {ms:9.4f} ms output sha256 {row['sha256']}"
            if z is not None:
                row["z_sha256"] = output_sha256(z)
                line += f" z sha256 {row['z_sha256']}"
            print(line, flush=True)
            rows[name] = row

    product = rows["fused_matmul"]["ms"]
    split = {}
    for name in TC_ROWS:
        full = rows[f"{name} high"]["ms"]
        split[name] = {"product": product, "build_epilogue": full - product}
        print(f"[probe] {name} at \"high\" ({clock} ms): {full:.4f} = product "
              f"(fused_matmul) {product:.4f} + z build and epilogue "
              f"{full - product:.4f}", flush=True)
    return {"B": B, "H": H, "device": str(dev), "rows": rows,
            "split": split}


if __name__ == "__main__":
    if torch.cuda.is_available():
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    print(f"[probe] package {os.path.dirname(os.path.dirname(bm.__file__))}",
          flush=True)
    main()
