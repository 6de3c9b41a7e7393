"""How close the four CSR-row kernels come to the card's memory rate.

``atom_readout`` (csrc/atom_readout.cu), ``band_agg`` (csrc/band_agg.cu)
and their VJPs ``band_bwd`` (csrc/band_bwd.cu) and ``band_rev_bwd``
(csrc/band_rev_bwd.cu) read the runs of a dst-sorted CSR
(csrc/csr_rows.cuh). This probe times the four wrappers, each launch
after an L2 flush (:mod:`.timing`), at three shapes:

* ``bench``: the bench batch (1,024 molecules, B = 28,032, A = 13,696)
  at hidden 300;
* ``train``: the first training batch of 50 molecules of regression.csv
  as the trainer's loader pads it (B = 1,792, A = 768) at hidden 300;
* ``wide``: the bench batch at hidden 1,600 (``--wide``), without
  ``band_rev_bwd``, whose layer form (``rev``) never runs above hidden
  1,495.

For each it prints the run-length histogram (``rowptr`` differences), and
for each kernel the median ms, the bytes bound (each input read once, the
output written once, over 3.35 TB/s, the H100 SXM data sheet's HBM3
rate) and the achieved GB/s, beside a copy of the same number of bytes
(``torch.Tensor.copy_``: half of them read, half written), the least this
card and this timing give for moving them, and a launch that writes one
float, the least any kernel takes under this timing; ``band_rev_bwd``
also with ``srev`` the identity (``in_order``: the same dependent load of
``srev``, the rows read in CSR order), which splits its time over
``band_bwd``'s into that round trip and the gather. It also prints a
SHA-256 of each wrapper's output on the seeded input, so that two
checkouts' runs show whether the kernels' outputs differ in any bit.

    python3 -m polymer_chemprop_tpu_torch.probes.csr_rows_probe \\
        [--device cuda|cpu] [--molecules 1024] [--wide 1600] [--reps 20]

Run as a file, it imports the ``polymer_chemprop_tpu_torch`` that comes
first on ``PYTHONPATH``, so that another checkout's kernels are timed by
the same code::

    PYTHONPATH=<checkout> python3 polymer_chemprop_tpu_torch/probes/csr_rows_probe.py

With ``--device cpu`` the wrappers run their plain versions under a host
clock (for tests); those are host times, and no rate is printed.
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
from polymer_chemprop_tpu_torch.probes.bench_batch import (
    REGRESSION_CSV, bench_aux, bench_batch)
from polymer_chemprop_tpu_torch.probes.timing import flush_buffer, timed_ms
from polymer_chemprop_tpu_torch.train.predict import resolve_device

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, HBM3
SEED = 0
TRAIN_MOLECULES, BATCH_SIZE = 400, 50
KERNELS = ("atom_readout", "band_agg", "band_bwd", "band_rev_bwd")
NARROW_ONLY = ("band_rev_bwd",)     # not timed at the wide shape


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--molecules", type=int, default=1024)
    p.add_argument("--hidden", type=int, default=300)
    p.add_argument("--wide", type=int, default=1600)
    p.add_argument("--reps", type=int, default=20)
    return p.parse_args(argv)


def training_graph(dev) -> dict:
    """The first training batch of regression.csv (400 molecules, batch 50,
    seed 0) as the trainer's loader pads it, as tensors on ``dev``."""
    from polymer_chemprop_tpu_torch.data import MoleculeDataLoader, get_data
    from polymer_chemprop_tpu_torch.features import FeaturizationConfig
    from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
    fcfg = FeaturizationConfig()
    data = get_data(str(REGRESSION_CSV), config=fcfg,
                    max_data_size=TRAIN_MOLECULES)
    loader = MoleculeDataLoader(data, fcfg, batch_size=BATCH_SIZE,
                                shuffle=True, seed=SEED, num_workers=1)
    return batch_to_tensors(next(iter(loader)).graph_arrays[0], dev)


def run_lengths(rowptr: np.ndarray) -> np.ndarray:
    """Histogram of the atoms' run lengths: entry n counts the atoms with n
    incoming bonds."""
    return np.bincount(np.diff(np.asarray(rowptr, np.int64)))


def kernel_bytes(kernel: str, B: int, A: int, H: int, n_real: int) -> int:
    """Bytes the function must move: atom_readout reads the real rows of m
    and their weights and writes (A, H); band_agg reads every row of m and
    every weight and writes every row of z, as band_bwd does with g and
    dm; band_rev_bwd moves band_bwd's bytes and reads srev too; all read
    rowptr. chip_smoke.py's bounds for these kernels come from here too."""
    if kernel == "atom_readout":
        return 4 * (n_real * H + n_real + A * H + (A + 1))
    return 4 * (2 * B * H + B + (A + 1)
                + (B if kernel == "band_rev_bwd" else 0))


def output_sha256(out: torch.Tensor) -> str:
    """SHA-256 of a float32 tensor's bytes, row-major."""
    return hashlib.sha256(out.detach().cpu().numpy().tobytes()).hexdigest()


def main(argv: Optional[Sequence[str]] = None,
         batch: Optional[GraphBatch] = None) -> dict:
    """Runs the probe and returns ``{shape: {"B", "A", "H", "n_real",
    "hist", kernel: {"bytes", "ms", "bound_ms", "gbps", "copy",
    "launch", "sha256"}}}``, ``band_rev_bwd`` also with ``"in_order"``
    (not at ``wide``); ``batch``
    replaces the featurized bench batch (chip_smoke.py passes its
    own)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    gb = batch if batch is not None else bench_batch(args.molecules)
    aux = bench_aux(gb)
    T = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    bench = (T(aux.w_sorted), T(aux.srev), T(aux.rowptr))
    graph = training_graph(dev)
    train = tuple(graph["sorted_aux"][k] for k in ("w_sorted", "srev",
                                                   "rowptr"))
    shapes = {"bench": (bench, args.hidden), "train": (train, args.hidden),
              "wide": (bench, args.wide)}
    flush = flush_buffer(dev)
    clock = "device" if on_card else "host (cpu)"
    print(f"[probe] CSR-row kernels on {dev}, {clock} times, median of "
          f"{args.reps}", flush=True)
    rng = np.random.default_rng(SEED)
    out = {}
    for shape, ((ws, srev, rp), H) in shapes.items():
        B, A = ws.shape[0], rp.shape[0] - 1
        rowptr = rp.cpu().numpy()
        n_real = int(rowptr[-1])
        hist = run_lengths(rowptr)
        row = {"B": B, "A": A, "H": H, "n_real": n_real,
               "hist": hist.tolist()}
        print(f"[probe] {shape}: B={B} A={A} H={H} real rows {n_real}; "
              f"atoms by run length {dict(enumerate(hist.tolist()))}",
              flush=True)
        m = T(rng.normal(size=(B, H)).astype(np.float32))
        for kernel in KERNELS:
            if shape == "wide" and kernel in NARROW_ONLY:
                continue
            wrapper = getattr(bm, kernel)
            operands = (m, ws, srev, rp) if kernel == "band_rev_bwd" else (
                m, ws, rp)
            nbytes = kernel_bytes(kernel, B, A, H, n_real)
            r = {"bytes": nbytes,
                 "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
            # the same bytes read once and written once by PyTorch's copy
            # kernel: what moving them costs on this card with this timing;
            # and one float written: what any launch costs
            src = m.new_empty(nbytes // 8)
            dst = torch.empty_like(src)
            timings = [("wrapper", lambda: wrapper(*operands)),
                       ("copy", lambda: dst.copy_(src)),
                       ("launch", lambda: dst[:1].zero_())]
            if kernel == "band_rev_bwd":
                # srev = identity: the same dependent srev load, the rows
                # read in CSR order as band_bwd reads them
                ident = torch.arange(B, dtype=torch.int32, device=dev)
                timings.append(("in_order", lambda: wrapper(m, ws, ident,
                                                            rp)))
            for label, fn in timings:
                ms = timed_ms(f"{kernel} {shape} {label}", fn, flush,
                              args.reps)
                entry = {"ms": ms}
                line = f"{kernel:12s} {shape:5s} {label:8s} {ms:9.4f} ms"
                if on_card and label != "launch":   # it moves 4 bytes
                    entry["gbps"] = nbytes / ms * 1e-6
                    line += (f" {entry['gbps']:8.1f} GB/s "
                             f"{100 * r['bound_ms'] / ms:5.1f}% of the bytes "
                             f"bound {r['bound_ms']:.4f} ms")
                print(line, flush=True)
                if label == "wrapper":
                    r.update(entry)
                else:
                    r[label] = entry
            r["sha256"] = output_sha256(wrapper(*operands))
            print(f"{kernel:12s} {shape:5s} output sha256 {r['sha256']}",
                  flush=True)
            row[kernel] = r
        out[shape] = row
    return out


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
