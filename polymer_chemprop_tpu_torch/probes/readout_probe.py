"""Row 3's gather entry in each of its uses, timed cold and warm.

The gather entry of csrc/atom_readout.cu sums rows read through an index
over a CSR (sub-rows 3a and 3b of PERF.md's kernel table). This probe
times, at the bench batch (1,024 molecules of regression.csv: B = 28,032,
A = 13,696, M = 1,024) and at the first training batch (B = 1,792, A =
768, M = 50), hidden 300:

* ``mol gather``: the entry alone over the molecule CSR with its weights
  already gathered (``csr_gather_sum(h, mol_idx, w[mol_idx], mol_rowptr)``,
  how the molecule readout launched it before it had an entry of its own);
* ``mol kernel``: where the checkout has it, the one-launch molecule
  readout alone (``molecule_readout_f32``, ``mean``);
* ``mol op``: the whole op ``molecule_readout_sorted`` (``mean``), its
  forward with the VJP (``mol op+vjp``), and its plain version (ops/
  segment.py ``molecule_readout``, two ``index_add_``);
* ``3a``, ``3b``: ``atom_neighbor_sum_sorted`` and ``src_readout_sorted``
  over the (A, H) atom table, and ``3b vjp``, the readout of a cotangent
  with the weights ``w[srev]`` as the VJP reads them;
* ``3a distinct``: the entry over a (B, H) table whose rows are each read
  once, in a shuffled order: beside ``3a`` (the A rows read about B / A
  times each) it shows whether the second read of a row comes from L2.

Each is timed two ways: ``cold``, the median of ``--reps`` single calls,
each after a 1 GiB flush (probes/timing.py), as PERF.md's table times
kernels; and ``warm``, ``--warm`` calls back to back between two CUDA
events while the inputs stay in L2, as a training step meets them (the
previous kernel has just written h), the host enqueuing them behind a
device sleep so that the events bracket device time only. Each row prints
its bound (the bytes the function must move over 3.35 TB/s) and the
SHA-256 of its output, so that two checkouts' runs show whether the
outputs differ in any bit. ``--bits`` then trains the EA/IP weighted arm
(60 epochs) and the regression golden and prints their scores and the
arm's parameters' SHA-256.

    python3 -m polymer_chemprop_tpu_torch.probes.readout_probe \\
        [--device cuda|cpu] [--reps 20] [--warm 50] [--bits]

Run as a file it imports the ``polymer_chemprop_tpu_torch`` first on
``PYTHONPATH``, so that another checkout's kernels are timed by the same
code::

    PYTHONPATH=<checkout> python3 polymer_chemprop_tpu_torch/probes/readout_probe.py

Such a checkout may predate the one-launch readout and the gather entry's
weight index: :func:`cases` then leaves out ``mol kernel`` and gathers
3b's VJP weights in a launch of their own. Those two branches can go once
no caller times such a checkout.

With ``--device cpu`` (and a small ``--molecules``) the wrappers run
their plain versions under a host clock, for tests: those are host times.
"""

from __future__ import annotations

import argparse
import inspect
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
from polymer_chemprop_tpu_torch.ops import segment
from polymer_chemprop_tpu_torch.probes.bench_batch import bench_batch
from polymer_chemprop_tpu_torch.probes.csr_rows_probe import (
    output_sha256, training_graph)
from polymer_chemprop_tpu_torch.probes.timing import flush_buffer, timed_ms
from polymer_chemprop_tpu_torch.train.predict import resolve_device

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, HBM3
SEED = 0
# the card's SM clock is at most 1.98 GHz: cycles of device sleep a second
SLEEP_CYCLES_PER_S = 2.0e9


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--molecules", type=int, default=1024)
    p.add_argument("--hidden", type=int, default=300)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--warm", type=int, default=50)
    p.add_argument("--bits", action="store_true")
    p.add_argument("--out", default=os.path.join("build", "readout_probe"))
    return p.parse_args(argv)


def warm_ms(label: str, fn: Callable[[], object], n: int,
            device: torch.device, rounds: int = 5) -> float:
    """Device ms of one ``fn()`` among ``n`` back to back, median of
    ``rounds``: the host enqueues the ``n`` calls behind a device sleep
    longer than its own time for them (a round whose enqueueing outlasts
    the sleep runs again with a sleep twice as long), so that two CUDA
    events bracket the device's work alone. On the CPU, host ms of the
    same loop."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / n)
        ms = float(np.median(times))
        print(f"[spread] {label} warm: {ms:.4f} ms a call, host (cpu) clock",
              flush=True)
        return ms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    sleep_s = max(4 * (time.perf_counter() - t0), 0.005)
    times = []
    while len(times) < rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if enqueue_s > 0.8 * sleep_s:
            # the device may have idled between calls: again, longer
            sleep_s *= 2
            if sleep_s > 1.0:
                raise RuntimeError(f"{label}: the host takes {enqueue_s:.4f}"
                                   f" s to enqueue {n} calls")
            continue
        times.append(start.elapsed_time(end) / n)
    lo, med, hi = np.percentile(times, [0, 50, 100])
    print(f"[spread] {label} warm: min {lo:.4f} median {med:.4f} max "
          f"{hi:.4f} ms a call over {rounds} rounds of {n}, device clock",
          flush=True)
    return float(med)


def readout_bytes(n_real: int, M: int, H: int) -> int:
    """Bytes the molecule readout must move: the ``n_real`` atom rows of h
    in the molecule CSR's runs (``mol_rowptr[-1]``; the padding atoms are
    never read) read once with their index and weight, the output (M, H)
    written once, mol_rowptr (M + 1,), the mean's denominator and the
    degree of polymerisation (M,)."""
    return 4 * (n_real * H + M * H + 2 * n_real + (M + 1) + 2 * M)


def composed_readout(h, w, a2mol, aux, dop, aggregation, g):
    """The molecule readout as the port computed it before its one-launch
    entry, and its VJP: the gather entry over the molecule CSR on the
    gathered weights ``w[idx]``, then ``aggregate_molecules``; autograd
    through the aggregation, then the row gather ``w[r] g'[a2mol r]``.
    Returns ``(out, dh)``."""
    idx, rp = aux["mol_idx"], aux["mol_rowptr"]
    wsum = bm.csr_gather_sum(h, idx, w[idx.long()].contiguous(), rp)
    wsum.requires_grad_(True)
    out = bm.aggregate_molecules(wsum, aux["mol_denom"], dop, aggregation)
    gw = torch.autograd.grad(out, wsum, g)[0]
    return out.detach(), w[:, None] * gw[a2mol.long()]


def gather_bytes(A: int, B: int, H: int, weighted: bool) -> int:
    """Bytes of 3a / 3b (chip_smoke.py ``work``): the (A, H) table read
    once, the (A, H) output written once, src_sorted and rowptr, and the
    readout's weights."""
    return 4 * (2 * A * H + B + (A + 1) + (B if weighted else 0))


def shape_inputs(graph: Dict[str, torch.Tensor], H: int, dev,
                 rng: np.random.Generator) -> Dict[str, object]:
    aux = graph["sorted_aux"]
    A = graph["a2mol"].shape[0]
    M = graph["degree_of_polym"].shape[0]
    B = aux["src_sorted"].shape[0]
    T = lambda x: torch.as_tensor(x, device=dev)
    return {"aux": aux, "a2mol": graph["a2mol"], "w": graph["w_atoms"],
            "dop": graph["degree_of_polym"], "A": A, "M": M, "B": B,
            "h": T(rng.normal(size=(A, H)).astype(np.float32)),
            "g": T(rng.normal(size=(M, H)).astype(np.float32)),
            "ga": T(rng.normal(size=(A, H)).astype(np.float32)),
            "hb": T(rng.normal(size=(B, H)).astype(np.float32)),
            "perm": T(rng.permutation(B).astype(np.int32))}


def cases(s: Dict[str, object], H: int) -> Dict[str, tuple]:
    """``{label: (fn, bytes)}`` of one shape's timed calls."""
    aux, h, w, a2mol, dop = s["aux"], s["h"], s["w"], s["a2mol"], s["dop"]
    A, M, B = s["A"], s["M"], s["B"]
    idx, rp = aux["mol_idx"], aux["mol_rowptr"]
    wi = w[idx.long()].contiguous()
    src, srev, ws = aux["src_sorted"], aux["srev"], aux["w_sorted"]
    arp = aux["rowptr"]
    rbytes = readout_bytes(int(rp[-1]), M, H)
    out = {"mol gather": (lambda: bm.csr_gather_sum(h, idx, wi, rp), rbytes)}
    if hasattr(bm, "_molecule_readout_launch") and h.is_cuda:
        out["mol kernel"] = (lambda: bm._molecule_readout_launch(
            h, w, idx, rp, aux["mol_denom"], dop), rbytes)
    x = h.clone().requires_grad_(True)

    def op_vjp():
        return torch.autograd.grad(
            bm.molecule_readout_sorted(x, w, a2mol, aux, dop), x, s["g"])[0]
    out["mol op"] = (lambda: bm.molecule_readout_sorted(h, w, a2mol, aux,
                                                        dop), rbytes)
    out["mol op+vjp"] = (op_vjp, rbytes + 4 * (M * H + A * H + A))
    out["mol plain"] = (lambda: segment.molecule_readout(h, w, a2mol, M, dop),
                        rbytes)
    out["3a"] = (lambda: bm.atom_neighbor_sum_sorted(h, aux),
                 gather_bytes(A, B, H, False))
    out["3b"] = (lambda: bm.src_readout_sorted(h, aux),
                 gather_bytes(A, B, H, True))
    if "widx" in inspect.signature(bm._atom_gather_forward).parameters:
        vjp = lambda: bm._atom_gather_forward(bm.src_readout_sorted, s["ga"],
                                              ws, src, arp, widx=srev)
    else:
        vjp = lambda: bm._atom_gather_forward(bm.src_readout_sorted, s["ga"],
                                              ws[srev.long()], src, arp)
    out["3b vjp"] = (vjp, gather_bytes(A, B, H, True) + 4 * B)
    out["3a distinct"] = (lambda: bm.csr_gather_sum(s["hb"], s["perm"], None,
                                                    arp),
                          4 * (int(arp[-1]) * H + A * H + B + A + 1))
    return out


def bits(dev: str, out_dir: str) -> Dict[str, object]:
    """The EA/IP weighted arm at its full configuration and the regression
    golden: scores and the arm's parameters' SHA-256."""
    from polymer_chemprop_tpu_torch import eaip, goldens
    from polymer_chemprop_tpu_torch import polymer_goldens as pg
    from polymer_chemprop_tpu_torch.probes.determinism_probe import (
        run_record)
    save_dir = os.path.join(out_dir, "eaip")
    rmse, r2 = pg.run_arm(eaip.generate(blind_weights=False), save_dir, dev,
                          save_smiles_splits=True)
    sha = run_record(save_dir)["fold_0"]["param_sha"]
    print(f"[bits] eaip weighted: test rmse {rmse!r} r2 {r2!r}, parameters "
          f"sha256 {sha}", flush=True)
    reg = goldens.GOLDENS["regression"]
    r = goldens.run_golden(reg, dev, os.path.join(out_dir, "golden"))
    print(f"[bits] regression golden: mean test rmse {r.score!r}",
          flush=True)
    return {"eaip_rmse": rmse, "eaip_r2": r2, "eaip_sha": sha,
            "golden_regression": r.score}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Runs the probe; returns ``{shape: {label: {"cold", "warm",
    "bound_ms", "sha256"}}}`` and, with ``--bits``, ``"bits"``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip(), flush=True)
    package = os.path.dirname(os.path.dirname(bm.__file__))
    print(f"[probe] kernels of {package}", flush=True)
    rng = np.random.default_rng(SEED)
    graphs = {"bench": batch_to_tensors(
                  bench_batch(args.molecules).arrays(sorted_aux=True), dev),
              "train": training_graph(dev)}
    flush = flush_buffer(dev)
    result: Dict[str, object] = {}
    for shape, graph in graphs.items():
        s = shape_inputs(graph, args.hidden, dev, rng)
        print(f"[probe] {shape}: B={s['B']} A={s['A']} M={s['M']} "
              f"H={args.hidden}", flush=True)
        rows = {}
        for label, (fn, nbytes) in cases(s, args.hidden).items():
            r = {"bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                 "cold": timed_ms(f"{shape} {label}", fn, flush, args.reps),
                 "warm": warm_ms(f"{shape} {label}", fn, args.warm, dev),
                 "sha256": output_sha256(fn())}
            print(f"[readout] {shape:5s} {label:18s} cold {r['cold']:.4f} "
                  f"warm {r['warm']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({nbytes} bytes), output sha256 {r['sha256'][:16]}",
                  flush=True)
            rows[label] = r
        result[shape] = rows
    if args.bits:
        result["bits"] = bits(args.device, args.out)
    return result


if __name__ == "__main__":
    main()
