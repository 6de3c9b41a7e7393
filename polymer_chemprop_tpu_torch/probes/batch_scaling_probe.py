"""The train step and its parts at several batch sizes, in ns per real edge.

The port's counterpart of the JAX side's scripts/batch_scaling_probe.py.
For each size (molecules of the bench batch, ``bench.load_batch``) it
times, at hidden 300 (the port's width: the JAX probe's 384 is the TPU's
lane padding, and the CUDA kernels have none):

* ``step``: the port's train step (``bench.timed_step``: forward, backward,
  Adam; the median of its trials, host clock around synced trials);
* ``band_fwd``: row 1, ``band_rev_layer`` at "high" without z
  (csrc/band_rev_layer.cu, entry ``band_rev_layer_tc``);
* ``band_bwd``: row 2, ``band_rev_bwd`` (csrc/band_rev_bwd.cu);
* ``readout``: row 3, ``atom_readout`` (csrc/atom_readout.cu);
* ``elemwise``: ``relu(m + inp)`` over the (B, H) messages, in torch;
* ``gather``: the ``srev`` row gather ``m[srev]``, in torch;
* ``matmul``: ``band_product(z, W_h, "high")`` (ops/band_mpnn.py), the
  port's split-bf16 product outside any kernel, in torch.

Each part but ``step`` is timed cold (probes/timing.py ``timed_ms``: the
median of ``--reps`` calls, each after a 1 GiB flush, CUDA events) and
warm (probes/readout_probe.py ``warm_ms``: ``--warm`` calls back to back,
inputs in L2, the JAX probe's scan-amortised regime). It prints ms and ns
per real edge for each part, then each part's growth in ns per edge
against the first size.

    python -m polymer_chemprop_tpu_torch.probes.batch_scaling_probe \\
        [--device cuda|cpu] [--hidden 300] [--trials 5] [--reps 20]
        [--warm 50] [sizes ...]      # default sizes 1024 2048 4096

With ``--device cpu`` (and small sizes) the parts run their plain versions
under the host clock, for tests: those are host times.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..bench import card_line, load_batch, timed_step
from ..features import GraphBatch
from ..models.encoder import batch_to_tensors
from ..ops import band_mpnn as bm
from ..train.predict import resolve_device
from .readout_probe import warm_ms
from .timing import flush_buffer, timed_ms

SIZES = (1024, 2048, 4096)
PARTS = ("step", "band_fwd", "band_bwd", "readout", "elemwise", "gather",
         "matmul")
SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sizes", type=int, nargs="*", default=list(SIZES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--hidden", type=int, default=300)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--warm", type=int, default=50)
    return p.parse_args(argv)


def parts(graph: Dict, H: int, device: torch.device):
    """``{part: fn}`` of the kernel and torch parts on one batch's sorted
    layout, on operands drawn from a seed."""
    aux = graph["sorted_aux"]
    B = aux["srev"].shape[0]
    rng = np.random.default_rng(SEED)
    T = lambda *shape, scale=1.0: torch.as_tensor(
        (rng.normal(size=shape) * scale).astype(np.float32), device=device)
    m, inp, g, z = T(B, H), T(B, H), T(B, H), T(B, H)
    wh = T(H, H, scale=0.05)
    ws, src, srev, rp = (aux[k] for k in ("w_sorted", "src_sorted", "srev",
                                          "rowptr"))
    srev_long = srev.long()
    return {
        "band_fwd": lambda: bm.band_rev_layer_forward(
            m, inp, wh, ws, src, srev, rp, "relu", False, "high")[0],
        "band_bwd": lambda: bm.band_rev_bwd(g, ws, srev, rp),
        "readout": lambda: bm.atom_readout(m, ws, rp),
        "elemwise": lambda: torch.relu(m + inp),
        "gather": lambda: m[srev_long],
        "matmul": lambda: bm.band_product(z, wh, "high"),
    }


def main(argv: Optional[Sequence[str]] = None,
         batches: Optional[Dict[int, GraphBatch]] = None) -> Dict[int, Dict]:
    """Runs the probe; returns ``{size: {"real", "padded", part: {"cold",
    "warm"} (ms; ``step``: ``{"ms"}``)}}``. ``batches`` may hold sizes'
    bench batches featurized beforehand."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        print(card_line(), flush=True)
    clock = "device clock" if on_card else "host clock (cpu), plain versions"
    step_clock = "host clock, synced" if on_card else "host clock (cpu)"
    flush = flush_buffer(device)
    rows: Dict[int, Dict] = {}
    for n in args.sizes:
        gb = (batches or {}).get(n) or load_batch(n)
        real, padded = gb.n_bonds_real - 1, int(gb.f_bonds.shape[0])
        print(f"== batch {n} mols: real edges {real}, padded {padded}, "
              f"atoms {gb.f_atoms.shape[0]}, H={args.hidden}", flush=True)
        row: Dict[str, object] = {"real": real, "padded": padded}
        step = timed_step(gb, device, args.trials, hidden=args.hidden)
        row["step"] = {"ms": step["step_ms"]}
        print(f"[scaling] {n:5d} step      {step['step_ms']:9.4f} ms "
              f"{step['step_ms'] * 1e6 / real:8.3f} ns/edge (median of "
              f"{args.trials} trials, {step_clock})", flush=True)
        graph = batch_to_tensors(gb.arrays(sorted_aux=True), device)
        for name, fn in parts(graph, args.hidden, device).items():
            label = f"{n} {name}"
            cold = timed_ms(label, fn, flush, args.reps)
            warm = warm_ms(label, fn, args.warm, device)
            row[name] = {"cold": cold, "warm": warm}
            print(f"[scaling] {n:5d} {name:9s} cold {cold:9.4f} ms "
                  f"{cold * 1e6 / real:8.3f} ns/edge, warm {warm:9.4f} ms "
                  f"{warm * 1e6 / real:8.3f} ns/edge ({clock})", flush=True)
        rows[n] = row

    first = args.sizes[0]
    print(f"\nper-edge growth vs batch {first} (cold; warm in brackets):",
          flush=True)
    base = rows[first]
    for name in PARTS:
        line = f"[growth] {name:9s}"
        for n in args.sizes:
            r = rows[n]
            if name == "step":
                g = r["step"]["ms"] / r["real"] / (base["step"]["ms"]
                                                   / base["real"]) - 1
                line += f"  {n}: {100 * g:+6.1f}%"
                continue
            gc, gw = (r[name][k] / r["real"] / (base[name][k] / base["real"])
                      - 1 for k in ("cold", "warm"))
            line += f"  {n}: {100 * gc:+6.1f}% [{100 * gw:+6.1f}%]"
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
