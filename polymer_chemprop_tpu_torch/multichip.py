"""The parallel package on several cards at once: the port's counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``.

Run it one rank a card under torchrun::

    torchrun --standalone --nproc_per_node 4 -m polymer_chemprop_tpu_torch.multichip

Every rank has its card of its own, so the ranks take NCCL
(``parallel/multihost.py`` ``pick_backend``); ranks that share a card, or
run on the CPU (``--device cpu``), take gloo. ``--bench_hidden`` and
``--bench_pairs`` shrink the bench-scale section for a quick run on the
CPU.

The sections run in the JAX dry run's order and at its shapes
(``__graft_entry__.py:59-330``), on the port's own weights (Xavier, from
``torch.Generator`` seeds 0, 1 and 3 where the dry run takes
``PRNGKey(0)``, ``(1)`` and ``(3)``). Every model computes at
``band_precision`` "highest" (the FP32 entry), so that the sharded steps
hold 1e-4 against one card:

1. the dp step (hidden 32, depth 2, Adam on a Noam schedule, the same
   micro-batch of four copolymers on every rank), its loss against one
   card's;
2. the edge-partitioned forward with a per-layer all-reduce, and
3. the halo forward, each against the single-device encoder;
4. the halo train step (SGD 0.1), against one card's step;
5. the bench-scale halo train step: hidden 300, depth 3, 48 molecules a
   rank of the eight small SMILES above (768 real directed bonds at two
   ranks) padded to ``2 * 4096 * n + 1`` bonds, so 8,192 bond rows a
   shard as in the dry run; the real bonds come first and all fall in the
   first shard at this size, the others hold padding (the summary's
   ``bench_real_bonds_per_shard``), so this step shows the sections run
   and agree, not how a real batch scales. Against one card's step: loss
   within 1e-4, parameters within 1e-4 of each tensor's largest entry,
   and beside them the dry run's elementwise measure (it asserted < 1e-2
   and recorded 2.38e-5); then the halo exchange a layer at its window (whole window and
   strips), the gradient all-reduce of a dp step of this model, and the
   step timed at n ranks and on one card;
6. the per-layer byte model (the dry run's ICI model; here the bytes
   cross NVLink, or host memory under gloo);
7. at four ranks or more, the 2-D ``(dp 2, ep n/2)`` step, the
   overlapped strip exchange against the whole-window one within 1e-6,
   and both against one card's step on the two batches together;
8. the ``atom_messages`` halo step (Adam 1e-3) against one card's: the
   dry run's loss and elementwise checks, the loss relative to its size.

Each rank prints its backend and device. Rank 0 prints a line a section
and last ``DRYRUN_SUMMARY {json}``: the keys of the dry run's summary
(the byte model under its ``ici_*`` names), and beside them this run's
timings, every rank's backend and device, each check's verdict and every
kernel's launches summed over the ranks. The checks are read after the
last collective, so a failed check ends the run with exit code 1 rather
than leaving the other ranks waiting.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .features import FeaturizationConfig, mol2graph
from .models.encoder import EncoderConfig, batch_to_tensors
from .models.init import init_model
from .models.model import ModelConfig, MoleculeModel
from .ops import band_mpnn as bm
from .ops.sorted_aux import sorted_batch
from .parallel import (build_edge_shards, build_edge_shards_halo,
                       build_edge_shards_halo_dp, halo_strip_width,
                       make_dp_train_step, make_edge_parallel_forward,
                       make_edge_parallel_forward_halo,
                       make_halo_dp_train_step, make_halo_train_step,
                       make_mesh, shard_batch, stack_device_batches)
from .parallel import partition
from .parallel.mesh import Mesh, all_reduce_sum, exchange, world
from .parallel.multihost import initialize_multihost, rank_device
from .train.scheduler import (build_optimizer, build_schedule,
                              constant_schedule)
from .train.step import TrainStep, make_loss_fn, pytree_tensors

# __graft_entry__.py:19-28: an aromatic homopolymer with Xn, a vinyl
# homopolymer and a random copolymer whose attachment points each take
# three edges of weight 1/3
POLY_SMILES = [
    "[*:1]c1ccc([*:2])cc1|1.0|<1-2:1.0:1.0~10",
    "[*:1]CC([*:2])C|1.0|<1-2:1.0:1.0",
    "[*:1]c1ccc2c(c1)S(=O)(=O)c1cc([*:2])ccc1-2.[*:3]c1ccc([*:4])c(N)c1"
    "|0.25|0.75|<1-2:0.333333:0.333333<1-3:0.333333:0.333333"
    "<1-4:0.333333:0.333333<2-3:0.333333:0.333333"
    "<2-4:0.333333:0.333333<3-4:0.333333:0.333333",
]
HALO_SMILES = ["CCO", "c1ccccc1", "CCN", "CC(=O)O", "c1ccncc1", "C1CCCCC1",
               "CC(C)O", "CCOCC"]
TOL = 1e-4            # sharded step against one card: loss, parameters
OVERLAP_TOL = 1e-6    # strips against the whole window (the dry run's)
ELEMENT_TOL = 1e-2    # the dry run's elementwise parameter measure


def synced_ms(fn: Callable, device, reps: int = 10, warm: int = 2) -> float:
    """Median host-clock ms of ``fn()``, each call ended by a device sync
    on a card."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def back_to_back_ms(fn: Callable, device, reps: int = 20) -> float:
    """Host-clock ms a call of ``reps`` calls of ``fn()`` made back to
    back and synced once at the end: what a call costs when nothing waits
    for it, as inside a step."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def param_errors(params, ref) -> tuple:
    """``(of max, elementwise)`` between two parameter lists: the max over
    tensors of max|a - b| / max|b| (the error against each tensor's
    largest entry, the measure the checks hold), and max |a - b| /
    max(|b|, 1e-6) over every element (the JAX dry run's,
    ``__graft_entry__.py:233-237``; near zero it divides rounding by the
    element itself)."""
    pairs = [(a.detach(), b.detach()) for a, b in zip(params, ref)]
    of_max = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                 for a, b in pairs)
    elem = max(float(((a - b).abs() / b.abs().clamp(min=1e-6)).max())
               for a, b in pairs)
    return of_max, elem


def exchange_ms(sharded: Dict, replicated: Dict, mesh: Mesh, axis: str,
                hidden: int, device, reps: int = 20) -> Dict[str, float]:
    """One layer's halo exchange alone at a batch's window, ``(Aw,
    hidden)``: the whole-window combine (its two neighbour sends and the
    adds), and the strip form's exchange of ``halo_strip_width`` rows
    (post, then wait); each synced (:func:`synced_ms`) and back to back
    (:func:`back_to_back_ms`). Every rank of ``axis`` calls it."""
    t = partition._prepare_halo(partition._take(sharded, mesh.coord(axis)),
                                replicated, device)
    aw, sw = t["f_atoms_win"].shape[0], halo_strip_width(sharded)
    x = torch.randn((aw, hidden), device=device,
                    generator=torch.Generator(device).manual_seed(0))
    def whole():
        partition._HaloCombineFn.apply(x, mesh, axis, t["off_prev"],
                                       t["off_next"])

    def strips():
        exchange(mesh, axis, x[:sw], x[:sw]).wait()

    return {"window": aw, "strip_width": sw,
            "whole_ms": synced_ms(whole, device, reps),
            "strip_ms": synced_ms(strips, device, reps),
            "whole_ms_back_to_back": back_to_back_ms(whole, device, reps),
            "strip_ms_back_to_back": back_to_back_ms(strips, device, reps)}


def _model(seed: int, device, hidden: int, depth: int, num_tasks: int = 1,
           atom_messages: bool = False) -> MoleculeModel:
    f = FeaturizationConfig()
    enc = EncoderConfig(atom_fdim=f.atom_fdim,
                        bond_fdim=f.bond_fdim(atom_messages),
                        hidden_size=hidden, depth=depth,
                        atom_messages=atom_messages,
                        band_precision="highest")
    cfg = ModelConfig(encoder=enc, dataset_type="regression",
                      num_tasks=num_tasks, ffn_hidden_size=hidden)
    return init_model(MoleculeModel(cfg),
                      torch.Generator().manual_seed(seed)).to(device)


def _sgd(model, lr: float):
    return build_optimizer("sgd", model.parameters()), constant_schedule(lr)


def _batch(arrays: Dict, targets) -> Dict:
    """A one-position batch pytree in the sorted layout, mask and weights
    one."""
    t = np.asarray(targets, np.float32)
    t = t.reshape(t.shape[0], -1)
    ones = np.ones((t.shape[0], 1), np.float32)
    return {"graphs": [sorted_batch(arrays)], "targets": t, "mask": ones,
            "weights": ones}


def _single_step(make_model: Callable, optimizer: Callable, batch: Dict,
                 device):
    """One card's step on ``batch``: the model after it, and the loss."""
    model = make_model()
    step = TrainStep(model, *optimizer(model), make_loss_fn(model.cfg))
    loss, _ = step(pytree_tensors(batch, device))
    return model, float(loss)


def _close(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| where both are within rtol 1e-4, atol 1e-5 of each
    other; inf otherwise."""
    err = (got - want).abs()
    ok = bool((err <= 1e-5 + TOL * want.abs()).all())
    return float(err.max()) if ok else float("inf")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def dryrun_multichip(device="cuda", bench_hidden: int = 300,
                     bench_pairs: int = 4096, reps: int = 10) -> Dict:
    """Run every section on this rank (module docstring) and return the
    summary (on rank 0; the other ranks' summaries hold their own part).
    Starts the process group from torchrun's environment when it is not
    up yet."""
    t0 = time.perf_counter()
    backend = initialize_multihost(device=device)
    init_ms = 1e3 * (time.perf_counter() - t0)
    rank, n = world()
    dev = rank_device(device)
    main = rank == 0
    print(f"multichip rank {rank} of {n}: backend {backend}, device {dev}",
          flush=True)

    def say(line: str) -> None:
        if main:
            print(line, flush=True)

    bm.reset_launch_counts()
    checks: Dict[str, bool] = {}
    timing: Dict[str, float] = {"init_ms": init_ms}
    tag = f"dryrun_multichip({n})"

    # 1. the dp step
    gb = mol2graph((POLY_SMILES * 2)[:4], FeaturizationConfig(polymer=True),
                   pad_atoms=64, pad_bonds=128, pad_mols=4)
    arrays = gb.arrays()
    batch = _batch(arrays, np.zeros((4, 2)))

    def adam_noam(model):
        return (build_optimizer("adam", model.parameters()),
                build_schedule("noam", init_lr=1e-4, max_lr=1e-3,
                               final_lr=1e-4, warmup_epochs=2, epochs=10,
                               steps_per_epoch=10))

    dp_mesh = make_mesh(n, ("dp",))
    model = _model(0, dev, 32, 2, num_tasks=2)
    step = make_dp_train_step(model, *adam_noam(model), dp_mesh)
    micro = shard_batch(stack_device_batches([batch] * n), dp_mesh, "dp",
                        dev)
    t1 = time.perf_counter()
    loss, _ = step(micro)
    dp_loss = float(loss)
    timing["dp_first_step_ms"] = 1e3 * (time.perf_counter() - t1)
    say(f"{tag} dp train step: loss = {dp_loss:.6f}")
    if main:
        _, single = _single_step(lambda: _model(0, dev, 32, 2, 2),
                                 adam_noam, batch, dev)
        checks["dp_loss"] = abs(dp_loss - single) <= TOL * max(1.0,
                                                              abs(single))
        say(f"  one card: loss = {single:.6f}")

    # 2. the edge-partitioned forward (a per-layer all-reduce of the atom
    # partials)
    ep = make_mesh(n, ("ep",))
    enc = _model(0, dev, 32, 2, num_tasks=2).encoders[0]
    cfg = enc.cfg
    with torch.no_grad():
        sh, rep = build_edge_shards(arrays, n)
        emb = make_edge_parallel_forward(cfg, ep)(enc, sh, rep)
        want = enc(batch_to_tensors(sorted_batch(arrays), dev))
        err = _close(emb, want)
        checks["psum_forward"] = err < float("inf")
        say(f"{tag} edge-partitioned forward: emb shape = "
            f"{tuple(emb.shape)}; max abs err {err:.3e} against one card")

        # 3. the halo forward (neighbour exchanges of window partials)
        halo_smiles = HALO_SMILES * (2 * n)
        mh = len(halo_smiles)
        arrays_h = mol2graph(halo_smiles, pad_atoms=max(256, 16 * n * 8),
                             pad_bonds=max(512, 16 * n * 16),
                             pad_mols=mh).arrays()
        sh_h, rep_h = build_edge_shards_halo(arrays_h, n)
        emb_h = make_edge_parallel_forward_halo(cfg, ep)(enc, sh_h, rep_h)
        want = enc(batch_to_tensors(sorted_batch(arrays_h), dev))
        err = _close(emb_h, want)
        checks["halo_forward"] = err < float("inf")
        say(f"{tag} halo edge-partitioned forward: emb shape = "
            f"{tuple(emb_h.shape)}; max abs err {err:.3e} against one card")

    # 4. the halo train step
    zeros, ones = np.zeros((mh, 1), np.float32), np.ones((mh, 1), np.float32)
    model = _model(0, dev, 32, 2, num_tasks=2)
    hstep = make_halo_train_step(model, *_sgd(model, 0.1), ep)
    t1 = time.perf_counter()
    loss_h = float(hstep(sh_h, rep_h, zeros, ones, ones)[0])
    timing["halo_first_step_ms"] = 1e3 * (time.perf_counter() - t1)
    say(f"{tag} halo edge-partitioned TRAIN step: loss = {loss_h:.6f}")
    if main:
        ref, single = _single_step(lambda: _model(0, dev, 32, 2, 2),
                                   lambda m: _sgd(m, 0.1),
                                   _batch(arrays_h, zeros), dev)
        of_max, _ = param_errors(model.parameters(), ref.parameters())
        checks["halo_step"] = (abs(loss_h - single) <= TOL * max(
            1.0, abs(single)) and of_max <= TOL)
        say(f"  one card: loss = {single:.6f}, max param rel err "
            f"{of_max:.2e} of each tensor's max")

    # 5. the bench-scale halo train step: hidden 300, depth 3, >= 8k
    # directed bonds a shard
    H = bench_hidden
    bench_smiles = (halo_smiles * (6 * n))[:48 * n]
    mb = len(bench_smiles)
    target_pairs = bench_pairs * n
    arrays_b = mol2graph(bench_smiles, pad_atoms=2 * target_pairs // 4,
                         pad_bonds=2 * target_pairs + 1,
                         pad_mols=mb).arrays()
    tgt = np.zeros((mb, 1), np.float32)
    msk = np.ones((mb, 1), np.float32)
    sh_b, rep_b = build_edge_shards_halo(arrays_b, n)
    model = _model(1, dev, H, 3)
    bstep = make_halo_train_step(model, *_sgd(model, 0.05), ep)
    bloss = float(bstep(sh_b, rep_b, tgt, msk, msk)[0])
    after = [p.detach().clone() for p in model.parameters()]
    _barrier()
    timing["bench_gp_step_ms"] = synced_ms(
        lambda: bstep(sh_b, rep_b, tgt, msk, msk), dev, reps)
    _barrier()
    ex = exchange_ms(sh_b, rep_b, ep, "ep", H, dev, 2 * reps)
    timing["halo_exchange_ms_per_layer"] = ex["whole_ms"]
    timing["strip_exchange_ms_per_layer"] = ex["strip_ms"]
    timing["halo_exchange_ms_per_layer_back_to_back"] = ex[
        "whole_ms_back_to_back"]
    timing["strip_exchange_ms_per_layer_back_to_back"] = ex[
        "strip_ms_back_to_back"]
    timing["bench_strip_width"] = ex["strip_width"]
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]
                     + [torch.zeros(1, device=dev)])
    _barrier()
    timing["dp_allreduce_ms"] = synced_ms(
        lambda: all_reduce_sum(flat, ep.group("ep")), dev, 2 * reps)
    timing["dp_allreduce_ms_back_to_back"] = back_to_back_ms(
        lambda: all_reduce_sum(flat, ep.group("ep")), dev, 2 * reps)
    timing["dp_allreduce_floats"] = flat.numel()
    sloss = max_rel = of_max = float("nan")
    if main:
        bench_batch = _batch(arrays_b, tgt)
        ref, sloss = _single_step(lambda: _model(1, dev, H, 3),
                                  lambda m: _sgd(m, 0.05), bench_batch, dev)
        of_max, max_rel = param_errors(after, ref.parameters())
        checks["bench_loss"] = abs(bloss - sloss) < TOL * max(1.0,
                                                              abs(sloss))
        checks["bench_params"] = of_max <= TOL
        checks["bench_elementwise"] = max_rel < ELEMENT_TOL
        sstep = TrainStep(ref, *_sgd(ref, 0.05), make_loss_fn(ref.cfg))
        timing["bench_single_step_ms"] = synced_ms(
            lambda: sstep(pytree_tensors(bench_batch, dev)), dev, reps)
    aw = int(sh_b["f_atoms_win"].shape[1])
    bonds = int(sh_b["f_bonds"].shape[1] - 1)
    # a real bond's features hold its source atom's, never all zero
    real = [int(k) for k in (np.abs(sh_b["f_bonds"]).sum(-1) > 0).sum(1)]
    say(f"{tag} BENCH-SCALE halo train step: loss = {bloss:.6f} "
        f"(single-device {sloss:.6f}, max param rel err {of_max:.2e} of "
        f"each tensor's max, elementwise {max_rel:.2e}); {bonds} bonds/"
        f"shard (real {real}), hidden {H}, window {aw}")

    # 6. the byte model a layer (f32): the halo's two neighbour sends of
    # one (Aw, H) window, the edge-partitioned forward's ring all-reduce
    # of the (A, H) atom table, the dp step's ring all-reduce of the
    # gradients once a step
    A = arrays_b["f_atoms"].shape[0]
    halo_bytes = 2 * aw * H * 4
    psum_bytes = int(2 * (n - 1) / n * A * H * 4)
    n_params = sum(p.numel() for p in model.parameters())
    dp_bytes = int(2 * (n - 1) / n * n_params * 4)
    say(f"  NVLink per layer per card: halo 2x({aw},{H}) = "
        f"{halo_bytes / 1e6:.2f} MB vs psum ({A},{H}) all-reduce = "
        f"{psum_bytes / 1e6:.2f} MB ({psum_bytes / max(halo_bytes, 1):.1f}x);"
        f" DP grad all-reduce {dp_bytes / 1e6:.2f} MB/step (x3 layers for "
        f"halo/psum)")
    say(f"  measured ({backend}; synced, back to back): halo exchange a "
        f"layer {ex['whole_ms']:.3f}, {ex['whole_ms_back_to_back']:.3f} ms "
        f"whole window, {ex['strip_ms']:.3f}, "
        f"{ex['strip_ms_back_to_back']:.3f} ms strips of "
        f"{ex['strip_width']} rows; gradient all-reduce ({flat.numel()} "
        f"floats) {timing['dp_allreduce_ms']:.3f}, "
        f"{timing['dp_allreduce_ms_back_to_back']:.3f} ms; "
        f"step {timing['bench_gp_step_ms']:.2f} ms at {n} ranks, "
        f"{timing.get('bench_single_step_ms', float('nan')):.2f} ms on "
        f"one card")

    summary = {
        "n_devices": n, "dp_loss": dp_loss, "halo_loss": loss_h,
        "bench_halo_loss": bloss, "bench_single_loss": sloss,
        "bench_max_param_rel_err": max_rel,
        "bench_bonds_per_shard": bonds, "bench_real_bonds_per_shard": real,
        "bench_hidden": H,
        "atom_window": aw, "ici_halo_bytes_per_layer": halo_bytes,
        "ici_psum_bytes_per_layer": psum_bytes,
        "ici_dp_bytes_per_step": dp_bytes,
    }

    # 7. the 2-D (dp 2, ep n/2) step, overlapped strips against the whole
    # window
    if n >= 4 and n % 2 == 0:
        n_ep = n // 2
        mesh2d = make_mesh(n, ("dp", "ep"), shape=(2, n_ep))
        base = halo_smiles[:8]
        pad2 = dict(pad_atoms=256, pad_bonds=512, pad_mols=8)
        arr_a = mol2graph(base, **pad2).arrays()
        arr_b = mol2graph(list(reversed(base)), **pad2).arrays()
        sh2, rep2 = build_edge_shards_halo_dp([arr_a, arr_b], n_ep,
                                              atom_window=256)
        sw = halo_strip_width(sh2)
        t2 = np.arange(2 * len(base), dtype=np.float32).reshape(2, -1, 1)
        m2 = np.ones_like(t2)
        losses2, params2 = {}, {}
        for label, overlap in (("unoverlapped", False), ("overlap", True)):
            model = _model(0, dev, 32, 2, num_tasks=2)
            step2 = make_halo_dp_train_step(model, *_sgd(model, 0.1),
                                            mesh2d, overlap=overlap,
                                            strip_width=sw)
            t1 = time.perf_counter()
            losses2[label] = float(step2(sh2, rep2, t2, m2, m2)[0])
            timing[f"2d_{label}_first_step_ms"] = 1e3 * (
                time.perf_counter() - t1)
            params2[label] = [p.detach().clone() for p in model.parameters()]
        dl = abs(losses2["overlap"] - losses2["unoverlapped"])
        dp_ = max(float((a - b).abs().max()) for a, b in
                  zip(params2["overlap"], params2["unoverlapped"]))
        checks["overlap_2d"] = dl < OVERLAP_TOL and dp_ < OVERLAP_TOL
        if main:
            both = mol2graph(base + list(reversed(base)), pad_atoms=512,
                             pad_bonds=1024, pad_mols=16).arrays()
            ref, single = _single_step(
                lambda: _model(0, dev, 32, 2, 2), lambda m: _sgd(m, 0.1),
                _batch(both, t2.reshape(-1, 1)), dev)
            of_max2, _ = param_errors(params2["unoverlapped"],
                                      ref.parameters())
            checks["step_2d"] = (abs(losses2["unoverlapped"] - single)
                                 <= TOL * max(1.0, abs(single))
                                 and of_max2 <= TOL)
            say(f"{tag} 2D (dp=2, ep={n_ep}) halo train step: loss "
                f"{losses2['unoverlapped']:.6f} (one card {single:.6f}, "
                f"max param rel err {of_max2:.2e}); OVERLAPPED strip "
                f"exchange (sw={sw}) matches: {losses2['overlap']:.6f} "
                f"(loss {dl:.1e}, parameters {dp_:.1e} apart); strip "
                f"NVLink 2x({sw},{H}) = {2 * sw * H * 4 / 1e6:.2f} MB/layer "
                f"vs full-window {halo_bytes / 1e6:.2f} MB/layer")
        summary.update({
            "mesh_2d": [2, n_ep], "loss_2d": losses2["unoverlapped"],
            "loss_2d_overlap": losses2["overlap"], "strip_width": int(sw),
            "ici_strip_bytes_per_layer": 2 * sw * H * 4})

    # 8. atom_messages through the halo step
    if n >= 2:
        arr_am = mol2graph(halo_smiles, pad_atoms=max(256, 16 * n * 8),
                           pad_bonds=max(512, 32 * n * 8),
                           pad_mols=mh).arrays()
        mesh_am = make_mesh(n, ("dp", "ep"), shape=(1, n))
        sh_am, rep_am = build_edge_shards_halo_dp(
            [arr_am], n, atom_window=arr_am["f_atoms"].shape[0])

        def adam(model):
            return (build_optimizer("adam", model.parameters()),
                    constant_schedule(1e-3))

        model = _model(3, dev, 32, 3, atom_messages=True)
        step_am = make_halo_dp_train_step(model, *adam(model), mesh_am)
        t_am = np.arange(mh, dtype=np.float32)[None, :, None]
        m_am = np.ones_like(t_am)
        l_am = float(step_am(sh_am, rep_am, t_am, m_am, m_am)[0])
        summary["atom_messages_loss"] = l_am
        if main:
            ref, sl_am = _single_step(
                lambda: _model(3, dev, 32, 3, atom_messages=True), adam,
                _batch(arr_am, t_am[0]), dev)
            of_max_am, rel_am = param_errors(model.parameters(),
                                             ref.parameters())
            checks["atom_messages"] = (abs(l_am - sl_am) < TOL * max(
                1.0, abs(sl_am)) and rel_am < ELEMENT_TOL)
            say(f"{tag} atom_messages halo train step: loss {l_am:.6f} "
                f"(single-device {sl_am:.6f}, max param rel err "
                f"{rel_am:.2e}, of each tensor's max {of_max_am:.2e})")
            summary.update({"atom_messages_single_loss": sl_am,
                            "atom_messages_max_param_rel_err": rel_am})

    _sync(dev)
    mine = {"rank": rank, "backend": backend, "device": str(dev),
            "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "launches": bm.launch_counts()}
    ranks = [mine]
    if dist.is_initialized():
        ranks = [None] * n
        dist.all_gather_object(ranks, mine)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in mine["launches"]}
    summary.update({
        "backend": backend, "device": mine["name"],
        "ranks": [{k: r[k] for k in ("rank", "backend", "device", "name")}
                  for r in ranks],
        **timing, "launches": launches, "checks": checks,
        "ok": all(checks.values())})
    if main:
        print("DRYRUN_SUMMARY " + json.dumps(summary), flush=True)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="every rank's device: cuda (one rank a card "
                             "over NCCL) or cpu (gloo)")
    parser.add_argument("--bench_hidden", type=int, default=300)
    parser.add_argument("--bench_pairs", type=int, default=4096,
                        help="bond pairs a rank of the bench-scale batch")
    parser.add_argument("--reps", type=int, default=10,
                        help="timed calls a measurement (median)")
    parser.add_argument("--out", help="rank 0 writes the summary here")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        summary = dryrun_multichip(args.device, args.bench_hidden,
                                   args.bench_pairs, args.reps)
        rank = world()[0]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    if summary["ok"]:
        return 0
    print("dryrun_multichip: a check failed: "
          + ", ".join(k for k, ok in summary["checks"].items() if not ok),
          file=sys.stderr, flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
