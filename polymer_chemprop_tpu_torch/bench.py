"""Benchmark: wD-MPNN training and serving throughput of the port on the card.

The port's counterpart of the JAX package's root ``bench.py``. It times the
step the trainer runs (forward, backward and Adam: train/step.py
``TrainStep`` with ``make_loss_fn``, Noam schedule, ``build_optimizer
("adam")``) on a large batch built from the regression fixture molecules,
hidden 300 and depth 3 (the reference's default model), and reports real
(unpadded) directed-bond edges processed per second.

    python -m polymer_chemprop_tpu_torch.bench [--predict | --polymer |
        --bf16 | --wide | --fastband | --baseline | --compare]
        [--device cuda|cpu] [--molecules 1024] [--hidden 300] [--depth 3]
        [--trials 5] [--seed 0]

The last line of output is one JSON object: ``metric``, ``value``, ``unit``
(``edges/s``, or ``mol/s`` with ``--predict``), ``vs_baseline``,
``step_ms``, ``real_edges`` and ``padded_edges``; a training line also
carries its first step's ``first_loss`` and ``first_gnorm``.

* The batch (:func:`load_batch`) is ``probes/bench_batch.py``'s: the first
  N molecules of tests/data/regression.csv, repeated (1,024 give B =
  28,032 padded bonds, A = 13,696 atoms), or with ``--polymer`` the
  copolymer ensembles of :func:`polymer_smiles`. It is staged on the
  device once, in the sorted layout, before the timed window.
  ``padded_edges`` is the port's B: the JAX bench pads to a multiple of
  1,024 (28,672) for its 256-row TPU tiles, and the CUDA kernels need no
  such padding.
* The layer form follows from the configuration alone
  (``EncoderConfig.layer_form``): the default line and ``--polymer`` run
  form ``rev`` at ``band_precision`` "high" (rows 1, 2 and 3 and the
  molecule readout), ``--fastband`` the same at "default", ``--bf16``
  (bfloat16 linear layers) and ``--wide`` (hidden 2,400, depth 6: above
  the 1,495 that ``fused_layer_fits`` allows) form ``plain`` (rows 6, 5
  and 3). ``--predict`` is the serving forward: eval mode under
  ``torch.inference_mode()`` with ``postprocess_preds``, as
  train/predict.py runs it.
* ``vs_baseline`` is the port step's edges/s over the yardstick's
  (:func:`yardstick`, ``--baseline``: the reference-equivalent torch step,
  ``index_add_`` aggregation as the reference's mpn.py:110-131), on the
  same batch, width and depth, timed on the same device in the same call.
  ``--compare`` prints the yardstick's line, then the port step's.
  ``--predict`` has none (``null``).
* The JAX bench's ``--xla`` has no counterpart: the XLA segment path is
  TPU machinery, replaced by design with the CSR kernels.

Timing: the first step (the kernels' build, the allocator's warm-up) is
untimed and its seconds printed apart. Then ``--trials`` trials of about
:data:`TRIAL_S` seconds of steps each, each ending in
``torch.cuda.synchronize()`` and timed with the host clock; ``step_ms`` is
the median trial's time a step, and a ``[spread]`` line gives the
quartiles. With ``--device cpu`` the same code runs the kernels' plain
versions under the host clock alone: those are host times, and the line's
``metric`` says so.

The launches of the port's kernel wrappers in the timed window are
printed per step (``[bench] kernels per step``). On the card, a line whose
layer form's kernels did not launch there ends the run with an error; a
kernel that fails to build or launch does too. There is no fallback.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .features import FeaturizationConfig, GraphBatch, mol2graph
from .models.encoder import EncoderConfig, batch_to_tensors
from .models.init import init_model
from .models.model import ModelConfig, MoleculeModel, postprocess_preds
from .ops import band_mpnn as bm
from .probes.bench_batch import bench_smiles
from .train.predict import resolve_device
from .train.scheduler import build_optimizer, build_schedule
from .train.step import TrainStep, make_loss_fn

BATCH_MOLS = 1024
HIDDEN = 300
DEPTH = 3
WIDE_HIDDEN, WIDE_DEPTH = 2400, 6   # the top of the reference's search space
TRIAL_S = 0.5                       # seconds of steps in a trial
SCHEDULE = dict(init_lr=1e-4, max_lr=1e-3, final_lr=1e-4, warmup_epochs=2,
                epochs=30, steps_per_epoch=100)
# the line of each flag: its overrides of :func:`train_setup`'s defaults
VARIANTS = {"default": {}, "fastband": dict(precision="default"),
            "polymer": dict(polymer=True), "bf16": dict(bf16=True),
            "wide": dict(hidden=WIDE_HIDDEN, depth=WIDE_DEPTH)}
# the wrappers a training line must launch in its timed window, by layer
# form; a forward launches the first and the last two
FORM_KERNELS = {"rev": ("band_rev_layer", "band_rev_bwd", "atom_readout",
                        "molecule_readout_sorted"),
                "plain": ("band_agg", "band_bwd", "atom_readout",
                          "molecule_readout_sorted")}


_MONOMERS = ["[*:1]c1ccc([*:2])cc1", "[*:1]CO[*:2]", "[*:1]C(C)C[*:2]",
             "[*:1]c1cc(F)c([*:2])cc1F", "[*:1]c1ccc(-c2ccc([*:2])s2)s1"]


def polymer_smiles(n: int) -> List[str]:
    """Deterministic wD-MPNN copolymer ensemble strings (stochastic
    inter-monomer bond weights 0.5, stoichiometries 0.1-0.9, Xn from 1 to
    400): the JAX bench's ``_polymer_smiles``."""
    out = []
    for i in range(n):
        sa = _MONOMERS[i % len(_MONOMERS)]
        sb = _MONOMERS[(i // len(_MONOMERS) + i + 1) % len(_MONOMERS)]
        sb = sb.replace("[*:1]", "[*:3]").replace("[*:2]", "[*:4]")
        w = [0.1, 0.25, 0.5, 0.75, 0.9][i % 5]
        xn = [1, 5, 20, 100, 400][(i // 5) % 5]
        out.append(f"{sa}.{sb}|{w}|{1 - w}|<1-3:0.5:0.5<2-4:0.5:0.5~{xn}")
    return out


def load_batch(n_molecules: int = BATCH_MOLS,
               polymer: bool = False) -> GraphBatch:
    """The featurized bench batch (the port's default padding); prints the
    host's featurization time."""
    smiles = polymer_smiles(n_molecules) if polymer \
        else bench_smiles(n_molecules)
    t0 = time.perf_counter()
    gb = mol2graph(smiles, FeaturizationConfig(polymer=polymer))
    print(f"[host] featurized {n_molecules} "
          f"{'copolymers' if polymer else 'molecules'} in "
          f"{time.perf_counter() - t0:.3f} s (pure Python, one thread)",
          flush=True)
    return gb


def model_config(gb: GraphBatch, hidden: int = HIDDEN, depth: int = DEPTH,
                 precision: str = "high", bf16: bool = False) -> ModelConfig:
    """The bench's model (the JAX bench's): regression, one task, FFN 2 x
    ``hidden``, relu, mean, no bias, dropout 0."""
    enc = EncoderConfig(atom_fdim=gb.f_atoms.shape[1],
                        bond_fdim=gb.f_bonds.shape[1], hidden_size=hidden,
                        depth=depth,
                        compute_dtype="bfloat16" if bf16 else "float32",
                        band_precision=precision)
    return ModelConfig(encoder=enc, dataset_type="regression", num_tasks=1,
                       ffn_hidden_size=hidden)


def make_model(cfg: ModelConfig, seed: int = 0) -> MoleculeModel:
    """Xavier-normal weights from a CPU ``torch.Generator`` seeded with
    ``seed``: the same parameters whatever device the model goes to."""
    return init_model(MoleculeModel(cfg),
                      torch.Generator().manual_seed(seed))


def targets(n_molecules: int) -> np.ndarray:
    """The regression targets of the JAX bench (bench.py:122-128)."""
    return np.random.default_rng(0).normal(
        size=(n_molecules, 1)).astype(np.float32)


def train_setup(gb: GraphBatch, device, hidden: int = HIDDEN,
                depth: int = DEPTH, precision: str = "high",
                bf16: bool = False, seed: int = 0
                ) -> Tuple[TrainStep, Dict]:
    """``(step, batch)``: the trainer's step over the model of
    :func:`model_config` on ``device``, and the bench batch staged there in
    the sorted layout with the targets, mask and loss weights."""
    cfg = model_config(gb, hidden, depth, precision, bf16)
    model = make_model(cfg, seed).to(device)
    step = TrainStep(model, build_optimizer("adam", model.parameters()),
                     build_schedule("noam", **SCHEDULE), make_loss_fn(cfg))
    M = gb.n_mols
    ones = torch.ones((M, 1), device=device)
    batch = {"graphs": [batch_to_tensors(gb.arrays(sorted_aux=True),
                                         device)],
             "targets": torch.as_tensor(targets(M), device=device),
             "mask": ones, "weights": ones.clone()}
    return step, batch


def yardstick(model: MoleculeModel, gb: GraphBatch, device
              ) -> Callable[[], torch.Tensor]:
    """The reference-equivalent torch train step (the JAX bench's
    ``bench_baseline_torch``, bench.py:244-295), on ``device``, from a copy
    of ``model``'s weights: ``nn.Linear`` layers, ``index_add_``
    aggregation on the natural-order ``b2a``, ``b2dst``, ``b2revb`` and
    ``a2mol`` as the reference's mpn.py:110-131 does, the mean readout, the
    MSE loss and ``torch.optim.Adam``. Returns ``step() -> loss``.

    A yardstick for timing only: no training or serving path calls it. Its
    ``index_add_`` atomics are the reference's, and so exempt from the
    rule that no float sum of the port's own steps adds with atomics
    (ROADMAP §3). ``model`` must be the bench's configuration (no bias,
    relu, mean, two FFN layers); the targets are :func:`targets`."""
    enc = model.encoders[0]
    Wi, Wh, Wo = (copy.deepcopy(m).to(device)
                  for m in (enc.W_i, enc.W_h, enc.W_o))
    f1, f2 = (copy.deepcopy(m).to(device) for m in model.ffn)
    depth = model.cfg.encoder.depth
    a = gb.arrays()
    T = lambda x, dtype=None: torch.as_tensor(x, dtype=dtype, device=device)
    fa, fb = T(a["f_atoms"]), T(a["f_bonds"])
    wb, wa = T(a["w_bonds"]), T(a["w_atoms"])
    b2a, b2dst, b2revb, a2mol = (T(a[k], torch.long) for k in (
        "b2a", "b2dst", "b2revb", "a2mol"))
    A, M, H = fa.shape[0], gb.n_mols, Wh.weight.shape[0]
    model_params = (list(Wi.parameters()) + list(Wh.parameters()) +
                    list(Wo.parameters()) + list(f1.parameters()) +
                    list(f2.parameters()))
    opt = torch.optim.Adam(model_params, lr=1e-3)
    target = T(targets(M))

    def train_step() -> torch.Tensor:
        inp = Wi(fb)
        msg = torch.relu(inp)
        for _ in range(depth - 1):
            amsg = torch.zeros(A, H, device=device).index_add_(
                0, b2dst, msg * wb[:, None])
            msg = torch.relu(inp + Wh(amsg[b2a] - msg[b2revb]))
        amsg = torch.zeros(A, H, device=device).index_add_(
            0, b2dst, msg * wb[:, None])
        ah = torch.relu(Wo(torch.cat([fa, amsg], 1)))
        mv = torch.zeros(M, H, device=device).index_add_(
            0, a2mol, ah * wa[:, None])
        den = torch.zeros(M, device=device).index_add_(
            0, a2mol, wa).clamp(min=1e-12)
        preds = f2(torch.relu(f1(mv / den[:, None])))
        loss = ((preds - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(label: str, fn: Callable[[], object], device: torch.device,
               trials: int, window_start: Callable[[], object] = lambda: None
               ) -> Tuple[object, float, float, int]:
    """``(first output, first call's s, median s a call, calls timed)``:
    the first call untimed, one more to size the trials, then
    ``window_start()`` and ``trials`` trials of about :data:`TRIAL_S` each,
    each ending in a device sync, on the host clock."""
    t0 = time.perf_counter()
    first = fn()
    _sync(device)
    first_s = time.perf_counter() - t0
    print(f"[bench] {label}: first call {first_s:.3f} s (kernel build and "
          "warm-up; not timed)", flush=True)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    n = max(1, int(TRIAL_S / max(time.perf_counter() - t0, 1e-6)))
    window_start()
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        times.append((time.perf_counter() - t0) / n)
    lo, q1, med, q3, hi = np.percentile(np.array(times) * 1e3,
                                        [0, 25, 50, 75, 100])
    clock = "host clock, synced" if device.type == "cuda" \
        else "host clock (cpu)"
    print(f"[spread] {label}: min {lo:.4f} q1 {q1:.4f} median {med:.4f} "
          f"q3 {q3:.4f} max {hi:.4f} ms a call over {trials} trials of {n} "
          f"calls, {clock}", flush=True)
    return first, first_s, statistics.median(times), n * trials


def device_name(device: torch.device, port: bool = True) -> str:
    """The device for a line's ``metric``; on the CPU, that its clock is
    the host's and (``port``) that the kernels ran their plain versions."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu, host clock" + (", the kernels' plain versions" if port
                                else "")


def _counts() -> Dict[str, int]:
    counts = bm.launch_counts()
    counts.update({f"{k} (tensor cores)": v
                   for k, v in bm.tc_launch_counts().items()})
    return counts


def check_launches(label: str, before: Dict[str, int], steps: int,
                   required: Sequence[str], device: torch.device
                   ) -> Dict[str, float]:
    """The wrappers' launches a step since ``before``, printed; on the card,
    raises unless each of ``required`` launched."""
    after = _counts()
    per_step = {k: (after[k] - before[k]) / steps for k in after
                if after[k] != before[k]}
    shown = ", ".join(f"{k} {v:g}" for k, v in per_step.items()) or \
        "none (CPU tensors run the plain versions)"
    print(f"[bench] kernels per step ({label}): {shown}", flush=True)
    if device.type == "cuda":
        missing = [k for k in required if not per_step.get(k)]
        if missing:
            raise RuntimeError(f"{label}: the kernels {missing} did not "
                               "launch in the timed window")
    return per_step


def required_kernels(cfg: ModelConfig, training: bool = True
                     ) -> Tuple[str, ...]:
    """The wrappers (:func:`_counts`' names) that a step of ``cfg`` must
    launch: its layer form's, the fused layer on the tensor cores at
    "high" and "default"."""
    enc = cfg.encoder
    names = FORM_KERNELS[enc.layer_form()]
    if not training:
        names = (names[0],) + names[2:]
    tc = tuple(f"{k} (tensor cores)" for k in names
               if k in bm.tc_launch_counts()
               and enc.band_precision != "highest")
    return names + tc


def _memory_line(label: str, device: torch.device) -> None:
    if device.type == "cuda":
        print(f"[bench] {label}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device)} bytes", flush=True)
        torch.cuda.reset_peak_memory_stats(device)


def _form_text(cfg: ModelConfig) -> str:
    enc = cfg.encoder
    form = enc.layer_form()
    text = f"form {form}"
    if form == "plain" and not bm.fused_layer_fits(enc.hidden_size):
        text += (f" (hidden {enc.hidden_size} above fused_layer_fits' 1495:"
                 " band_agg + W_h in PyTorch)")
    return (f"{text}, band_precision {enc.band_precision}, "
            f"{enc.compute_dtype}")


def timed_step(gb: GraphBatch, device, trials: int = 5, hidden: int = HIDDEN,
               depth: int = DEPTH, precision: str = "high",
               bf16: bool = False, seed: int = 0) -> Dict[str, object]:
    """The port's train step on ``gb``, timed (:func:`time_calls`), its
    kernels checked (:func:`check_launches`): ``step_ms``, ``first_s``,
    ``first_loss``, ``first_gnorm``, ``launches`` (a step), ``metric_tail``
    (form, precision, dtype and device for the line's ``metric``)."""
    device = torch.device(device)
    step, batch = train_setup(gb, device, hidden, depth, precision, bf16,
                              seed)
    cfg = step.model.cfg
    label = f"train step, {gb.n_mols} molecules, hidden {hidden}"
    before: Dict[str, int] = {}
    (loss, gnorm), first_s, dt, calls = time_calls(
        label, lambda: step(batch), device, trials,
        lambda: before.update(_counts()))
    launches = check_launches(label, before, calls, required_kernels(cfg),
                              device)
    _memory_line(label, device)
    return {"step_ms": dt * 1e3, "first_s": first_s,
            "first_loss": float(loss), "first_gnorm": float(gnorm),
            "launches": launches,
            "metric_tail": f"{_form_text(cfg)}, {device_name(device)}"}


def _edges(gb: GraphBatch) -> Dict[str, int]:
    # slot 0 is the padding row (bench.py:98)
    return {"real_edges": gb.n_bonds_real - 1,
            "padded_edges": int(gb.f_bonds.shape[0])}


def bench_baseline(gb: GraphBatch, device, trials: int = 5,
                   hidden: int = HIDDEN, depth: int = DEPTH,
                   seed: int = 0) -> Dict[str, object]:
    """The yardstick's line: :func:`yardstick` from the weights of the
    bench's model at ``seed``, timed as the port step is."""
    device = torch.device(device)
    step = yardstick(make_model(model_config(gb, hidden, depth), seed), gb,
                     device)
    _, _, dt, _ = time_calls(
        f"yardstick, {gb.n_mols} molecules, hidden {hidden}", step, device,
        trials)
    _memory_line("yardstick", device)
    edges = _edges(gb)
    return {"metric": "reference-equivalent torch train step (index_add_ "
                      f"aggregation, batch {gb.n_mols} mols, hidden "
                      f"{hidden}, depth {depth}, "
                      f"{device_name(device, port=False)})",
            "value": edges["real_edges"] / dt, "unit": "edges/s",
            "vs_baseline": 1.0, "step_ms": dt * 1e3, **edges}


def bench_step(gb: GraphBatch, device, baseline: Dict[str, object],
               trials: int = 5, hidden: int = HIDDEN, depth: int = DEPTH,
               precision: str = "high", bf16: bool = False, seed: int = 0
               ) -> Dict[str, object]:
    """The port's train-step line; ``vs_baseline`` against ``baseline``,
    :func:`bench_baseline`'s line on the same batch, width and depth."""
    r = timed_step(gb, device, trials, hidden, depth, precision, bf16, seed)
    edges = _edges(gb)
    value = edges["real_edges"] / (r["step_ms"] * 1e-3)
    return {"metric": "wD-MPNN train-step throughput (real directed edges/s,"
                      f" batch {gb.n_mols} mols, hidden {hidden}, depth "
                      f"{depth}, {r['metric_tail']})",
            "value": value, "unit": "edges/s",
            "vs_baseline": value / baseline["value"],
            "step_ms": r["step_ms"], **edges,
            "first_loss": r["first_loss"], "first_gnorm": r["first_gnorm"]}


def bench_predict(gb: GraphBatch, device, trials: int = 5,
                  hidden: int = HIDDEN, depth: int = DEPTH,
                  seed: int = 0) -> Dict[str, object]:
    """The serving line: the eval-mode forward with ``postprocess_preds``
    under ``torch.inference_mode()``, molecules/s."""
    device = torch.device(device)
    cfg = model_config(gb, hidden, depth)
    model = make_model(cfg, seed).to(device).eval()
    graphs = [batch_to_tensors(gb.arrays(sorted_aux=True), device)]

    @torch.inference_mode()
    def forward():
        return postprocess_preds(model(graphs), cfg)

    label = f"serving forward, {gb.n_mols} molecules, hidden {hidden}"
    before: Dict[str, int] = {}
    preds, _, dt, calls = time_calls(label, forward, device, trials,
                                     lambda: before.update(_counts()))
    if preds.shape != (gb.n_mols, 1) or not torch.isfinite(preds).all():
        raise RuntimeError(f"{label}: predictions of shape "
                           f"{tuple(preds.shape)}, finite "
                           f"{bool(torch.isfinite(preds).all())}")
    check_launches(label, before, calls, required_kernels(cfg, False),
                   device)
    _memory_line(label, device)
    edges = _edges(gb)
    return {"metric": "wD-MPNN inference throughput (molecules/s, batch "
                      f"{gb.n_mols} mols, hidden {hidden}, depth {depth}, "
                      f"{_form_text(cfg)}, {device_name(device)})",
            "value": gb.n_mols / dt, "unit": "mol/s", "vs_baseline": None,
            "step_ms": dt * 1e3, "edges_per_s": edges["real_edges"] / dt,
            **edges}


def card_line() -> str:
    """What ``nvidia-smi --query-gpu=name,power.limit`` gives."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    line = p.add_mutually_exclusive_group()
    for flag in ("predict", "polymer", "bf16", "wide", "fastband",
                 "baseline", "compare"):
        line.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--molecules", type=int, default=BATCH_MOLS)
    p.add_argument("--hidden", type=int, default=None,
                   help=f"default {HIDDEN} ({WIDE_HIDDEN} with --wide)")
    p.add_argument("--depth", type=int, default=None,
                   help=f"default {DEPTH} ({WIDE_DEPTH} with --wide)")
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def line_config(args: argparse.Namespace) -> Tuple[bool, Dict[str, object]]:
    """``(polymer, keywords of train_setup)`` of the line the flags pick."""
    variant = next((k for k in VARIANTS if getattr(args, k, False)),
                   "default")
    kw = dict(VARIANTS[variant])
    polymer = kw.pop("polymer", False)
    kw.update({k: v for k, v in (("hidden", args.hidden),
                                 ("depth", args.depth)) if v is not None})
    return polymer, dict(kw, seed=args.seed)


def main(argv: Optional[Sequence[str]] = None,
         batch: Optional[GraphBatch] = None) -> List[Dict[str, object]]:
    """Runs the line the flags pick and prints it as JSON (``--compare``:
    the yardstick's line, then the port step's); returns the lines.
    ``batch``, when given, is the line's :func:`load_batch` featurized
    beforehand (a caller that runs several lines)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    polymer, kw = line_config(args)
    size = {k: kw.pop(k) for k in ("hidden", "depth", "seed") if k in kw}
    if device.type == "cuda":
        print(card_line(), flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    gb = load_batch(args.molecules, polymer) if batch is None else batch
    if gb.n_mols != args.molecules:
        raise ValueError(f"a batch of {gb.n_mols} molecules given for "
                         f"--molecules {args.molecules}")
    if args.predict:
        lines = [bench_predict(gb, device, args.trials, **size)]
    elif args.baseline:
        lines = [bench_baseline(gb, device, args.trials, **size)]
    else:
        base = bench_baseline(gb, device, args.trials, **size)
        print(f"[bench] yardstick {base['value']:.1f} edges/s, "
              f"{base['step_ms']:.4f} ms a step", flush=True)
        line = bench_step(gb, device, base, args.trials, **size, **kw)
        lines = [base, line] if args.compare else [line]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
