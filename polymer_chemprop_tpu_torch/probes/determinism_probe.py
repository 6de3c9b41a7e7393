"""Whether one seed gives one result on the card: each main path run twice
in torch's default mode, held operator by operator.

Every case runs twice under :class:`OpLog`, a ``TorchDispatchMode`` that
records each operator the run dispatches (its name, the port's source line
that called it, and a hash of every float output on the device), and once
under ``torch.profiler``. The report names, for each case:

* the first operator whose output differs between the two runs, with its
  source line, and how many of the run's outputs differ; and whether the
  case's results (scores, epoch logs, predictions, parameters) are equal;
* the float sums that add in no fixed order: the operators that
  :func:`float_atomic` flags (``index_add``, ``scatter_add``, a summing
  ``scatter_reduce``, an accumulating ``index_put``) with their source
  lines, and the device kernels of the profile that
  :func:`atomic_kernel` flags.

The cases are the port's entry points at full width (hidden 300, depth 3,
batch 50, seed 0, ``band_precision`` "high"): the EA/IP weighted arm for
``--eaip_epochs`` epochs (``polymer_goldens.run_arm``); one epoch of the
default configuration on tests/data/regression.csv and of the polymer
configuration on 200 synthetic copolymers, each then serving its CSV
through ``make_predictions`` from the checkpoint it wrote; one epoch of
``atom_messages`` on regression.csv's first 60 molecules (one step); one
of multiclass on the JAX package's integration dataset (regression.csv's
first 120 SMILES, class ``i % 3``; two steps); and one stage-2
``ssl_pretrain`` step on 50 copolymers. The profile of each training case
runs one step (the first 60 rows).

Run on the card (the cases by name, all by default)::

    python -m polymer_chemprop_tpu_torch.probes.determinism_probe \\
        [--out DIR] [cases ...]

``--device cpu`` with a small ``--hidden_size`` rehearses it (the plain
versions; sums on the CPU run in one order). The runs, and the operators,
kernels and divergences of every case (``determinism.json``), go to
``DIR`` (default ``build/determinism``). ``--speed`` measures instead the
default configuration's cached training epoch on regression.csv (steps/s
of each of three epochs after a featurizing one, host clock, synced; the
device's idle share in a fourth under the profiler), to hold one tree's
speed against another's in one call.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import hashlib
import json
import os
import shutil
import sys
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

PACKAGE = Path(__file__).resolve().parents[1]
DATA = PACKAGE.parent / "tests" / "data"
ATEN = torch.ops.aten
# operators that add floats into an output: on CUDA with atomics, in no
# fixed order (the reduction of scatter_reduce and index_put_'s accumulate
# flag are read from the call)
_SUMMING = {ATEN.index_add.default, ATEN.index_add_.default,
            ATEN.index_add.out, ATEN.scatter_add.default,
            ATEN.scatter_add_.default, ATEN.embedding_dense_backward.default}
_REDUCING = {ATEN.scatter_reduce.two, ATEN.scatter_reduce_.two,
             ATEN.scatter.reduce, ATEN.scatter_.reduce,
             ATEN.scatter.value_reduce, ATEN.scatter_.value_reduce}
_ACCUMULATING = {ATEN.index_put.default, ATEN.index_put_.default,
                 ATEN._index_put_impl_.default, ATEN.put_.default,
                 ATEN.put.default}
# device kernels that add with atomics: index_add_ (indexFunc*),
# index_put_ with accumulate (indexing_backward_kernel), scatter_add_ and
# gather's VJP (the scatter-gather kernel with ReduceAdd), embedding's VJP
_ATOMIC_KERNELS = ("indexFuncSmallIndex", "indexFuncLargeIndex",
                   "indexing_backward_kernel", "embedding_backward",
                   "scatter_add", "ReduceAdd", "ReduceMean", "atomic")
_FLOAT_TYPES = ("float", "double", "Half", "BFloat16")
_INT_TYPES = ("<long", "<int", "<unsigned", "<short", "<signed char",
              "<bool", "<unsigned char")


def float_atomic(func, args, kwargs, out) -> bool:
    """Whether ``func`` adds floats into its output in no fixed order on
    CUDA: index_add, scatter_add, a summing scatter_reduce or scatter, an
    accumulating index_put or put, embedding's VJP, on a float output."""
    first = out[0] if isinstance(out, (tuple, list)) else out
    if not (isinstance(first, torch.Tensor) and first.is_floating_point()):
        return False
    if func in _SUMMING:
        return True
    if func in _REDUCING:
        reduce = kwargs.get("reduce", args[4] if len(args) > 4 else None)
        return reduce in ("sum", "add", "mean")
    if func in _ACCUMULATING:
        pos = 2 if func in (ATEN.put_.default, ATEN.put.default) else 3
        return bool(kwargs.get("accumulate",
                               args[pos] if len(args) > pos else False))
    return False


def atomic_kernel(name: str) -> bool:
    """Whether a device kernel's name is one that adds floats with
    atomics (integer sums, such as a count, are exact in any order)."""
    if not any(p in name for p in _ATOMIC_KERNELS):
        return False
    return not any(t in name for t in _INT_TYPES) \
        or any(t in name for t in _FLOAT_TYPES)


def _site() -> str:
    """The innermost frame in the package outside this probe: the source
    line that dispatched the operator (``backward`` for the autograd
    engine's own calls)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if str(PACKAGE) in path and "probes" not in path:
            return (f"{os.path.relpath(path, PACKAGE.parent)}:{f.f_lineno}"
                    f" {f.f_code.co_name}")
        f = f.f_back
    return "backward"


class OpLog(TorchDispatchMode):
    """Records every dispatched operator: their count (``ops``), the float
    atomics (``atomics``: (name, site)), and with ``hashes`` on the
    ``names`` and ``sites`` of float outputs on ``device`` and a hash
    (the sum of the int32 words) of each float output on ``device``, kept
    on the device until :meth:`digests`. View operators, and those that
    only allocate (``empty``), are skipped."""

    def __init__(self, device, hashes: bool = True):
        super().__init__()
        self.device = torch.device(device)
        self.hashes = hashes
        self.ops = 0
        self.names: List[str] = []
        self.sites: List[str] = []
        self.digest: List[torch.Tensor] = []
        self.atomics: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or "empty" in func.__name__:
            return out      # a view, or memory not written yet
        self.ops += 1
        site = _site()
        if float_atomic(func, args, kwargs, out):
            self.atomics[(str(func), site)] += 1
        if self.hashes:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for t in outs:
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.device.type == self.device.type
                        and t.numel()):
                    words = t.detach().contiguous().reshape(-1)
                    words = (words.view(torch.int32) if
                             words.element_size() == 4 else
                             words.view(torch.uint8))
                    self.names.append(str(func))
                    self.sites.append(site)
                    self.digest.append(words.sum(dtype=torch.int64))
        return out

    def digests(self) -> np.ndarray:
        if not self.digest:
            return np.zeros(0, np.int64)
        return torch.stack(self.digest).cpu().numpy()


def first_divergence(a: OpLog, b: OpLog) -> Optional[Dict]:
    """Where two logged runs first differ: the index, operator and site of
    the first output whose hash differs (or where the runs took other
    operators), and how many outputs differ. None when they agree."""
    da, db = a.digests(), b.digests()
    n = min(len(da), len(db))
    same_ops = a.names[:n] == b.names[:n]
    differ = np.nonzero(da[:n] != db[:n])[0]
    if same_ops and not differ.size and len(da) == len(db):
        return None
    if not same_ops:
        i = next(k for k in range(n) if a.names[k] != b.names[k])
        return {"index": i, "op": a.names[i], "site": a.sites[i],
                "other_op": b.names[i], "outputs": n,
                "differing": int(differ.size)}
    i = int(differ[0]) if differ.size else n
    return {"index": i, "op": a.names[i] if i < n else None,
            "site": a.sites[i] if i < n else None, "outputs": n,
            "differing": int(differ.size),
            "before": a.sites[max(0, i - 3):i]}


def profile_kernels(fn: Callable[[], object], device) -> Counter:
    """The device kernels ``fn()`` launched, by name, from torch.profiler
    (empty on the CPU, or when the profiler sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    kernels = Counter()
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels[e.name] += 1
    return kernels


def params_sha(ckpt: str) -> str:
    """SHA-256 of a checkpoint's parameter arrays, in file order."""
    from polymer_chemprop_tpu_torch.utils.checkpoint import load_checkpoint
    params = load_checkpoint(ckpt)[0]
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(np.ascontiguousarray(x).tobytes())
    walk(params)
    return h.hexdigest()


def run_record(save_dir: str) -> Dict:
    """What a ``cross_validate`` run left: every fold's epoch log
    (``train_val_loss_log.csv``), test scores and best model's parameter
    SHA-256."""
    out = {}
    for fold in sorted(d for d in os.listdir(save_dir)
                       if d.startswith("fold_")):
        model = os.path.join(save_dir, fold, "model_0")
        with open(os.path.join(model, "train_val_loss_log.csv")) as f:
            log = [dict(r) for r in csv.DictReader(f)]
        with open(os.path.join(save_dir, fold, "test_scores.json")) as f:
            scores = json.load(f)
        out[fold] = {"epochs": log, "test": scores,
                     "param_sha": params_sha(
                         os.path.join(model, "best_model.ckpt"))}
    return out


def multiclass_csv(path: str) -> None:
    """The JAX package's multiclass integration dataset
    (tests/test_integration.py:97-110): regression.csv's first 120
    SMILES, class ``i % 3``."""
    with open(DATA / "regression.csv") as f, open(path, "w",
                                                   newline="") as g:
        r, w = csv.reader(f), csv.writer(g)
        next(r)
        w.writerow(["smiles", "cls"])
        for i, row in enumerate(r):
            if i >= 120:
                break
            w.writerow([row[0], i % 3])


@dataclasses.dataclass
class Case:
    """One case: ``run(save_dir, profiled)`` runs it into ``save_dir``
    (one step when ``profiled``) and returns what two runs must agree
    on."""
    name: str
    run: Callable[[str, bool], Dict]


def cases(device: str, root: str, hidden: int, eaip_epochs: int
          ) -> List[Case]:
    from polymer_chemprop_tpu_torch import eaip
    from polymer_chemprop_tpu_torch import polymer_goldens as pg
    from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
    from polymer_chemprop_tpu_torch.probes.bench_batch import copolymer_csv
    from polymer_chemprop_tpu_torch.ssl import SSLConfig, ssl_pretrain
    from polymer_chemprop_tpu_torch.train.cross_validate import (
        cross_validate)
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions)
    os.makedirs(root, exist_ok=True)
    poly_csv = os.path.join(root, "copolymers.csv")
    copolymer_csv(poly_csv, with_target=True)
    mc_csv = os.path.join(root, "multiclass.csv")
    multiclass_csv(mc_csv)
    base = dict(hidden_size=hidden, ffn_hidden_size=hidden, depth=3,
                batch_size=50, seed=0, pytorch_seed=0, num_folds=1,
                num_workers=1, device=device, quiet=True)

    def train(data_path, epochs=1, **kw):
        def run(save_dir, profiled):
            cfg = dict(base, data_path=data_path, save_dir=save_dir,
                       epochs=epochs, **kw)
            if profiled:
                cfg.update(epochs=1, max_data_size=60)
            cross_validate(TrainConfig(**cfg))
            return run_record(save_dir)
        return run

    def serve(data_path, ckpt_run):
        """Serving ``data_path`` from the checkpoint of the first run of
        the training case ``ckpt_run`` (which runs before it)."""
        def run(save_dir, profiled):
            ckpt = os.path.join(root, f"{ckpt_run}_0", "fold_0", "model_0",
                                "best_model.ckpt")
            test_path = data_path
            if profiled:     # one batch
                test_path = os.path.join(save_dir, "batch.csv")
                with open(data_path) as f, open(test_path, "w") as g:
                    g.writelines(f.readlines()[:51])
            preds = make_predictions(PredictConfig(
                test_path=test_path, checkpoint_path=ckpt,
                preds_path=os.path.join(save_dir, "preds.csv"),
                batch_size=50, num_workers=1, device=device))
            return {"preds": np.asarray(preds, float).tolist()}
        return run

    def eaip_arm(save_dir, profiled):
        over = dict(epochs=1, max_data_size=60) if profiled else \
            dict(epochs=eaip_epochs)
        if hidden != 300:
            over.update(hidden_size=hidden, ffn_hidden_size=hidden)
        pg.run_arm(eaip.generate(blind_weights=False), save_dir, device,
                   **over)
        return run_record(save_dir)

    def ssl_step(save_dir, profiled):
        path = ssl_pretrain(SSLConfig(
            data_path=poly_csv, save_dir=save_dir, hidden_size=hidden,
            epochs_stage1=0, epochs_stage2=1, max_data_size=50,
            num_workers=1, quiet=True, device=device))
        return {"param_sha": params_sha(path)}

    reg = str(DATA / "regression.csv")
    return [Case("eaip_weighted", eaip_arm),
            Case("train_regression", train(reg)),
            Case("serve_regression", serve(reg, "train_regression")),
            Case("train_copolymers", train(poly_csv, polymer=True)),
            Case("serve_copolymers", serve(poly_csv, "train_copolymers")),
            Case("atom_messages", train(reg, atom_messages=True,
                                        max_data_size=60)),
            Case("multiclass", train(mc_csv, dataset_type="multiclass",
                                     multiclass_num_classes=3)),
            Case("ssl", ssl_step)]


def probe_case(case: Case, device: str, root: str) -> Dict:
    """Two logged runs and one profiled run of ``case``."""
    logs, results = [], []
    for k in range(2):
        save_dir = os.path.join(root, f"{case.name}_{k}")
        shutil.rmtree(save_dir, ignore_errors=True)
        os.makedirs(save_dir)
        # modules draw their default init (overwritten by the seeded or
        # loaded weights) from the global stream
        torch.manual_seed(0)
        log = OpLog(device)
        with log:
            results.append(case.run(save_dir, False))
        logs.append(log)
    save_dir = os.path.join(root, f"{case.name}_profiled")
    shutil.rmtree(save_dir, ignore_errors=True)
    os.makedirs(save_dir)
    kernels = profile_kernels(lambda: case.run(save_dir, True), device)
    return {
        "results_equal": results[0] == results[1],
        "outputs_logged": len(logs[0].names),
        "first_divergence": first_divergence(*logs),
        "float_atomic_ops": sorted(f"{op} at {site} x{n}" for (op, site), n
                                   in logs[0].atomics.items()),
        "atomic_kernels": sorted(f"{k[:160]} x{n}"
                                 for k, n in kernels.items()
                                 if atomic_kernel(k)),
        "kernels": sorted(k[:160] for k in kernels),
        "results": results[0],
        "results_other": None if results[0] == results[1] else results[1],
    }


def epoch_speed(device: str, hidden: int, epochs: int = 3) -> Dict:
    """Steps/s of ``epochs`` cached epochs of the default configuration on
    regression.csv (400 training molecules, batch 50, seed 0) after one
    that featurizes, and the device's idle share in one more epoch under
    the profiler (1 - kernel time / wall time; None on the CPU)."""
    import time

    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.data import (MoleculeDataLoader,
                                                  get_data, split_data)
    from polymer_chemprop_tpu_torch.models.init import reference_init_model
    from polymer_chemprop_tpu_torch.models.model import build_model_config
    from polymer_chemprop_tpu_torch.train.scheduler import (
        build_optimizer, build_schedule)
    from polymer_chemprop_tpu_torch.train.step import (TrainStep,
                                                       batch_tensors,
                                                       make_loss_fn)
    cuda = device.startswith("cuda")
    cfg = TrainConfig(data_path=str(DATA / "regression.csv"),
                      dataset_type="regression", hidden_size=hidden,
                      ffn_hidden_size=hidden, batch_size=50, seed=0,
                      epochs=epochs + 2, device=device)
    fcfg = cfg.featurization()
    data = get_data(cfg.data_path, config=fcfg)
    train = split_data(data, cfg.split_type, cfg.split_sizes, cfg.seed)[0]
    train.normalize_targets()
    loader = MoleculeDataLoader(train, fcfg, batch_size=cfg.batch_size,
                                shuffle=True, seed=cfg.seed, num_workers=1)
    mcfg = build_model_config(cfg, data.num_tasks, data=train)
    model = reference_init_model(mcfg, cfg.pytorch_seed).to(device)
    step = TrainStep(
        model, build_optimizer(cfg.optimizer, model.parameters()),
        build_schedule(cfg.scheduler, init_lr=cfg.init_lr, max_lr=cfg.max_lr,
                       final_lr=cfg.final_lr, warmup_epochs=cfg.warmup_epochs,
                       epochs=cfg.epochs,
                       steps_per_epoch=len(train) // cfg.batch_size),
        make_loss_fn(mcfg))

    def epoch():
        t0 = time.perf_counter()
        n = sum(1 for b in loader if step(batch_tensors(b, device)))
        if cuda:
            torch.cuda.synchronize()
        return n, time.perf_counter() - t0

    epoch()
    rates = [n / s for n, s in (epoch() for _ in range(epochs))]
    idle = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = epoch()
        busy = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
                   for e in prof.key_averages()) * 1e-6
        idle = 1 - busy / wall
    print(f"[speed] cached epoch of the default configuration: steps/s "
          f"{[round(r, 2) for r in rates]}, idle share "
          f"{'not measured' if idle is None else f'{100 * idle:.1f}%'} on "
          f"{torch.cuda.get_device_name(0) if cuda else 'the CPU'}",
          flush=True)
    return {"steps_per_s": rates, "idle_share": idle}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from polymer_chemprop_tpu_torch.train.predict import resolve_device
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cases", nargs="*")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join("build", "determinism"))
    p.add_argument("--speed", action="store_true")
    p.add_argument("--hidden_size", type=int, default=300)
    p.add_argument("--eaip_epochs", type=int, default=3)
    a = p.parse_args(argv)
    device = str(resolve_device(a.device))
    if device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"[determinism] {torch.cuda.get_device_name(0)}, torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}, "
              f"deterministic mode {torch.are_deterministic_algorithms_enabled()}",
              flush=True)
    if a.speed:
        return epoch_speed(device, a.hidden_size)
    report = {}
    for case in cases(device, a.out, a.hidden_size, a.eaip_epochs):
        if a.cases and case.name not in a.cases:
            continue
        r = probe_case(case, device, a.out)
        report[case.name] = r
        div = r["first_divergence"]
        where = "none" if div is None else (
            f"output {div['index']} of {div['outputs']} ({div['op']} at "
            f"{div['site']}), {div['differing']} outputs differ")
        print(f"[determinism] {case.name}: results equal "
              f"{r['results_equal']}; first divergence {where}", flush=True)
        print(f"[determinism] {case.name}: float atomics dispatched "
              f"{r['float_atomic_ops'] or 'none'}", flush=True)
        print(f"[determinism] {case.name}: atomic kernels in the profile "
              f"({len(r['kernels'])} kernels) "
              f"{r['atomic_kernels'] or 'none'}", flush=True)
    with open(os.path.join(a.out, "determinism.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    return report


if __name__ == "__main__":
    main()
