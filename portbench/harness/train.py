"""The training driver (traffic ``"kind": "train"``): the trainer's
single-device loop (``train/trainer.py``) on one configuration's training
pool, reshuffled every epoch from the seed by the port's loader.

Set-up builds one training step and drives it through its first epochs
(``setup_epochs``) with the window's own call and feed; the window then
goes on with the same step, epoch after epoch, each epoch's scalars
fetched once at its end, as the trainer does. ``train_mol_per_s`` is every
molecule stepped over all the time from the window's first step to the
fetch that ends it.

The reference follows two stretches of ``checked_steps`` steps, on
batches whose rows all differ: the first steps from the seeded weights,
and the window's own first steps from the program's state where the
window began (its parameters and Adam's moments; the count of updates is
the benchmark's own)."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..reference import model as ref
from ..reference.features.config import ATOM_FDIM, BOND_FDIM
from . import checks, data, program
from .record import Record
from .spans import Units

B1 = 0.9        # Adam's first beta, in the port's build_optimizer and here


def _epoch(loader, step, units, device, annotate, after_step=None):
    """One epoch of the trainer's loop: each batch's tensors, the step;
    the epoch's losses and gradient norms fetched in one transfer."""
    from torch.profiler import record_function
    losses, gnorms = [], []
    for batch in units.wrap(loader, "step"):
        loss, gnorm = step(program.batch_tensors(batch, device))
        losses.append(loss)
        gnorms.append(gnorm)
        if after_step is not None:
            after_step(len(losses), batch)
    if not losses:
        return np.zeros(0)
    with record_function("epoch_fetch") if annotate else \
            contextlib.nullcontext():
        return torch.stack(losses + gnorms).cpu().numpy()


class Stretch:
    """The checked steps of one stretch of training. Holds the program's
    state where the stretch begins (parameters; Adam's moments, absent
    before the first update) and, as the steps go, what the comparison
    reads: each checked step's targets, the first step's gradient as the
    optimizer got it, and each parameter's change after the checked
    steps (norms, on the device, fetched after the window)."""

    def __init__(self, step, params, n_check: int, update: int):
        self.opt, self.params, self.n_check = step.optimizer, params, n_check
        self.update = update          # updates made before the stretch
        with torch.no_grad():
            self.p0 = [p.detach().clone() for p in params]
            states = [self.opt.state.get(p, {}) for p in params]
            self.m0 = [s["exp_avg"].clone() if "exp_avg" in s else None
                       for s in states]
            self.v0 = [s["exp_avg_sq"].to("cpu", copy=True)
                       if "exp_avg_sq" in s else None
                       for s in states]
        self.targets, self.grad, self.change = [], None, None

    def __call__(self, k: int, batch) -> None:
        if k <= self.n_check:
            self.targets.append(batch.targets[:batch.size].copy())
        with torch.no_grad():
            if k == 1:
                # Adam's first moment after an update is B1 times the one
                # before plus (1 - B1) times the gradient
                self.grad = torch.stack([
                    self._grad(p, m0) for p, m0 in zip(self.params, self.m0)])
            if k == self.n_check:
                self.change = torch.stack([
                    (p.detach() - p0).norm()
                    for p, p0 in zip(self.params, self.p0)])

    def _grad(self, p, m0):
        s = self.opt.state.get(p, {})
        if "exp_avg" not in s:
            return p.new_zeros(())
        m1 = s["exp_avg"]
        return ((m1 if m0 is None else m1 - B1 * m0) / (1 - B1)).norm()

    def norms(self, which: str, n: int) -> np.ndarray:
        t = getattr(self, which)
        return np.full(n, np.inf) if t is None else t.cpu().numpy()


class TrainCell:
    """One training cell: :meth:`setup`, :meth:`window`, :meth:`release`,
    then the reference's comparison (:meth:`verdict`)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic, self.device = ctx.cfg, ctx.traffic, ctx.device
        self.bs = self.traffic["batch_size"]
        self.n_check = self.traffic["checked_steps"]
        self.epochs = self.traffic.get("setup_epochs", 1)
        self.bond_fdim = ATOM_FDIM + BOND_FDIM

    def setup(self) -> None:
        """The inputs, the weights, the step, and the set-up epochs; the
        first of them holds the first checked stretch, and the state
        where the window begins is kept for the second."""
        cfg, device = self.cfg, self.device
        self.smiles, y = data.pool(cfg, "train")
        self.ys = (y - y.mean(0)) / y.std(0)
        self.T = y.shape[1]
        self.names = ref.leaf_names(cfg["ffn_num_layers"])
        leaves = data.make_weights(
            ref.leaf_shapes(cfg, ATOM_FDIM, self.bond_fdim, self.T),
            self.ctx.seed, 0, device)
        self.ctx.mark("inputs and weights")
        tcfg = program.train_config(cfg, self.bs)
        self.loader = program.loader(program.dataset(self.smiles, self.ys),
                                     tcfg, self.bs, shuffle=True,
                                     seed=self.ctx.seed)
        model = program.model(tcfg, self.T, leaves, self.names, device)
        # the reference starts from these; the program holds its own copy
        self.leaves = [x.cpu() for x in leaves]
        del leaves
        self.steps_per_epoch = ref.noam_steps_per_epoch(len(self.smiles),
                                                        self.bs)
        self.step = program.train_step(model, tcfg, self.steps_per_epoch)
        self.ctx.mark("the port imported, the model loaded")
        named = [(program.param_leaf(n), p)
                 for n, p in model.named_parameters()]
        self.order = [self.names.index(n) for n, _ in named]
        self.params = [p for _, p in named]
        start = Stretch(self.step, self.params, self.n_check, 0)
        first = _epoch(self.loader, self.step, Units(float("inf")), device,
                       False, start)
        self.first_losses = first[:len(first) // 2]
        start.p0 = None
        self.start = start
        updates = len(first) // 2
        self.setup_nonfinite = int(np.sum(~np.isfinite(first)))
        # more epochs, so that the loader's sticky padding envelope and the
        # host path have settled before the window (PERF.md)
        for _ in range(self.epochs - 1):
            fetched = _epoch(self.loader, self.step, Units(float("inf")),
                             device, False)
            updates += len(fetched) // 2
            self.setup_nonfinite += int(np.sum(~np.isfinite(fetched)))
        self.win = Stretch(self.step, self.params, self.n_check, updates)
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.ctx.mark(f"{self.epochs} epochs")

    def window(self, seconds: float, prof=None) -> None:
        from torch.profiler import record_function
        annotate = prof is not None
        if prof is not None:
            prof.start()
        with record_function("window") if annotate else \
                contextlib.nullcontext():
            self.t0 = time.perf_counter()
            units = Units(self.t0 + seconds, annotate=annotate)
            scalars = []
            while True:
                scalars.append(_epoch(
                    self.loader, self.step, units, self.device, annotate,
                    None if scalars else self.win))
                if units.cut or time.perf_counter() >= units.deadline:
                    break
            self.t_end = time.perf_counter()
        self.trace = prof.stop() if prof is not None else None
        units.close_loader()
        self.units = units
        self.window_losses = scalars[0][:len(scalars[0]) // 2]
        fetched = np.concatenate(scalars)
        self.failed = int(np.sum(~np.isfinite(fetched)))

    def release(self) -> None:
        """Reads what the program's checked steps left and frees the
        program's state; the reference runs after."""
        n = len(self.names)
        self.prog = {}
        for key, st, losses in (("start", self.start, self.first_losses),
                                ("window", self.win, self.window_losses)):
            self.prog[key] = {
                "losses": [float(x) for x in losses[:self.n_check]],
                "grad_norms": self._by_leaf(st.norms("grad", n)),
                "change": self._by_leaf(st.norms("change", n))}
        win = self.win
        # a parameter that Adam never stepped has no moments yet
        zeros = [torch.zeros_like(p) for p in win.p0]
        self.win_state = {
            "params": self._leaves(win.p0),
            "m": self._leaves([z if m is None else m
                               for z, m in zip(zeros, win.m0)]),
            "v": self._leaves([z if v is None else v.to(self.device)
                               for z, v in zip(zeros, win.v0)]),
            "t": win.update, "update": win.update}
        for st in (self.start, win):
            st.p0 = st.m0 = st.v0 = st.params = st.opt = None
        self.step = self.loader = self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _by_leaf(self, v: np.ndarray) -> list:
        return [float(v[self.order.index(i)]) for i in range(len(self.names))]

    def _leaves(self, tensors) -> list:
        """Parameters in leaf order and the reference's ``(in, out)``
        layout."""
        out = []
        for i in range(len(self.names)):
            x = tensors[self.order.index(i)]
            out.append(x.t().contiguous() if x.dim() == 2 else x)
        return out

    def batches(self) -> dict:
        """Each stretch's checked batches, in the rows the sampler gives:
        the first epoch's, and the first window epoch's."""
        bs, n_check = self.bs, self.n_check
        orders = ref.epoch_orders(len(self.smiles), self.ctx.seed,
                                  self.epochs + 1)
        out = {}
        for key, rows in (("start", orders[0]), ("window", orders[-1])):
            out[key] = [{"smiles": [self.smiles[i]
                                    for i in rows[k * bs:(k + 1) * bs]],
                         "targets": self.ys[rows[k * bs:(k + 1) * bs]]}
                        for k in range(n_check)]
        return out

    def reference(self, precision: str = "float32") -> dict:
        """The reference's checked steps at ``precision``: from the seeded
        weights, and from the program's state where the window began."""
        b = self.batches()
        spe, cfg, device = self.steps_per_epoch, self.cfg, self.device
        ws = self.win_state
        return {
            "start": ref.train_steps([x.to(device) for x in self.leaves],
                                     b["start"], cfg, spe, device, precision),
            "window": ref.train_steps(ws["params"], b["window"], cfg, spe,
                                      device, precision, state=ws)}

    def rows_ok(self) -> bool:
        """Whether every checked step took the rows the sampler gives."""
        b = self.batches()
        return all(
            len(st.targets) >= self.n_check and
            all(np.array_equal(st.targets[k],
                               b[key][k]["targets"].astype(np.float32))
                for k in range(self.n_check))
            for key, st in (("start", self.start), ("window", self.win)))

    def verdict(self, precision: str = "float32") -> dict:
        """The comparison's numbers against the reference computed at
        ``precision``."""
        return numbers(self.prog, self.reference(precision))


def numbers(prog: dict, want: dict) -> dict:
    """Both stretches' numbers: ``loss_gap``, ``grad_gap`` and
    ``change_gap`` of the first steps, and the same of the window's
    first steps prefixed ``window_``."""
    out = checks.train_numbers(prog["start"], want["start"])
    out.update({f"window_{k}": v for k, v in
                checks.train_numbers(prog["window"], want["window"]).items()})
    return out


def run(ctx) -> Record:
    c = TrainCell(ctx)
    c.setup()
    c.window(ctx.window_seconds, ctx.profiler())
    setup_s = c.t0 - ctx.process_start
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0
    c.release()
    rows_ok = c.rows_ok()
    correct, checked = checks.judge(c.verdict(), ctx.limits)
    checked["batch_rows"] = {"value": 0.0 if rows_ok else 1.0, "limit": 0.0}
    # the set-up's steps between the two stretches: every loss and
    # gradient norm finite
    checked["setup_nonfinite"] = {"value": float(c.setup_nonfinite),
                                  "limit": 0.0}
    window_s = c.t_end - c.t0
    return Record(cfg=ctx.cfg, traffic=ctx.traffic, training=True,
                  atom_fdim=ATOM_FDIM, bond_fdim=c.bond_fdim,
                  num_tasks=c.T, units=c.units, window_s=window_s,
                  end_to_end={"train_mol_per_s":
                              c.units.totals()[0] / window_s,
                              "setup_s": setup_s},
                  checks=checked,
                  correct=correct and rows_ok and c.failed == 0
                  and c.setup_nonfinite == 0,
                  attempted=len(c.units), failed=c.failed,
                  memory_peak_bytes=int(peak), trace=c.trace)
