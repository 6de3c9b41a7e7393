"""The screening driver (traffic ``"kind": "screen"``): a library through a
checkpoint ensemble, as ``train/make_predictions.py`` serves it.

Set-up makes each member's weights on the card from the seed and loads
them, once, through ``load_jax_params`` into a model of its own, then warms
the path with one short chunk. In the window the library, the pool again
and again in orders drawn from the seed, goes through in chunks: each
chunk gets its loader, and ``train/predict.py`` ``predict`` runs it once
per member (the loader's pool featurizes ahead of the consumer), then the
members' predictions are averaged. A member-batch counts its molecules
over the number of members; ``screen_mol_per_s`` is their sum over the
time from the window's start to the last completed member-batch."""

from __future__ import annotations

import contextlib
import time
from random import Random

import numpy as np
import torch

from ..reference import model as ref
from ..reference.features.config import ATOM_FDIM, BOND_FDIM
from . import checks, data, program
from .record import Record
from .spans import Units


def _chunk(stream, size: int) -> list:
    return [next(stream) for _ in range(size)]


class ScreenCell:
    """One screening cell: :meth:`setup`, :meth:`window`, :meth:`verdict`."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic, self.device = ctx.cfg, ctx.traffic, ctx.device
        self.bs = self.traffic["batch_size"]
        self.E = self.traffic["ensemble"]
        self.bond_fdim = ATOM_FDIM + BOND_FDIM

    def setup(self) -> None:
        cfg, device, seed = self.cfg, self.device, self.ctx.seed
        self.smiles, _ = data.pool(cfg, "library")
        self.means, self.stds = data.scaler_stats(cfg)
        self.T = data.num_tasks(cfg)
        names = ref.leaf_names(cfg["ffn_num_layers"])
        shapes = ref.leaf_shapes(cfg, ATOM_FDIM, self.bond_fdim, self.T)
        self.members = [data.make_weights(shapes, seed, k, device)
                        for k in range(self.E)]
        self.ctx.mark("inputs and weights")
        self.tcfg = program.train_config(cfg, self.bs)
        self.models = [program.model(self.tcfg, self.T, leaves, names,
                                     device) for leaves in self.members]
        self.ctx.mark("the port imported, the members loaded")
        # one short chunk through every member warms the path
        warm = data.passes(len(self.smiles), seed + 1)
        self._serve(_chunk(warm, self.traffic["warmup_molecules"]),
                    Units(float("inf")))
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.ctx.mark("the warm-up chunk")

    def _serve(self, idx, units):
        """One chunk through every member; the ensemble mean, or None if
        the window closed first."""
        loader = program.loader(
            program.dataset([self.smiles[i] for i in idx]), self.tcfg,
            self.bs)
        total = None
        for m in self.models:
            preds = program.predict(m, units.wrap(loader, "predict_batch"),
                                    self.device, self.means, self.stds)
            if units.cut:
                return None
            total = preds if total is None else total + preds
        return total / self.E

    def window(self, seconds: float, prof=None) -> None:
        from torch.profiler import record_function
        stream = data.passes(len(self.smiles), self.ctx.seed)
        annotate = prof is not None
        if prof is not None:
            prof.start()
        done = []                  # (library indices, ensemble mean)
        with record_function("window") if annotate else \
                contextlib.nullcontext():
            self.t0 = time.perf_counter()
            units = Units(self.t0 + seconds, annotate=annotate)
            while not units.cut:
                idx = _chunk(stream, self.traffic["chunk"])
                mean = self._serve(idx, units)
                if mean is not None:
                    done.append((idx, mean))
        # every answer of a finished chunk is one row of its mean
        self.rows_ok = all(len(m) == len(idx) for idx, m in done)
        self.trace = prof.stop() if prof is not None else None
        self.t_last = units.done[-1]
        units.close_loader()
        self.units = units
        done = [(idx, m) for idx, m in done if len(m) == len(idx)]
        self.idx = [i for idx, _ in done for i in idx]
        self.preds = np.concatenate([p for _, p in done], 0) if done \
            else np.zeros((0, self.T))
        self.failed = int(np.sum(~np.all(np.isfinite(self.preds), 1)))

    def release(self) -> None:
        self.models = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """Positions of the answers compared: a sample drawn from the seed,
        with the longest string among the answers in it."""
        n_ans = len(self.idx)
        if not n_ans:
            return []
        rng = Random(self.ctx.seed ^ 0x5A5A5A)
        pick = rng.sample(range(n_ans), min(self.traffic["check_sample"],
                                            n_ans))
        longest = max(range(n_ans),
                      key=lambda j: len(self.smiles[self.idx[j]]))
        if longest not in pick:
            pick[-1] = longest
        return pick

    def reference(self, pick, precision: str = "float32") -> np.ndarray:
        sample = [self.smiles[self.idx[j]] for j in pick]
        return ref.predict_blocks(self.members, sample, self.cfg["polymer"],
                                  self.cfg["depth"], self.device, precision)

    def verdict(self, precision: str = "float32") -> dict:
        pick = self.sample()
        if not pick or not self.rows_ok:
            return {"pred_gap": float("inf")}
        return {"pred_gap": checks.pred_gap(
            self.preds[pick], self.reference(pick, precision), self.means,
            self.stds)}


def run(ctx) -> Record:
    c = ScreenCell(ctx)
    c.setup()
    c.window(ctx.window_seconds, ctx.profiler())
    setup_s = c.t0 - ctx.process_start
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0
    c.release()
    correct, checked = checks.judge(c.verdict(), ctx.limits)
    checked["answer_rows"] = {"value": 0.0 if c.rows_ok else 1.0,
                              "limit": 0.0}
    window_s = c.t_last - c.t0
    attempted = len(c.idx)
    return Record(cfg=ctx.cfg, traffic=ctx.traffic, training=False,
                  atom_fdim=ATOM_FDIM, bond_fdim=c.bond_fdim,
                  num_tasks=c.T, units=c.units, window_s=window_s,
                  end_to_end={"screen_mol_per_s":
                              c.units.totals()[0] / c.E / window_s,
                              "setup_s": setup_s},
                  checks=checked,
                  correct=correct and c.rows_ok and c.failed == 0
                  and attempted > 0,
                  attempted=attempted, failed=c.failed,
                  memory_peak_bytes=int(peak), trace=c.trace)
