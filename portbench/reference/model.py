"""The benchmark's plain reference of the wD-MPNN and the D-MPNN.

Plain PyTorch and NumPy in float32 with TF32 off: the reference's message
passing (Chemprop mpn.py; the weighted directed-bond update, the atom and
the stoichiometry-weighted molecule readouts of the wD-MPNN), the FFN, the
masked MSE loss, autograd's gradients, Adam and the Noam schedule. It
featurizes SMILES and polymer ensemble strings itself, with its own frozen
featurizer (``reference/features``), and builds its own unpadded batches
in natural bond order, with ``index_add_`` for every sum. It imports
nothing of the program under test.

Parameters are a list of leaves in :func:`leaf_names` order, each weight in
the ``(in, out)`` layout (``y = x @ w + b``).

``precision="tf32"`` is the control: every product rounds its operands to
TF32 (10 mantissa bits) and accumulates in float32, forward and backward,
as the tensor cores do with TF32 on.
"""

from __future__ import annotations

from random import Random
from typing import Dict, List, Sequence

import numpy as np
import torch

from .features import FeaturizationConfig, MolGraph


def leaf_names(ffn_num_layers: int) -> List[str]:
    names = ["W_i.w", "W_h.w", "W_o.w", "W_o.b"]
    for j in range(ffn_num_layers):
        names += [f"ffn{j}.w", f"ffn{j}.b"]
    return names


def leaf_shapes(cfg: dict, atom_fdim: int, bond_fdim: int,
                num_tasks: int) -> List[tuple]:
    """Shapes of the leaves of a model without biases in W_i and W_h
    (Chemprop's default), in :func:`leaf_names` order."""
    H, F = cfg["hidden_size"], cfg["ffn_hidden_size"]
    shapes = [(bond_fdim, H), (H, H), (atom_fdim + H, H), (H,)]
    dims = [H] + [F] * (cfg["ffn_num_layers"] - 1) + [num_tasks]
    for i, o in zip(dims[:-1], dims[1:]):
        shapes += [(i, o), (o,)]
    return shapes


# -- featurization and batching ---------------------------------------------

def featurize(smiles: Sequence[str], polymer: bool) -> Dict[str, np.ndarray]:
    """The graphs of ``smiles`` concatenated without padding: atom and
    bond features, weights, the bond index arrays, ``a2mol`` and the
    degree of polymerisation of each molecule."""
    fcfg = FeaturizationConfig(polymer=polymer)
    graphs = [MolGraph(s, fcfg) for s in smiles]
    f_atoms, f_bonds, w_atoms, w_bonds = [], [], [], []
    b2a, b2dst, b2revb, a2mol, dop = [], [], [], [], []
    a_off = b_off = 0
    for i, g in enumerate(graphs):
        f_atoms += g.f_atoms
        f_bonds += g.f_bonds
        w_atoms += list(g.w_atoms)
        w_bonds += list(g.w_bonds)
        b2a += [a_off + a for a in g.b2a]
        b2dst += [a_off + a for a in g.b2dst]
        b2revb += [b_off + b for b in g.b2revb]
        a2mol += [i] * g.n_atoms
        dop.append(g.degree_of_polym)
        a_off += g.n_atoms
        b_off += g.n_bonds
    f32 = lambda x, w: np.asarray(x, np.float32).reshape(-1, w) if w else \
        np.asarray(x, np.float32)
    return {"f_atoms": f32(f_atoms, len(graphs[0].f_atoms[0])),
            "f_bonds": f32(f_bonds, len(graphs[0].f_bonds[0])),
            "w_atoms": f32(w_atoms, 0), "w_bonds": f32(w_bonds, 0),
            "b2a": np.asarray(b2a, np.int64),
            "b2dst": np.asarray(b2dst, np.int64),
            "b2revb": np.asarray(b2revb, np.int64),
            "a2mol": np.asarray(a2mol, np.int64),
            "dop": np.asarray(dop, np.float32)}


def to_device(graph: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in graph.items()}


# -- products -----------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ _tf32(b).t(), _tf32(a).t() @ g


def matmul_for(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return _TF32MatMul.apply
    raise ValueError(f"unknown reference precision {precision!r}")


# -- the model ----------------------------------------------------------------

def forward(params: Sequence[torch.Tensor], g: Dict[str, torch.Tensor],
            depth: int, precision: str = "float32") -> torch.Tensor:
    """Raw predictions ``(M, T)`` of the molecules of ``g``: W_i, depth - 1
    weighted directed-bond updates with the layer-0 residual, the weighted
    atom readout, W_o, the stoichiometry-weighted mean readout scaled by
    1 + log10(Xn), then the FFN (Chemprop mpn.py:93-171, model.py:79-100),
    ReLU throughout and no bias in W_i or W_h."""
    mm = matmul_for(precision)
    W_i, W_h, W_o, b_o = params[:4]
    ffn = params[4:]
    A = g["f_atoms"].shape[0]
    M = g["dop"].shape[0]
    H = W_h.shape[0]
    w_b = g["w_bonds"][:, None]

    def incoming(msg):
        return msg.new_zeros((A, H)).index_add(0, g["b2dst"], msg * w_b)

    inputs = mm(g["f_bonds"], W_i)
    message = torch.relu(inputs)
    for _ in range(depth - 1):
        m = incoming(message)[g["b2a"]] - message[g["b2revb"]]
        message = torch.relu(inputs + mm(m, W_h))
    a_message = incoming(message)
    atom_h = torch.relu(mm(torch.cat([g["f_atoms"], a_message], 1), W_o)
                        + b_o)
    w_a = g["w_atoms"]
    wsum = atom_h.new_zeros((M, H)).index_add(0, g["a2mol"],
                                              atom_h * w_a[:, None])
    denom = w_a.new_zeros(M).index_add(0, g["a2mol"], w_a)
    mol = torch.where(denom[:, None] > 0,
                      wsum / torch.clamp(denom, min=1e-12)[:, None],
                      torch.zeros_like(wsum))
    h = mol * g["dop"][:, None]
    for j in range(0, len(ffn), 2):
        if j:
            h = torch.relu(h)
        h = mm(h, ffn[j]) + ffn[j + 1]
    return h


def predict_blocks(param_sets, smiles: Sequence[str], polymer: bool,
                   depth: int, device, precision: str = "float32",
                   block: int = 256) -> np.ndarray:
    """The mean raw predictions of an ensemble (one parameter list a
    member) over ``smiles``, featurized once, in blocks of ``block``
    molecules."""
    out = []
    with torch.no_grad():
        for i in range(0, len(smiles), block):
            g = to_device(featurize(smiles[i:i + block], polymer), device)
            preds = [forward(p, g, depth, precision) for p in param_sets]
            out.append((sum(preds) / len(preds)).cpu().numpy())
    return np.concatenate(out, 0)


def mse_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the batch's real targets (Chemprop
    train.py:67-74 with every target present and unit weights)."""
    return ((preds - targets) ** 2).sum() / targets.numel()


# -- optimization ---------------------------------------------------------------

def noam_lr(step: int, cfg: dict, steps_per_epoch: int) -> float:
    """The learning rate of update ``step`` (0-based) under Chemprop's
    NoamLR (nn_utils.py:115-195): linear warm-up from init_lr to max_lr
    over warmup_epochs, then exponential decay to final_lr."""
    warmup = max(1, int(cfg["warmup_epochs"] * steps_per_epoch))
    total = max(warmup + 1, cfg["epochs"] * steps_per_epoch)
    if step <= warmup:
        return cfg["init_lr"] + step * (cfg["max_lr"] - cfg["init_lr"]) / warmup
    if step <= total:
        gamma = (cfg["final_lr"] / cfg["max_lr"]) ** (1.0 / (total - warmup))
        return cfg["max_lr"] * gamma ** (step - warmup)
    return cfg["final_lr"]


class Adam:
    """Adam (Kingma & Ba) with betas (0.9, 0.999) and eps 1e-8, no weight
    decay, in float32; from zero moments, or from ``(m, v, t)``: the
    moments and the count of updates already made."""

    def __init__(self, params: Sequence[torch.Tensor], m=None, v=None,
                 t: int = 0):
        self.params = list(params)
        self.m = [x.clone() for x in m] if m is not None else \
            [torch.zeros_like(p) for p in self.params]
        self.v = [x.clone() for x in v] if v is not None else \
            [torch.zeros_like(p) for p in self.params]
        self.t = t

    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for p, m, v, g in zip(self.params, self.m, self.v, grads):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr * (m / c1) / ((v / c2).sqrt() + eps))


def train_steps(params0: Sequence[torch.Tensor], batches: Sequence[dict],
                cfg: dict, steps_per_epoch: int, device,
                precision: str = "float32", state: dict = None) -> dict:
    """Chemprop's training steps over ``batches`` from ``params0``: each
    batch ``{"smiles", "targets"}`` featurized, the loss, autograd's
    gradients and an Adam step at the Noam rate. From a fresh optimizer
    at update 0, or from ``state``: ``{"m", "v", "t", "update"}``, Adam's
    moments and count and the schedule's update index. Returns the
    losses, the first step's gradient norm of each leaf, and each leaf's
    norm of change after the steps."""
    state = state or {}
    params = [p.detach().clone().requires_grad_(True) for p in params0]
    opt = Adam(params, state.get("m"), state.get("v"), state.get("t", 0))
    first = state.get("update", 0)
    losses, grad_norms = [], None
    for k, b in enumerate(batches):
        g = to_device(featurize(b["smiles"], cfg["polymer"]), device)
        targets = torch.as_tensor(np.asarray(b["targets"], np.float32),
                                  device=device)
        loss = mse_loss(forward(params, g, cfg["depth"], precision), targets)
        grads = torch.autograd.grad(loss, params)
        if k == 0:
            grad_norms = [float(x.double().norm()) for x in grads]
        losses.append(float(loss.detach()))
        opt.step(grads, noam_lr(first + k, cfg, steps_per_epoch))
    change = [float((p.detach() - p0).double().norm())
              for p, p0 in zip(params, params0)]
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def epoch_orders(n: int, seed: int, epochs: int) -> List[List[int]]:
    """The sampler's order of each epoch: ``random.Random(seed)`` shuffles
    ``range(n)`` once an epoch (Chemprop MoleculeSampler, data.py:537-591)."""
    rng = Random(seed)
    orders = []
    for _ in range(epochs):
        order = list(range(n))
        rng.shuffle(order)
        orders.append(order)
    return orders


def noam_steps_per_epoch(n: int, batch_size: int) -> int:
    """Chemprop builds the Noam horizon with ``len(train) // batch_size``
    steps an epoch (run_training.py)."""
    return max(1, n // batch_size)
