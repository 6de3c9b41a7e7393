"""Learning-rate schedules and the optimizer factory.

The port's counterpart of polymer_chemprop_tpu train/scheduler.py (reference
utils.py:295-310, 490-541; nn_utils.py:115-195). A schedule is a pure
function of the update count, 0 at the first update, so ``schedule(0)`` is
the first step's learning rate. Each is evaluated in float32, as the JAX
package evaluates it inside its jitted step.

:func:`build_optimizer` returns a ``torch.optim`` optimizer whose learning
rate the train step sets before every update. Its arithmetic equals the
JAX package's optax chain: ``adam`` ignores ``weight_decay`` (optax's adam
has none; torch's would be L2), ``adamw`` decays decoupled, ``sgd`` is
plain. Gradient clipping is not torch's ``clip_grad_norm_`` (which divides
by ``norm + 1e-6``) but optax's ``g * max / max(norm, max)``, in
train/step.py.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

_F = np.float32
Schedule = Callable[[int], float]


def noam_schedule(init_lr: float, max_lr: float, final_lr: float,
                  warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warmup init->max over warmup_steps, then exponential decay
    max->final over the remaining steps (reference nn_utils.py:115-195)."""
    warmup_steps = max(1, int(warmup_steps))
    total_steps = max(warmup_steps + 1, int(total_steps))
    increment = (max_lr - init_lr) / warmup_steps
    gamma = (final_lr / max_lr) ** (1.0 / (total_steps - warmup_steps))

    def schedule(step: int) -> float:
        s = _F(step)
        if step <= warmup_steps:
            return float(_F(init_lr) + s * _F(increment))
        if step <= total_steps:
            return float(_F(max_lr) * _F(gamma) ** (s - _F(warmup_steps)))
        return float(_F(final_lr))

    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda step: float(_F(value))


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``init * ((1 - alpha) * 0.5 * (1 + cos(pi t / T)) + alpha)``, held at
    ``alpha * init`` after T steps."""
    def schedule(step: int) -> float:
        t = min(_F(step), _F(decay_steps))
        cosine = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * t / _F(decay_steps)))
        return float(_F(init_value) * ((_F(1) - _F(alpha)) * cosine + _F(alpha)))

    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    """One cycle: cosine rise from peak/div_factor to peak over the first
    ``pct_start`` of the steps, cosine fall to peak/(div_factor *
    final_div_factor) over the rest, then held."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    init = peak_value / div_factor
    values = np.cumprod([init, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(step: int) -> float:
        if step >= bounds[-1]:
            return float(_F(values[-1]))
        k = 0 if step < bounds[1] else 1
        pct = _F(step - bounds[k]) / _F(bounds[k + 1] - bounds[k])
        start, end = _F(values[k]), _F(values[k + 1])
        return float(end + (start - end) / _F(2) *
                     (np.cos(_F(np.pi) * pct) + _F(1)))

    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Schedule:
    def schedule(step: int) -> float:
        if step <= 0:
            return float(_F(init_value))
        p = _F(step) / _F(transition_steps)
        return float(_F(init_value) * np.power(_F(decay_rate), p))

    return schedule


def build_schedule(scheduler: str, *, init_lr: float, max_lr: float,
                   final_lr: float, warmup_epochs: float, epochs: int,
                   steps_per_epoch: int) -> Schedule:
    """(reference utils.py:490-541)."""
    total_steps = epochs * steps_per_epoch
    if scheduler == "noam":
        return noam_schedule(init_lr, max_lr, final_lr,
                             int(warmup_epochs * steps_per_epoch), total_steps)
    if scheduler == "constant":
        return constant_schedule(max_lr)
    if scheduler == "cosine":
        return cosine_decay_schedule(max_lr, max(total_steps, 1),
                                     alpha=final_lr / max_lr)
    if scheduler == "cyclic":
        return cosine_onecycle_schedule(max(total_steps, 1), max_lr)
    if scheduler == "exponential":
        return exponential_decay(max_lr, max(steps_per_epoch, 1), 0.95)
    raise ValueError(f'Scheduler "{scheduler}" not supported.')


def build_optimizer(optimizer: str, params: Iterable[torch.nn.Parameter],
                    weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """(reference utils.py:295-310). ``params`` are the trainable
    parameters only: a frozen parameter gets no update and no moment. The
    learning rate is a placeholder until the train step sets it."""
    params = list(params)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.0)
    if optimizer == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    if optimizer == "sgd":
        return torch.optim.SGD(params, lr=0.0)
    raise ValueError(f'Optimizer "{optimizer}" not supported.')
