"""Faults planted in the program's timed path, for the control readings
(``calibrate.py``) and for the tests that see ``correct`` come out false.
Each is a context manager that patches the port while it is open."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer step returns the parameters as they were."""
    import torch
    original = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = original


@contextlib.contextmanager
def half_batch(when=lambda: True):
    """Each training batch leaves out the second half of its real rows;
    the masked loss takes its mean over the rest. Only while ``when()``
    holds, where it is given."""
    import polymer_chemprop_tpu_torch.train.step as st
    original = st.batch_tensors

    def broken(batch, device):
        out = original(batch, device)
        if when():
            half = batch.size // 2
            out["mask"][half:batch.size] = 0
            out["weights"][half:batch.size] = 0
        return out

    st.batch_tensors = broken
    try:
        yield
    finally:
        st.batch_tensors = original


@contextlib.contextmanager
def half_batch_in_window():
    """:func:`half_batch` from the window's first step on, as a change
    that switches itself on after the set-up's steps would be: the set-up
    epochs, and the first checked steps among them, run sound."""
    from portbench.harness import spans
    window = {"open": False}
    original = spans.Units.__init__

    def init(self, deadline, annotate=False):
        original(self, deadline, annotate)
        if deadline != float("inf"):
            window["open"] = True

    spans.Units.__init__ = init
    try:
        with half_batch(lambda: window["open"]):
            yield
    finally:
        spans.Units.__init__ = original


@contextlib.contextmanager
def answer_altered():
    """One answer of every served batch (its first row) is altered where
    it is produced."""
    import polymer_chemprop_tpu_torch.train.predict as pr
    original = pr.postprocess_preds

    def broken(preds, cfg):
        out = original(preds, cfg).clone()
        out[0] += 1.0
        return out

    pr.postprocess_preds = broken
    try:
        yield
    finally:
        pr.postprocess_preds = original


@contextlib.contextmanager
def half_batch_served():
    """``predict`` leaves out the second half of every batch's real rows:
    their answers never come."""
    import polymer_chemprop_tpu_torch.train.predict as pr
    original = pr.model_inputs

    def broken(batch, device):
        batch.size = (batch.size + 1) // 2
        return original(batch, device)

    pr.model_inputs = broken
    try:
        yield
    finally:
        pr.model_inputs = original


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "half_batch_in_window": half_batch_in_window,
          "answer_altered": answer_altered,
          "half_batch_served": half_batch_served}

