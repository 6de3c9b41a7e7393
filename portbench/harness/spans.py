"""The benchmark's host spans, taken from outside the program.

:class:`Units` wraps a loader (anything iterated for batches) and records,
for every batch that the consumer takes (a unit: a training step, or one
ensemble member's batch), when the consumer asked for it, when the loader
handed it over and when the consumer asked for the next one, and the
batch's real molecules, atoms and bonds. So ``wait`` is the host time
spent in the loader's ``next()`` and ``busy`` the consumer's time with the
batch. With a profiler running the same spans are marked as
``record_function`` ranges, which label the device's idle gaps.

The wrapper also closes the window: once the deadline has passed, it hands
out no further batch, so the consumer's call ends at the next unit
boundary.
"""

from __future__ import annotations

import time
from typing import Iterable, List

import numpy as np


def batch_counts(batch) -> tuple:
    """``(molecules, atoms, bonds)`` that a DeviceBatch really holds: its
    real rows, the atoms in its molecule CSR and the directed bonds in its
    atom runs (padding lies in neither)."""
    mols = atoms = bonds = 0
    for g in batch.graph_arrays:
        aux = g["sorted_aux"]
        atoms += int(aux["mol_rowptr"][-1])
        bonds += int(aux["rowptr"][-1])
    return int(batch.size), atoms, bonds


class Units:
    """Spans of every unit of a window (see the module docstring)."""

    def __init__(self, deadline: float, annotate: bool = False):
        self.deadline = deadline
        self.annotate = annotate
        self.asked: List[float] = []     # consumer asked for the batch
        self.ready: List[float] = []     # the loader handed it over
        self.done: List[float] = []      # consumer asked for the next one
        self.counts: List[tuple] = []
        self.cut = False                 # the deadline ended a loader early
        self._pending_close = None

    def __len__(self) -> int:
        return len(self.done)

    def wrap(self, loader: Iterable, name: str = "unit"):
        """A generator over ``loader``'s batches that records each unit
        and stops handing out batches once the deadline has passed."""
        it = iter(loader)
        rf = None
        if self.annotate:
            from torch.profiler import record_function
            rf = record_function
        try:
            while True:
                t = time.perf_counter()
                if self.ready and len(self.done) < len(self.ready):
                    self.done.append(t)
                    if t >= self.deadline:
                        self.cut = True
                        return
                if rf is not None:
                    with rf("loader_wait"):
                        batch = next(it, None)
                else:
                    batch = next(it, None)
                if batch is None:
                    return
                self.asked.append(t)
                self.ready.append(time.perf_counter())
                self.counts.append(batch_counts(batch))
                if rf is not None:
                    with rf(name):
                        yield batch
                else:
                    yield batch
        finally:
            self._pending_close = getattr(it, "close", None)

    def close_loader(self) -> None:
        """Ends the loader that the deadline cut (its pool finishes the
        batches it had started); called once the window has closed."""
        if self._pending_close is not None:
            self._pending_close()
            self._pending_close = None

    # -- readings ---------------------------------------------------------
    def waits_s(self) -> np.ndarray:
        n = len(self.done)
        return np.asarray(self.ready[:n]) - np.asarray(self.asked[:n])

    def busy_s(self) -> np.ndarray:
        n = len(self.done)
        return np.asarray(self.done[:n]) - np.asarray(self.ready[:n])

    def totals(self) -> tuple:
        """Summed ``(molecules, atoms, bonds)`` of the completed units."""
        c = self.counts[:len(self.done)]
        if not c:
            return 0, 0, 0
        a = np.asarray(c, np.int64).sum(0)
        return int(a[0]), int(a[1]), int(a[2])
