"""The arithmetic that the per-layer readers share: each takes a finished
:class:`~.record.Record` and returns a number, or None where the run holds
nothing to read (no trace, no unit, no listed kernel on the path)."""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Callable, Optional

import numpy as np

from . import work


def loader_wait_ms(rec) -> Optional[float]:
    """Mean host time a unit waited in the loader's ``next()``."""
    w = rec.units.waits_s()
    return float(w.mean() * 1e3) if len(w) else None


def busy_p95_ms(rec) -> Optional[float]:
    """95th percentile of the host time from a batch off the loader to
    the consumer asking for the next one (for ``predict``: its
    predictions on the host)."""
    b = rec.units.busy_s()
    if len(b) < 20:
        return None
    return float(np.percentile(b, 95) * 1e3)


def h2d_ms(rec) -> Optional[float]:
    """Device time of host-to-device copies per unit of the window."""
    if rec.trace is None or not rec.trace.device or not len(rec.units):
        return None
    return rec.trace.h2d_seconds() / len(rec.units) * 1e3


def idle_share(rec) -> Optional[float]:
    """Share of the traced window with nothing on the device, in %."""
    if rec.trace is None or not rec.trace.device or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s)


def mfu(rec) -> Optional[float]:
    """Model operations of every unit of the window over the window's
    length times the H100's dense bf16 peak, in %."""
    if not len(rec.units) or rec.window_s <= 0:
        return None
    flops = sum(work.unit_flops(rec.cfg, rec.atom_fdim, rec.bond_fdim,
                                rec.num_tasks, c, rec.training)
                for c in rec.units.counts[:len(rec.units)])
    return 100.0 * flops / (rec.window_s * work.PEAK_BF16_TC_FLOPS)


def kernel_roofline(rec, kernels_dir: str) -> Optional[float]:
    """Least time of the listed kernels' work over their device time, in
    %. Each file under ``kernels_dir`` names one kernel: the strings its
    name in the trace holds (``match``), its launches a unit (``calls``)
    and its work (``bytes``, ``ops``, ``peak``; :mod:`.work`). Every
    listed kernel is counted or none: where one's launches in the trace
    differ from its calls times the units (a kernel taken off the path,
    fused or split), the reading is None, with a line on standard error
    naming it."""
    if rec.trace is None or not rec.trace.device or not len(rec.units):
        return None
    least = spent = 0.0
    counts = rec.units.counts[:len(rec.units)]
    H = rec.cfg["hidden_size"]
    for path in sorted(glob.glob(os.path.join(kernels_dir, "*.json"))):
        with open(path) as f:
            k = json.load(f)
        calls = work.kernel_calls(k, rec.cfg["depth"])
        secs, launches = rec.trace.kernel_seconds(k["match"])
        if launches != calls * len(counts):
            print(f"[portbench] {os.path.basename(path)}: {launches} "
                  f"launches in the trace, {calls * len(counts)} expected; "
                  "no roofline read", file=sys.stderr)
            return None
        least += calls * sum(work.least_seconds(work.kernel_work(
            k, H, *c)) for c in counts)
        spent += secs
    if spent <= 0:
        return None
    return 100.0 * least / spent


STEMS = {"loader_wait_ms": loader_wait_ms,
         "predict_batch_p95_ms": busy_p95_ms,
         "h2d_ms": h2d_ms, "idle_share": idle_share, "mfu": mfu}


def by_name(metric: str, folder: str) -> Optional[Callable]:
    """The reading of a per-layer metric that has no ``reader.py`` of its
    own, by the stem of its name (the part before the first dot): one of
    :data:`STEMS`, or, for a stem ending ``_roofline``, the kernels listed
    under ``<folder>/kernels``."""
    stem = metric.split(".")[0]
    if stem.endswith("_roofline"):
        kernels = os.path.join(folder, "kernels")
        return lambda rec: kernel_roofline(rec, kernels)
    return STEMS.get(stem)
