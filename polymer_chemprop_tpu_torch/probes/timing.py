"""Kernel timing: CUDA events around one call, each after an L2 flush.

On the card (``flush`` on a CUDA device) :func:`timed_ms` takes the median
device time of ``reps`` calls. With ``run_ahead`` the flush zeroes a 1 GiB
buffer (20x the H100's 50 MB L2, about 0.4 ms of device work), so the host
has enqueued the call before the device reaches it and the two events
bracket device time only. Without it the flush zeroes 64 MB: the device is
idle again when the call arrives, and the time includes the host's way
through the wrapper. CUDA events need no scan amortisation or two-point
fit: they read the device's own clock.

On the CPU (``flush`` on the CPU) the same function takes ``perf_counter``
around each call instead. That variant exists so that the probes' entry
points can be tested without a card; its numbers are host times and are
never device metrics.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

FLUSH_BYTES = 2 ** 30             # 1 GiB
IDLE_FLUSH_BYTES = 64 * 2 ** 20   # 64 MB


def flush_buffer(device) -> torch.Tensor:
    """The L2 flush buffer for :func:`timed_ms`: 1 GiB of float32 on a CUDA
    device, an empty tensor on the CPU (nothing to flush)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.empty(FLUSH_BYTES // 4, device=device)
    if device.type == "cpu":
        return torch.empty(0)
    raise ValueError(f"timing: unsupported device {device}")


def timed_ms(label: str, fn: Callable[[], object], flush: torch.Tensor,
             reps: int = 20, run_ahead: bool = True) -> float:
    """Median time of one ``fn()`` in ms; the spread (min, quartiles, max)
    is printed under ``label``. ``flush`` comes from :func:`flush_buffer`
    and picks the clock: CUDA events on the card, ``perf_counter`` on the
    CPU."""
    for _ in range(3):
        fn()
    times = []
    if flush.device.type == "cuda":
        buf = flush if run_ahead else flush[:IDLE_FLUSH_BYTES // 4]
        for _ in range(reps):
            buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        clock = "device"
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        clock = "host (cpu)"
    lo, q1, med, q3, hi = np.percentile(times, [0, 25, 50, 75, 100])
    print(f"[spread] {label}: min {lo:.4f} q1 {q1:.4f} median {med:.4f} "
          f"q3 {q3:.4f} max {hi:.4f} ms over {reps} calls, {clock} clock",
          flush=True)
    return float(med)
