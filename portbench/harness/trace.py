"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
the whole window, read back into device intervals, kernel times by name,
host-to-device copies, and idle gaps labelled by the host span around
them (the ``record_function`` ranges of :mod:`.spans`)."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LABELS = ("loader_wait", "step", "predict_batch", "epoch_fetch")


class Trace:
    """Device events of the traced window (times in seconds)."""

    def __init__(self, events: List[dict]):
        self.device = []           # (start, end, name, cat)
        self.host = []             # (start, end, label)
        window = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), cat))
            elif cat == "user_annotation" and e.get("name") == "window":
                window = (ts, ts + dur)
            elif cat == "user_annotation" and e.get("name") in HOST_LABELS:
                self.host.append((ts, ts + dur, e["name"]))
        if window is None:
            raise RuntimeError("the trace holds no 'window' range")
        # the window's range ends when its last unit has been handed out;
        # the device work that it enqueued runs on, up to the driver's
        # synchronisation, and belongs to the window
        self.t0 = window[0]
        self.device.sort()
        self.device = [d for d in self.device if d[1] > self.t0]
        self.t1 = max([window[1]] + [d[1] for d in self.device])
        self.window_s = self.t1 - self.t0
        self.host.sort()

    def busy_intervals(self) -> List[tuple]:
        merged: List[list] = []
        for s, t, _, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals())

    def kernel_seconds(self, match: List[str]) -> tuple:
        """``(seconds, launches)`` of the kernels whose name holds every
        string of ``match``."""
        secs, n = 0.0, 0
        for s, t, name, cat in self.device:
            if cat == "kernel" and all(m in name for m in match):
                secs += t - s
                n += 1
        return secs, n

    def h2d_seconds(self) -> float:
        return sum(t - s for s, t, name, cat in self.device
                   if cat == "gpu_memcpy" and "HtoD" in name)

    def device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for s, t, name, _ in self.device:
            by[name] += t - s
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time of the window, by the host span that holds the
        middle of each gap (``other`` where none does)."""
        starts = [h[0] for h in self.host]
        edges = [(self.t0, self.t0)] + self.busy_intervals() + \
            [(self.t1, self.t1)]
        by = defaultdict(float)
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b <= a:
                continue
            mid, label = 0.5 * (a + b), "other"
            k = bisect.bisect_right(starts, mid) - 1
            for h in self.host[max(0, k - 8):k + 1][::-1]:
                if h[0] <= mid <= h[1]:
                    label = h[2]
                    break
            by[label] += b - a
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]


class Profiler:
    """``torch.profiler`` over CPU and CUDA activity, started and stopped
    by the driver around its window."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if self._cuda:
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities,
                             record_shapes=False, profile_memory=False,
                             with_stack=False)

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self) -> Trace:
        if self._cuda:
            self._torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return Trace(events)
