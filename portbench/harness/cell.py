"""One run of one cell, found by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix and the metrics it reports; the
configuration is ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json`` (its ``kind`` picks the driver), the limits of
its comparison ``limits/<cell>.json``, and each per-layer metric its
reader (``metrics/<metric>/``, or the stem of its name). Nothing here changes when a later change
adds a cell, a configuration, a traffic mix or a metric as files."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "polymer_chemprop_tpu")


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(man: dict, workload: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def cell_metrics(man: dict, workload: str) -> tuple:
    """``(end_to_end, per_layer)``: the metrics this cell reports, each
    where its ``workloads`` list names the cell or where it has none."""
    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    return ([m for m in man["end_to_end"] if mine(m)],
            [m for m in man["per_layer"] if mine(m)])


def reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(record)`` of a per-layer metric: ``metrics/<metric>/
    reader.py`` where the metric has one, else the reading of
    :func:`.readings.by_name` (by its stem, or its listed kernels)."""
    from . import readings
    folder = os.path.join(bench_dir, "metrics", metric)
    path = os.path.join(folder, "reader.py")
    if not os.path.exists(path):
        read = readings.by_name(metric, folder)
        if read is None:
            raise KeyError(f"no reader for the metric {metric!r}")
        return read
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (names compared whole)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    workload: str
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    window_seconds: float
    trace: bool
    device: object
    process_start: float

    def mark(self, phase: str) -> None:
        """One set-up phase's end on standard error, in seconds since the
        process started."""
        print(f"[portbench] set-up: {phase} at "
              f"{time.perf_counter() - self.process_start:.3f} s",
              file=sys.stderr, flush=True)

    def profiler(self):
        if not self.trace:
            return None
        from .trace import Profiler
        return Profiler()


def driver(kind: str):
    return importlib.import_module(f"{__package__}.{kind}")


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        process_start: float, man: Optional[dict] = None,
        bench_dir: str = BENCH_DIR):
    """Runs the cell; returns ``(record, result line dict)``."""
    from . import checks
    man = manifest() if man is None else man
    cell = find_cell(man, workload)
    cfg = load_json("configs", cell["config"], bench_dir)
    traffic = load_json("traffic", cell["traffic"], bench_dir)
    window = float(seconds)
    if trace and traffic.get("trace_seconds"):
        window = min(window, float(traffic["trace_seconds"]))
    ctx = Context(workload=workload, cfg=cfg, traffic=traffic,
                  limits=checks.limits(workload,
                                       os.path.join(bench_dir, "limits")),
                  seed=int(seed),
                  window_seconds=window, trace=bool(trace), device=device,
                  process_start=process_start)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    ctx.mark("torch and the card")
    rec = driver(traffic["kind"]).run(ctx)
    e2e, per_layer = cell_metrics(man, workload)
    metrics = {}
    if not trace:
        for m in e2e:
            metrics[m["name"]] = {"value": rec.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in per_layer:
            value = reader(m["name"], bench_dir)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": rec.memory_peak_bytes}
    line = {"correct": rec.correct, "attempted": rec.attempted,
            "failed": rec.failed, "metrics": metrics, "device": device_info}
    if trace and rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s()
        device_info["window_s"] = rec.trace.window_s
        line["breakdown"] = {"device_ops": rec.trace.device_ops(),
                             "idle_gaps": rec.trace.idle_gaps()}
    line["checks"] = rec.checks
    return rec, line
