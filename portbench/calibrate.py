"""The readings that a cell's limits are set from (PERF.md): the program's
comparison numbers over many seeds, the control's (the reference put in
the program's place at the nearest precision below the configuration's,
TF32 products), and the planted faults' (``faults.py``), at the cell's own
size, all in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault half_batch --fault-seeds 7,8,9] \\
        [--seconds 3]

Every cell runs a short window (``--seconds``) at its own load and
compares as a run does: a training cell its first steps and the
window's, a screening cell the answers of its finished chunks. One JSON
line a reading.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(workload: str, seed: int, seconds: float, device,
             fault: str = None, control: bool = False,
             bench_dir: str = None, man: dict = None) -> dict:
    """One reading: the comparison's numbers of the program (or of the
    program with ``fault`` planted, or of the control) on ``seed``."""
    import contextlib

    from portbench import faults
    from portbench.harness import cell, checks, screen, train
    bench_dir = bench_dir or cell.BENCH_DIR
    man = man or cell.manifest(ROOT)
    spec = cell.find_cell(man, workload)
    cfg = cell.load_json("configs", spec["config"], bench_dir)
    traffic = cell.load_json("traffic", spec["traffic"], bench_dir)
    ctx = cell.Context(workload=workload, cfg=cfg, traffic=traffic,
                       limits={}, seed=seed, window_seconds=seconds,
                       trace=False, device=device,
                       process_start=time.perf_counter())
    planted = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    t = time.perf_counter()
    with planted:
        if traffic["kind"] == "train":
            # the window's first checked steps are compared, so the
            # window runs, for ``seconds``
            c = train.TrainCell(ctx)
            c.setup()
            c.window(seconds)
            c.release()
            rows_ok = c.rows_ok()
            if control:
                # the control: the reference at TF32 in the program's place
                numbers = train.numbers(c.reference("tf32"), c.reference())
            else:
                numbers = c.verdict()
        else:
            c = screen.ScreenCell(ctx)
            c.setup()
            c.window(seconds)
            c.release()
            pick = c.sample()
            if control and pick:
                numbers = {"pred_gap": checks.pred_gap(
                    c.reference(pick, "tf32") * c.stds + c.means,
                    c.reference(pick), c.means, c.stds)}
            elif control:
                numbers = {"pred_gap": float("inf")}
            else:
                numbers = c.verdict()
            rows_ok = c.rows_ok
    return {"workload": workload, "seed": seed, "fault": fault,
            "control": control, "rows_ok": rows_ok, "numbers": numbers,
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    jobs = [(s, None, False) for s in seeds(args.seeds)]
    jobs += [(s, None, True) for s in seeds(args.control_seeds)]
    jobs += [(s, args.fault, False) for s in seeds(args.fault_seeds)]
    for seed, fault, control in jobs:
        r = readings(args.workload, seed, args.seconds, device, fault,
                     control)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
