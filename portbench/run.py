"""One run of one benchmark cell of the port (``polymer_chemprop_tpu_torch``)
on one H100:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checked numbers beside their limits on standard error, and as
its last line on standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks`` comes last. Exits 2, printing no result, without
a CUDA card, and 3 when a module of JAX or of the JAX package was loaded.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the run writes stays inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", "portbench", sub))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    print(f"[portbench] set-up: torch imported at "
          f"{time.perf_counter() - PROCESS_START:.3f} s", file=sys.stderr)
    from portbench.harness import cell

    man = cell.manifest(ROOT)
    spec = cell.find_cell(man, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"[portbench] {args.workload} needs {spec['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec, line = cell.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device, PROCESS_START, man=man)
    bad = cell.forbidden_modules()
    if bad:
        print(f"[portbench] modules of JAX or of the JAX package were "
              f"loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"[portbench] correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"[portbench] check {name}: {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
