"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 ngsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. It
makes the cell's inputs from the seed, warms the program up, calls the
tool back to back for `--seconds`, checks every call's outputs against
the plain reference, and prints one JSON line: the cell's end-to-end
metrics (`--trace 0`) or its per-layer metrics from a torch.profiler
trace of the window (`--trace 1`). The numbers compared, each beside its
limit, are the last lines of standard error and the line's last key.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ngsbench import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    leaked = core.forbidden_modules()
    if leaked:
        sys.stderr.write("ngsbench: loaded before the run: "
                         + ", ".join(leaked) + "\n")
        return 1
    layout = core.Layout(ROOT)
    cell = layout.cell(args.workload)
    work = core.prepare_env(ROOT)
    try:
        import torch

        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            sys.stderr.write(f"ngsbench: {args.workload} needs {cell.chips} "
                             "CUDA device(s); torch sees "
                             f"{torch.cuda.device_count()}\n")
            return 2
        result = core.run_cell(layout, cell, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0),
                               work, T0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the reference, the link probe's record and the metric readers were
    # loaded after the window: look again before anything is printed
    leaked = core.forbidden_modules()
    if leaked:
        sys.stderr.write("ngsbench: the run loaded " + ", ".join(leaked)
                         + "\n")
        return 1
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name} {c['value']} limit {c['limit']}\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
