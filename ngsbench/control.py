"""The control of `correct`: a run of a cell with the tool's reference in
the program's place, computed from every second read (counts doubled),
which breaks the configuration's guarantee that every read is counted.
It has to come out as not correct; it prints, for each seed, each number
compared beside its limit. The benchmark's own runs never run it.

    python3 ngsbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 1] [--device cuda]
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


def control_tool(ref, sample: int = 2):
    """A request path that writes the reference's files from every
    `sample`-th read where the program writes its own."""
    def tool(name, argv, cwd, device):
        for suffix, text in ref.expected(argv[1:], device, sample).items():
            Path(argv[0] + suffix).write_text(text)
        return 0, b"", b""
    return tool


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    layout = core.Layout(ROOT)
    cell = layout.cell(args.workload)
    ref = layout.ref(cell.traffic["tool"])
    for seed in (int(s) for s in args.seeds.split(",")):
        work = core.prepare_env(ROOT)
        try:
            import torch

            r = core.run_cell(layout, cell, seed, args.seconds, False,
                              torch.device(args.device), work,
                              time.monotonic(), tool=control_tool(ref))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        leaked = core.forbidden_modules()
        if leaked:
            sys.stderr.write("ngsbench: the control loaded "
                             + ", ".join(leaked) + "\n")
            return 1
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": {k: c["value"]
                                     for k, c in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
