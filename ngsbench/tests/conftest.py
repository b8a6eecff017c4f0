"""A tiny copy of the benchmark's layout for CPU tests: the committed files
plus a traffic mix of a few thousand reads and two cells that use it."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FOLDER = REPO / "ngsbench"
sys.path.insert(0, str(REPO))


def copy_layout(dst: Path) -> Path:
    """BENCHMARK.json and the benchmark's folder (without its tests) under
    `dst`, with a tiny mix `tiny_lane`, its gzip twin `tiny_lane_gz` (the
    mix fastqc_pairs_512k_gz at 3,000 reads a file), a single-end
    configuration `tiny_se100`, and cells tiny_se, tiny_pe and
    tiny_pe_gz."""
    shutil.copytree(FOLDER, dst / "ngsbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    traffic = dst / "ngsbench" / "traffic"
    (traffic / "tiny_lane.json").write_text(json.dumps(
        {"tool": "fastqc", "argv": ["{out}", "{inputs}"],
         "reads_per_file": 3000, "sets": 2}))
    gz = json.loads((traffic / "fastqc_pairs_512k_gz.json").read_text())
    (traffic / "tiny_lane_gz.json").write_text(json.dumps(
        {**gz, "reads_per_file": 3000}))
    # the tool also takes single-end lanes: the PE 100 lane's reads, one mate
    se = json.loads((FOLDER / "configs" / "hpngs_pe100.json").read_text())
    se.update(name="tiny_se100", layout="SE")
    (dst / "ngsbench" / "configs" / "tiny_se100.json").write_text(
        json.dumps(se))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_se100", "source": "a test",
                             "file": "ngsbench/configs/tiny_se100.json",
                             "reduced": ["layout"], "why": "a test"})
    for name, cfg, mix in (("tiny_se", "tiny_se100", "tiny_lane"),
                           ("tiny_pe", "novaseq_s4_pe150", "tiny_lane"),
                           ("tiny_pe_gz", "novaseq_s4_pe150",
                            "tiny_lane_gz")):
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "a CPU test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny_se", "tiny_pe", "tiny_pe_gz"]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture
def tiny(tmp_path):
    """(layout root, run) where run(workload, seed, ...) is one run of the
    harness on the CPU with the environment restored afterwards."""
    from ngsbench import core

    root = copy_layout(tmp_path / "checkout")

    def run(workload, seed, seconds=0.5, trace=False, tool=None,
            layout=None):
        import torch

        layout = layout or core.Layout(root, root / "ngsbench")
        saved = dict(os.environ)
        t0 = time.monotonic()
        work = core.prepare_env(root)
        try:
            return core.run_cell(layout, layout.cell(workload), seed,
                                 seconds, trace, torch.device("cpu"), work,
                                 t0, tool=tool)
        finally:
            shutil.rmtree(work, ignore_errors=True)
            os.environ.clear()
            os.environ.update(saved)

    return root, run
