"""What decides `correct`: sound runs pass; the control (the reference in
the program's place, from every second read) and each fault the cells can
have fail. Runs the rest of a run at a tiny size on the CPU; the one test
that needs the card skips without it."""

from __future__ import annotations

import gzip
import re
from pathlib import Path

import pytest

from conftest import FOLDER

from ngsbench import core
from ngsbench.refs import fastqc as ref


def inputs_of(argv):
    return argv[1:]


@pytest.mark.parametrize("workload", ["tiny_se", "tiny_pe", "tiny_pe_gz"])
def test_sound_run(tiny, workload):
    _, run = tiny
    r = run(workload, 2 ** 31 + 13)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert {c["value"] for c in r["checks"].values()} == {0}


@pytest.mark.parametrize("workload", ["tiny_se", "tiny_pe", "tiny_pe_gz"])
def test_traced_run(tiny, workload):
    _, run = tiny
    r = run(workload, 17, trace=True)
    assert r["correct"]
    assert {"fastqc.host_s_per_mreads", "fastqc.modules_s_per_mreads",
            "fastqc.parse_s_per_mreads", "device.idle_share"} <= \
        set(r["metrics"])
    assert r["device"]["window_s"] > 0
    assert {s for s, _ in r["breakdown"]["idle_gaps"]} & {"render1",
                                                         "modules1"}


@pytest.mark.parametrize("workload", ["tiny_se", "tiny_pe", "tiny_pe_gz"])
def test_control_fails(tiny, workload):
    """The reference from every second read, counts doubled, written where
    the program writes its files."""
    from ngsbench.control import control_tool

    _, run = tiny
    r = run(workload, 29, tool=control_tool(ref))
    assert not r["correct"] and r["failed"] == r["attempted"]
    assert r["checks"]["quality"]["value"] > 0


def faulty(kind):
    """The program's request path with one fault planted in it."""
    real = core.port_tool()

    def tool(name, argv, cwd, device):
        if kind == "state_unchanged":  # the call does nothing
            return 0, b"", b""
        if kind == "half_batch":  # the first half of the reads alone
            halves = []
            for p in inputs_of(argv):
                data = Path(p).read_bytes()
                gz = data[:2] == b"\x1f\x8b"
                lines = (gzip.decompress(data) if gz else data).split(
                    b"\n")[:-1]
                half = b"\n".join(lines[:len(lines) // 8 * 4]) + b"\n"
                Path(p + ".half").write_bytes(
                    gzip.compress(half, 1, mtime=0) if gz else half)
                halves.append(p + ".half")
            return real(name, [argv[0]] + halves, cwd, device)
        rc, out, err = real(name, argv, cwd, device)
        if kind == "call_fails":  # the window's calls write, then fail
            return int("/out/" in argv[0]), out, err
        # an answer altered where it is produced: one count, one more
        q = Path(argv[0] + "_quality_mate1.tsv")
        lines = q.read_text().splitlines()
        f = lines[60].split("\t")
        f[5] = str(int(f[5]) + 1)
        lines[60] = "\t".join(f)
        q.write_text("\n".join(lines) + "\n")
        return rc, out, err

    return tool


@pytest.mark.parametrize("workload", ["tiny_se", "tiny_pe_gz"])
@pytest.mark.parametrize("kind,numbers", [
    ("state_unchanged", {"quality", "length", "duplication"}),
    ("half_batch", {"quality", "length", "duplication"}),
    ("answer_altered", {"quality"}),
    ("call_fails", {"calls_rc_nonzero"})])
def test_fault_fails(tiny, kind, numbers, workload):
    _, run = tiny
    r = run(workload, 31, tool=faulty(kind))
    assert not r["correct"] and r["failed"] == r["attempted"]
    bad = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert numbers <= bad


def test_bench_names_files_that_exist():
    import json

    bench = json.loads((FOLDER.parent / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for w in bench["workloads"]:
        assert (FOLDER / "traffic" / f"{w['traffic']}.json").is_file()
        assert name.match(w["name"])
    for c in bench["configs"]:
        assert (FOLDER.parent / c["file"]).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (FOLDER / "metrics" / f"{m['name']}.py").is_file()
        assert name.match(m["name"])


@pytest.mark.gpu
def test_tiny_cell_on_the_card(tiny):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root, _ = tiny
    import os
    import shutil
    import time

    layout = core.Layout(root, root / "ngsbench")
    saved = dict(os.environ)
    t0 = time.monotonic()
    work = core.prepare_env(root)
    try:
        r = core.run_cell(layout, layout.cell("tiny_pe"), 37, 0.5, True,
                          torch.device("cuda", 0), work, t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        os.environ.clear()
        os.environ.update(saved)
    assert r["correct"] and r["device"]["busy_s"] > 0
    assert "qc_hist_roofline" in r["metrics"]
