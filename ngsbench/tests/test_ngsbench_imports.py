"""The import guard: nothing the benchmark loads is JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import pytest

from conftest import FOLDER, REPO, copy_layout

from ngsbench import core

# a child that cannot import the names given in argv[1] (comma-separated)
BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
BLOCKED = set(sys.argv[1].split(","))
sys.meta_path.insert(0, Block())
"""


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in FOLDER.rglob("*.py"):
        tops = set(imported_tops(path))
        assert not tops & set(core.FORBIDDEN), path
        if "refs" in path.parts:
            assert "ngstpu_torch" not in tops, path


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ngstpu_torchlike",
                        types.ModuleType("ngstpu_torchlike"))
    assert "ngstpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ngstpu.tools",
                        types.ModuleType("ngstpu.tools"))
    assert core.forbidden_modules() == ["ngstpu"]


def test_run_loads_no_jax(tmp_path):
    root = copy_layout(tmp_path / "checkout")
    code = BLOCK + f"""
import json, shutil, time, torch
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from ngsbench import core
root = Path({str(root)!r})
layout = core.Layout(root, root / "ngsbench")
t0 = time.monotonic()
work = core.prepare_env(root)
r = core.run_cell(layout, layout.cell("tiny_se"), 11, 0.3, False,
                  torch.device("cpu"), work, t0)
shutil.rmtree(work)
print(json.dumps([r["correct"], core.forbidden_modules(),
                  "ngstpu_torch" in sys.modules]))
"""
    out = subprocess.run([sys.executable, "-c", code,
                          ",".join(core.FORBIDDEN)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [True, [], True]


def test_reference_loads_nothing_of_the_port(tmp_path):
    (tmp_path / "a.fq").write_text("@r0\nACGTN\n+\nFFFF#\n")
    code = BLOCK + f"""
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from ngsbench import core
layout = core.Layout(Path({str(REPO)!r}))
ref = layout.ref("fastqc")
exp = ref.expected([{str(tmp_path / "a.fq")!r}])
print(len(exp), sorted({{m.split(".")[0] for m in sys.modules}}
                       & {{"ngstpu_torch", "jax", "ngstpu"}}))
"""
    out = subprocess.run([sys.executable, "-c", code,
                          ",".join(core.FORBIDDEN + ("ngstpu_torch",))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["9", "[]"]  # no tiles in these names


@pytest.mark.parametrize("bare", [False, True])
def test_no_card_no_result(tmp_path, bare):
    """Without the card, or in a checkout holding only BENCHMARK.json and
    the benchmark's folder, a run fails and prints no result."""
    root = REPO
    if bare:
        root = tmp_path / "bare"
        root.mkdir()
        shutil.copy(REPO / "BENCHMARK.json", root)
        shutil.copytree(FOLDER, root / "ngsbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "ngsbench/run.py", "--workload", "pe100_fastqc_lane",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""


def test_result_withheld_if_jax_loads_after_the_window(monkeypatch, capsys):
    """A module that brings JAX in after the window (the reference, a
    metric reader) still stops the result from being printed."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("ngsbench_run_main",
                                                  FOLDER / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)

    def run_cell(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True, "checks": {}}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run.core, "run_cell", run_cell)
    monkeypatch.setattr(run.core, "prepare_env",
                        lambda root: Path(tempfile.mkdtemp()))
    monkeypatch.setattr(os, "environ", dict(os.environ))
    rc = run.main(["--workload", "pe100_fastqc_lane", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err
