"""The port runs where jax cannot be imported."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SLICE = ["ngstpu_torch", "ngstpu_torch.kernels.build",
         "ngstpu_torch.kernels.hist_cuda", "ngstpu_torch.ops.count",
         "ngstpu_torch.ops.sortengine", "ngstpu_torch.ops.twobit",
         "ngstpu_torch.tools.cli", "ngstpu_torch.tools.emitters",
         "ngstpu_torch.tools.fastq_count", "ngstpu_torch.tools.fastq2twobit",
         "ngstpu_torch.tools.gzfastq_sort",
         "ngstpu_torch.tools.gzfastq_sort_list",
         "ngstpu_torch.tools.gzfastq_uniq", "ngstpu_torch.tools.gzfastq_uniqQ",
         "ngstpu_torch.tools.gzfastq_uniq_sort",
         "ngstpu_torch.tools.ordered_uniq", "ngstpu_torch.tools.pipeline",
         "ngstpu_torch.tools.profile_pipeline", "ngstpu_torch.tools.twobit2seq",
         "ngstpu_torch.testing.fixtures", "ngstpu_torch.utils.device",
         "ngstpu_torch.utils.linkprobe"]

CHILD = r"""
import importlib, os, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _NoJax())
for mod in sys.argv[2:]:
    importlib.import_module(mod)

from ngstpu.testing.fixtures import random_fastq
from ngstpu_torch.ops import twobit
from ngstpu_torch.tools import cli, fastq2twobit

d = sys.argv[1]
open(f"{d}/acgt.fq", "wb").write(random_fastq(200, 60, seed=1, dup_frac=0.3))
open(f"{d}/n.fq", "wb").write(random_fastq(200, 60, seed=2, with_n=True,
                                            dup_frac=0.3))


def run(*argv, out=None):
    assert cli.main(["--device", "cpu", *argv]) == 0, argv
    if out:
        assert os.path.getsize(out) > 0, out


for name in ("acgt", "n"):
    i, o = f"{d}/{name}.fq", f"{d}/{name}"
    run("pipeline", "-i", i, "-o", o, "-e", "30", out=f"{o}_uniq.fq")
    run("gzfastq_uniq", "-1", i, "-o", o, out=f"{o}_sortKeyUniq.fq")
    run("gzfastq_uniq", "-1", i, "-2", i, "-o", o, out=f"{o}_2_uniq.fq")
    for flag in ("-s", "-n"):
        run("gzfastq_sort", "-i", i, flag, "-o", o)
        run("gzfastq_sort_list", "-i", i, flag, "-o", f"{o}.l")
    run("gzfastq_uniqQ", "-1", i, "-C", "-o", o, out=f"{o}_sortKeyUniq.fq")
    run("gzfastq_uniq_sort", "-1", i, "-2", i, "-o", o,
        out=f"{o}_2_uniq.fq.gz")
    run("ordered_uniq", "-i", i, "-r", "20", "-o", f"{o}.ord", out=f"{o}.ord")
# the device codec, below its 8 MB floor
fastq2twobit.DEVICE_MIN_BYTES = 0
os.environ["NGSTPU_NO_FASTPATH"] = "1"
run("fastq2twobit", "-i", f"{d}/n.fq", "-s", "-o", f"{d}/tb")
run("twoBit2seq", "-i", f"{d}/tb_sort_by_seq.fq", "-o", f"{d}/tb",
    out=f"{d}/tb.decompress")
assert twobit.CODEC["pack2bit", "cpu"] == twobit.CODEC["unpack2bit", "cpu"] == 1
run("fastq_count", f"{d}/n.fq")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert "jax" not in sys.modules and not loaded, loaded
assert "ngstpu.utils.linkprobe" not in sys.modules
assert "ngstpu.tools.gzfastq_uniqQ" not in sys.modules
print("NOJAX-OK")
"""


def test_slice_runs_without_jax(tmp_path):
    env = {**os.environ, "HOME": str(tmp_path), "NGSTPU_SHM_POOL": "0",
           "NGSTPU_LINK": "device", "NGSTPU_QC": "device",
           "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path), *SLICE],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "NOJAX-OK" in r.stdout


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+jax\b")
    hits = [f"{p}:{i}" for p in (REPO / "ngstpu_torch").rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.match(line)]
    hits += [f"chip_smoke.py:{i}" for i, line in enumerate(
        (REPO / "chip_smoke.py").read_text().splitlines(), 1)
        if pat.match(line)]
    assert not hits
