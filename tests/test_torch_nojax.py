"""The port stands alone: it runs where neither jax nor ngstpu can be
imported, and no file of it names the JAX package's modules."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

CHILD = r"""
import importlib, os, sys

BLOCKED = ("jax", "jaxlib", "ngstpu")


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Block())
import pkgutil

import ngstpu_torch

for m in pkgutil.walk_packages(ngstpu_torch.__path__, "ngstpu_torch."):
    importlib.import_module(m.name)

from ngstpu_torch.ops import twobit
from ngstpu_torch.testing.fixtures import random_fastq
from ngstpu_torch.tools import cli, fastq2twobit

d = sys.argv[1]
open(f"{d}/acgt.fq", "wb").write(random_fastq(200, 60, seed=1, dup_frac=0.3))
open(f"{d}/n.fq", "wb").write(random_fastq(200, 60, seed=2, with_n=True,
                                            dup_frac=0.3))
ran = set()


def run(*argv, out=None):
    assert cli.main(["--device", "cpu", *argv]) == 0, argv
    ran.add(argv[0])
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
run("fastq_count_kthread", "-H", "-L", "-t", "2", "-o", f"{d}/kt.tsv",
    f"{d}/n.fq", f"{d}/acgt.fq", out=f"{d}/kt.tsv")
from ngstpu_torch.ops.fastqc import FASTQC
from ngstpu_torch.testing.fixtures import (illumina_fastq_fast,
                                           illumina_fastq_pair_fast)

open(f"{d}/il.fq", "wb").write(illumina_fastq_fast(
    600, 80, seed=3, n_tiles=5, dup_frac=0.3, hot=2, n_frac=0.05,
    adapter_frac=0.05, min_len=50))
for m, data in enumerate(illumina_fastq_pair_fast(400, 60, seed=4,
                                                  n_tiles=5, n_frac=0.05)):
    open(f"{d}/il_{m + 1}.fq", "wb").write(data)
for link in ("device", "host"):
    os.environ["NGSTPU_LINK"] = link
    run("fastqc", f"{d}/se_{link}", f"{d}/il.fq",
        out=f"{d}/se_{link}_per_tile_mate1.tsv")
    run("fastqc", f"{d}/pe_{link}", f"{d}/il_1.fq", f"{d}/il_2.fq",
        out=f"{d}/pe_{link}_overrepresented.tsv")
assert FASTQC["per_tile_quality", "cpu"] == 3, FASTQC
run("fastq_trim", "-i", f"{d}/n.fq", "-e", "40", "-o", f"{d}/tr",
    out=f"{d}/tr.trim.fastq")
run("gzfastq_sample", "-1", f"{d}/n.fq", "-n", "50")
run("pick_pair", "-1", f"{d}/il_1.fq", "-2", f"{d}/il_2.fq", "-o", f"{d}/pp",
    out=f"{d}/pp_1_PE.fq.gz")
open(f"{d}/q6.fq", "wb").write(random_fastq(100, 40, seed=5,
                                            qual_alphabet=b"#/7<BF"))
run("gzfastq_mrle", "-i", f"{d}/q6.fq", "-o", f"{d}/rle",
    out=f"{d}/rle_sort_by_seq.fq")
from ngstpu_torch.ops.bamops import PILEUP
from ngstpu_torch.testing.bamfixtures import random_bam_fast

bam = f"{d}/b.bam"
random_bam_fast(bam, [("c1", 30000), ("c2", 20000)], 600, seed=6)
run("index", bam, out=f"{bam}.bai")
os.environ["NGSTPU_LINK"] = "device"
for mode in ("events", "dense", "sparse"):
    os.environ["NGSTPU_PILEUP_MODE"] = mode
    run("bam2depth", "-W", "-w", "5000", "-o", f"{d}/bd_{mode}", bam,
        out=f"{d}/bd_{mode}.1.wig")
    run("bam2wig", "-w", "5000", "-o", f"{d}/bw_{mode}", bam,
        out=f"{d}/bw_{mode}.1.wig")
assert PILEUP["sparse_pileup_sweep", "cpu"] == 4, PILEUP
run("bam_sliding_count", "-w", "5000", "-r", "c1:1-10000", "-o", f"{d}/sc",
    bam, out=f"{d}/sc.txt")
run("bamSplitChr", "-o", f"{d}/sp", bam, out=f"{d}/sp_c2.bam")
assert ran == set(cli.TOOLS), set(cli.TOOLS) - ran
# the alignment functions and the warm server (start, a request, shutdown)
import contextlib, io, json, socket, tempfile, threading, time

import torch

from ngstpu_torch.ops import align
from ngstpu_torch.tools import server

g = torch.Generator().manual_seed(8)
q = torch.randint(65, 69, (8, 12), dtype=torch.uint8, generator=g)
t = torch.randint(65, 69, (8, 16), dtype=torch.uint8, generator=g)
ql, tl = torch.full((8,), 12, dtype=torch.int32), torch.full(
    (8,), 16, dtype=torch.int32)
assert align.sw_score_batch(q, ql, t, tl).shape == (8,)
assert align.sw_align_batch(q, ql, t, tl)["row_max"].shape == (8, 16)
h0 = torch.full((8,), 10, dtype=torch.int32)
assert (align.sw_extend_batch(q, ql, t, tl, h0)[0] >= 10).all()
sock = tempfile.mkdtemp(dir="/tmp", prefix="ngt") + "/s"
th = threading.Thread(target=server.serve, args=(sock, "cpu"), daemon=True)
th.start()
deadline = time.monotonic() + 60
while not os.path.exists(sock):
    assert th.is_alive() and time.monotonic() < deadline
    time.sleep(0.02)
out = io.TextIOWrapper(io.BytesIO())
with contextlib.redirect_stdout(out):
    assert server.call_server(sock, "fastq_count", [f"{d}/n.fq"],
                              timeout=60) == 0
assert out.buffer.getvalue().startswith(f"{d}/n.fq\t200\t".encode())
with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
    s.settimeout(30)
    s.connect(sock)
    s.sendall(b'{"op": "shutdown"}\n')
    assert json.loads(s.makefile("rb").readline()) == {"rc": 0}
th.join(timeout=30)
assert not th.is_alive()
os.rmdir(os.path.dirname(sock))
# the parallel layer: every sharded path on two CPU shards
from ngstpu_torch.parallel import dryrun

dryrun.dryrun_multichip(2, "cpu")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("NOJAX-OK")
"""


def test_slice_runs_without_jax(tmp_path):
    env = {**os.environ, "HOME": str(tmp_path), "NGSTPU_SHM_POOL": "0",
           "NGSTPU_LINK": "device", "NGSTPU_QC": "device",
           "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
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


# what the port's files may not hold: a line importing the JAX package, or
# a dotted name of one of its modules (an import by string); each pattern
# with a line it must catch and one of the port's own it must let pass
NGSTPU_REFS = {
    "import": (re.compile(r"^\s*(import|from)\s+ngstpu(\.|\s|$)"),
               "from ngstpu.io import native",
               "from ngstpu_torch.io import native"),
    "module name": (re.compile(r"\bngstpu\.[A-Za-z_]"),
                    "mod = 'ngstpu.tools.fastq_trim'",
                    "mod = 'ngstpu_torch.tools.fastq_trim'"),
}


@pytest.mark.parametrize("kind", list(NGSTPU_REFS))
def test_no_ngstpu_references(kind):
    pat, bad, good = NGSTPU_REFS[kind]
    assert pat.search(bad) and not pat.search(good)
    files = sorted((REPO / "ngstpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    hits = [f"{p.relative_to(REPO)}:{i}: {line.strip()}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert not hits, hits
