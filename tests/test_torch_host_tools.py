"""fastq_count_kthread and the host-only FASTQ tools through the port's
CLI (device="cpu") against ngstpu's CLI: the same files with the same
bytes (gzip outputs decompressed)."""

import gzip
import importlib
import os

import pytest

from ngstpu.testing.fixtures import gz, random_fastq, random_fastq_pair
from ngstpu.tools.cli import main as jax_cli
from ngstpu_torch.kernels import hist_cuda
from ngstpu_torch.tools.cli import HOST_ONLY, TOOLS
from ngstpu_torch.tools.cli import main as torch_cli


def _run_both(tmp_path, monkeypatch, tool, argv):
    """Run `tool` through both CLIs, each in a working directory of its
    own (IN_x names an input, OUT the output prefix); returns {side:
    {file: bytes}} of what each run wrote there."""
    files = {}
    for side, cli, pre in (("jax", jax_cli, []),
                           ("torch", torch_cli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        args = [str(d / "o") if a == "OUT" else
                str(tmp_path / a[3:]) if a.startswith("IN_") else a
                for a in argv]
        assert cli([*pre, tool, *args]) == 0
        files[side] = {}
        for f in sorted(os.listdir(d)):
            data = (d / f).read_bytes()
            files[side][f] = gzip.decompress(data) if f.endswith(".gz") \
                else data
    assert files["jax"].keys() == files["torch"].keys()
    for f, data in files["torch"].items():
        assert data == files["jax"][f], f
    return files["torch"]


@pytest.fixture
def inputs(tmp_path):
    (tmp_path / "a.fq").write_bytes(random_fastq(400, read_len=80,
                                                 var_len=True, seed=70))
    (tmp_path / "b.fq.gz").write_bytes(gz(random_fastq(250, read_len=60,
                                                       seed=71)))
    (tmp_path / "c.fq").write_bytes(random_fastq(300, read_len=120,
                                                 var_len=True, with_n=True,
                                                 seed=72))
    (tmp_path / "m.fq").write_bytes(random_fastq(150, read_len=80, seed=65,
                                                 qual_alphabet=b"#/7<BF"))
    r1, r2 = random_fastq_pair(300, 50, seed=73)
    (tmp_path / "r1.fq.gz").write_bytes(gz(r1))
    (tmp_path / "r2.fq.gz").write_bytes(gz(r2))
    # name-sorted mates that share only some names
    middle = set(range(100, 200))
    for mate, ids in ((1, sorted(set(range(0, 300, 2)) | middle)),
                      (2, sorted(set(range(0, 300, 3)) | middle))):
        recs = random_fastq(len(ids), 30, seed=74 + mate).split(b"\n")
        (tmp_path / f"p{mate}.fq").write_bytes(b"".join(
            b"@pp_%05d c/%d\n%s\n+\n%s\n" % (i, mate, recs[4 * k + 1],
                                              recs[4 * k + 3])
            for k, i in enumerate(ids)))


@pytest.mark.parametrize("route", ["fast", "generic"])
@pytest.mark.parametrize("threads", ["1", "2"])
def test_fastq_count_kthread(tmp_path, monkeypatch, inputs, threads, route):
    """-H -L -t N: the per-file TSVs (each with the 128 x maxLen printQ
    dump) and the merged output. The plain file takes the native fused
    pass on the fast route; gzip input, and every file on the generic
    route, goes through QCAccumulator and the histogram kernel's plain
    version."""
    monkeypatch.setenv("NGSTPU_LINK", "device")
    if route == "generic":
        monkeypatch.setenv("NGSTPU_NO_FASTPATH", "1")
    else:
        monkeypatch.delenv("NGSTPU_NO_FASTPATH", raising=False)
    out = _run_both(tmp_path, monkeypatch, "fastq_count_kthread",
                    ["-H", "-L", "-t", threads, "-o", "merged.tsv",
                     "IN_a.fq", "IN_b.fq.gz", "IN_c.fq"])
    assert sorted(out) == ["a.fq.0.tsv", "b.fq.gz.1.tsv", "c.fq.2.tsv",
                           "merged.tsv"]
    merged = out["merged.tsv"].decode().splitlines()
    assert merged[1].split("\t")[0] == "950"
    assert len(merged) == 2 + 2 + 128


def test_fastq_count_kthread_counts_no_launch_on_cpu(tmp_path, monkeypatch,
                                                     inputs):
    """On CPU tensors the histogram wrapper runs its plain version, from
    two threads at once, and counts no kernel launch."""
    monkeypatch.setenv("NGSTPU_NO_FASTPATH", "1")
    monkeypatch.setenv("NGSTPU_QC", "device")
    monkeypatch.chdir(tmp_path)
    launches = hist_cuda.LAUNCHES
    assert torch_cli(["--device", "cpu", "fastq_count_kthread", "-t", "2",
                      str(tmp_path / "a.fq"), str(tmp_path / "c.fq")]) == 0
    assert hist_cuda.LAUNCHES == launches
    assert (tmp_path / "a.fq.0.tsv").stat().st_size > 0


HOST_CASES = {
    "fastq_trim": ["-i", "IN_c.fq", "-s", "10", "-e", "70", "-o", "OUT"],
    "fastq_trim_gz": ["-i", "IN_b.fq.gz", "-e", "40", "-o", "OUT"],
    "gzfastq_sample": ["-1", "IN_b.fq.gz", "-n", "100", "-f"],
    "gzfastq_sample_pe": ["-1", "IN_r1.fq.gz", "-2", "IN_r2.fq.gz", "-n",
                          "77"],
    "pick_pair": ["-1", "IN_p1.fq", "-2", "IN_p2.fq", "-o", "OUT"],
    "gzfastq_mrle": ["-i", "IN_m.fq", "-o", "OUT"],
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_only_tools(tmp_path, monkeypatch, inputs, case):
    """Each HOST_ONLY tool is the port's own copy (a module of
    ngstpu_torch, called without a device) and writes the same files with
    the same bytes as ngstpu's tool on the same input (gzip outputs
    decompressed), non-empty."""
    tool = case.rsplit("_", 1)[0] if case not in TOOLS else case
    assert tool in HOST_ONLY
    assert TOOLS[tool] == f"ngstpu_torch.tools.{tool}"
    mod = importlib.import_module(TOOLS[tool])
    calls = []
    real = mod.main

    def spy(argv):
        calls.append(list(argv))
        return real(argv)

    monkeypatch.setattr(mod, "main", spy)
    out = _run_both(tmp_path, monkeypatch, tool, HOST_CASES[case])
    assert len(calls) == 1
    assert out and all(out.values()), sorted(out)
