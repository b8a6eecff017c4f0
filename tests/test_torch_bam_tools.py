"""The BAM tools through the port's CLI (--device cpu) against ngstpu's
CLI: the same files with the same bytes (split BAMs decompressed), the
same standard output and the same stderr apart from timings."""

import contextlib
import gzip
import importlib
import io
import os
import re

import pytest
import torch

from ngstpu.io import bam as j_bam
from ngstpu.testing.bamfixtures import encode_record, random_bam
from ngstpu.tools.cli import main as jax_cli
from ngstpu_torch.io import bam as t_bam
from ngstpu_torch.io.bai import write_bai
from ngstpu_torch.ops.bamops import PILEUP
from ngstpu_torch.testing.bamfixtures import make_bam
from ngstpu_torch.tools.cli import HOST_ONLY, TOOLS
from ngstpu_torch.tools.cli import main as torch_cli

REFS = [("chr1", 100_000), ("chr2", 80_000), ("chrX", 43_000)]
TIMING = re.compile(r" at \d+\.\d{3} s$")


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """3,000 reads of 100 bp over three references, with the port's .bai
    beside it (bam_sliding_count -r reads it)."""
    d = tmp_path_factory.mktemp("bamtools")
    p = d / "t.bam"
    random_bam(str(p), REFS, n_reads=3000, seed=7, read_len=100)
    write_bai(str(p))
    return p


def _run_both(tmp_path, monkeypatch, tool, argv, rc=0, after=None):
    """Run `tool` through both CLIs, each in a working directory of its own
    (OUT names the output prefix there); returns {file: bytes} of what
    the port wrote. Files, stdout, stderr (timings dropped, the
    directory's path masked) and what `after()` returns after each run
    must be equal, and each exit code `rc`."""
    seen = {}
    for side, cli, pre in (("jax", jax_cli, []),
                           ("torch", torch_cli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir(parents=True)
        monkeypatch.chdir(d)
        args = [str(d / "o") if a == "OUT" else a for a in argv]
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                got = cli([*pre, tool, *args])
            except SystemExit as e:  # bam_sliding_count's invalid region
                got = e.code
        assert got == rc, err.getvalue()
        files = {}
        for f in sorted(os.listdir(d)):
            data = (d / f).read_bytes()
            files[f] = gzip.decompress(data) if f.endswith(".bam") else data
        lines = [ln.replace(str(d), "DIR") for ln in
                 err.getvalue().replace("ngstpu-torch", "ngstpu").splitlines()
                 if not TIMING.search(ln)]
        seen[side] = files, out.getvalue(), lines, after and after()
    assert seen["torch"] == seen["jax"]
    return seen["torch"][0]


DEPTH_ARGV = {"bam2depth": ["-o", "OUT", "-w", "6000", "-W"],
              "bam2wig": ["-o", "OUT", "-w", "6000"]}
DEPTH_FILES = {"bam2depth": ["o.1.chromSize.txt", "o.1.depth", "o.1.wig",
                             "t.bam.1.bedGraph"],
               "bam2wig": ["o.1.chromSize.txt", "o.1.wig"]}


@pytest.mark.parametrize("link", ["host", "device"])
@pytest.mark.parametrize("mode", ["default", "events", "dense", "sparse"])
@pytest.mark.parametrize("tool", ["bam2depth", "bam2wig"])
def test_depth_tools(tmp_path, monkeypatch, bam, tool, mode, link):
    """Each pileup mode under both link verdicts; the torch sweep runs once
    per chromosome exactly on the sparse route with the device verdict."""
    monkeypatch.setenv("NGSTPU_LINK", link)
    if mode == "default":
        monkeypatch.delenv("NGSTPU_PILEUP_MODE", raising=False)
    else:
        monkeypatch.setenv("NGSTPU_PILEUP_MODE", mode)
    before = PILEUP["sparse_pileup_sweep", "cpu"]
    out = _run_both(tmp_path, monkeypatch, tool,
                    [*DEPTH_ARGV[tool], str(bam)])
    assert sorted(out) == DEPTH_FILES[tool]
    assert all(out.values())
    sweeps = PILEUP["sparse_pileup_sweep", "cpu"] - before
    assert sweeps == (len(REFS) if (mode, link) == ("sparse", "device")
                      else 0)


def _midstream_bam(path) -> None:
    """tests/test_bam_tools.py's case: chromosome 1 is emitted before the
    chunk with a negative-start record on chromosome 2 is scanned."""
    seq = "ACGT" * 25
    recs = [encode_record(f"a{i}", 0, 10 + i, 30, "100M", seq)
            for i in range(800)]
    recs += [encode_record(f"b{i}", 1, 5 + i, 30, "100M", seq)
             for i in range(800)]
    recs += [encode_record("bad", 1, -7, 30, "100M", seq)]
    make_bam(str(path), [("c1", 5000), ("c2", 4000)], recs)


@pytest.mark.parametrize("link", ["host", "device"])
def test_bam2depth_dense_midstream_fallback(tmp_path, monkeypatch, link):
    """The dense engine raises DensePileupUnsupported after chromosome 1 was
    written: with -o FILE both ports rerun on the sparse route and write
    the same truncated-and-rewritten files (the port's sweep on the
    device verdict); to stdout both refuse with the same message."""
    bam = tmp_path / "mid.bam"
    _midstream_bam(bam)
    monkeypatch.setenv("NGSTPU_PILEUP_MODE", "dense")
    monkeypatch.setenv("NGSTPU_LINK", link)
    for mod in (j_bam, t_bam):
        orig = mod.stream_depth_dense
        monkeypatch.setattr(
            mod, "stream_depth_dense",
            lambda p, m, _orig=orig, **kw: _orig(p, m, chunk_bytes=2048,
                                                 **kw))
    before = PILEUP["sparse_pileup_sweep", "cpu"]
    out = _run_both(tmp_path / "file", monkeypatch, "bam2depth",
                    ["-o", "OUT", "-w", "700", "-W", str(bam)])
    assert sorted(out) == ["mid.bam.1.bedGraph", "o.1.chromSize.txt",
                           "o.1.depth", "o.1.wig"]
    assert out["mid.bam.1.bedGraph"].count(b"c1\t") > 0
    assert PILEUP["sparse_pileup_sweep", "cpu"] - before == \
        (2 if link == "device" else 0)
    out = _run_both(tmp_path / "stdout", monkeypatch, "bam2depth",
                    ["-w", "700", str(bam)], rc=1)
    assert sorted(out) == ["mid.bam.1.bedGraph"]


@pytest.mark.parametrize("region", [None, "chr1:20,001-90,000", "chrX",
                                    "chrZ:1-10"])
def test_bam_sliding_count(tmp_path, monkeypatch, bam, region):
    """bam_sliding_count with and without -r (the BAI-driven decode; an
    unknown name exits 1 on both): the .txt, the region line on stdout and
    the hits PNG written beside the input."""
    png = bam.parent / "t.bam_hits.png"
    pngs = []

    def take_png():
        pngs.append(png.read_bytes() if png.exists() else None)
        png.unlink(missing_ok=True)
        return pngs[-1]

    take_png()
    argv = ["-o", "OUT", "-w", "5000"] + (["-r", region] if region else [])
    rc = 1 if region == "chrZ:1-10" else 0
    out = _run_both(tmp_path, monkeypatch, "bam_sliding_count",
                    [*argv, str(bam)], rc=rc, after=take_png)
    if rc:
        return
    assert sorted(out) == ["o.txt"] and out["o.txt"].count(b"\n") > 1
    assert pngs[-1]


@pytest.mark.parametrize("flags", [[], ["-1"], ["-u"]])
def test_bam_split_chr(tmp_path, monkeypatch, bam, flags):
    """One BAM per reference, each with the full header and that
    reference's records, equal after decompression."""
    out = _run_both(tmp_path, monkeypatch, "bamSplitChr",
                    [*flags, "-o", "OUT", str(bam)])
    assert sorted(out) == [f"o_{n}.bam" for n, _ in sorted(REFS)]
    assert all(len(v) > 1000 for v in out.values())


def test_index(tmp_path, monkeypatch, bam):
    out = _run_both(tmp_path, monkeypatch, "index", [str(bam), "OUT"])
    assert sorted(out) == ["o"] and out["o"][:4] == b"BAI\x01"
    assert out["o"] == (bam.parent / "t.bam.bai").read_bytes()


def test_registered_as_ngstpu_names():
    """The five tools under ngstpu's names; the three without device code
    are called without a device."""
    for name, mod in (("bam2depth", "bam2depth"), ("bam2wig", "bam2wig"),
                      ("bam_sliding_count", "bam_sliding_count"),
                      ("bamSplitChr", "bam_split_chr"),
                      ("index", "bam_index")):
        assert TOOLS[name] == f"ngstpu_torch.tools.{mod}"
    assert {"bam_sliding_count", "bamSplitChr", "index"} <= HOST_ONLY
    assert not {"bam2depth", "bam2wig"} & HOST_ONLY


@pytest.mark.parametrize("tool", ["bam2depth", "bam2wig"])
def test_no_card_no_fallback(tmp_path, monkeypatch, bam, tool):
    """Without --device the CLI asks for cuda and fails where there is no
    card, and the sparse route's sweep never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_cli([tool, "-o", str(tmp_path / "o"), str(bam)])
    monkeypatch.setenv("NGSTPU_PILEUP_MODE", "sparse")
    monkeypatch.setenv("NGSTPU_LINK", "device")
    before = PILEUP.copy()
    with pytest.raises((RuntimeError, AssertionError)):  # no CUDA in torch
        importlib.import_module(TOOLS[tool]).main(
            ["-o", str(tmp_path / "o"), str(bam)])
    assert PILEUP == before
