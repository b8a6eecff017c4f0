"""The port's pipeline (device="cpu") against ngstpu's: the four output
files byte-equal, and the same reads:/unique: lines on stderr."""

import functools

import pytest

from ngstpu.io import fastq
from ngstpu.testing.fixtures import gz, random_fastq
from ngstpu.tools import pipeline as jax_pipeline
from ngstpu_torch.tools import pipeline

OUTPUTS = (".count.tsv", ".trim.fastq", "_uniq.fq", "_sortKeyUniq.fq")


def _counts_lines(err: str) -> list[str]:
    return [ln for ln in err.splitlines()
            if ": reads: " in ln or ln.startswith("unique: ")]


def _run_both(tmp_path, capsys, argv_in, prefixes=("o",)):
    """Run both CLIs' main with outputs under tmp_path/{jax,torch}."""
    err = {}
    for name, main, kw in (("jax", jax_pipeline.main, {}),
                           ("torch", pipeline.main, dict(device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        assert main([*argv_in, "-o", str(d / "o")], **kw) == 0
        err[name] = _counts_lines(capsys.readouterr().err)
    assert err["jax"] == err["torch"] and err["jax"]
    for prefix in prefixes:
        for suffix in OUTPUTS:
            a = (tmp_path / "jax" / f"{prefix}{suffix}").read_bytes()
            b = (tmp_path / "torch" / f"{prefix}{suffix}").read_bytes()
            assert a == b, f"{prefix}{suffix} differs"
            assert a or suffix != ".count.tsv"
    return err["torch"]


@pytest.mark.parametrize("link", ["device", "host"])
def test_fast_path_acgt(tmp_path, monkeypatch, capsys, link):
    monkeypatch.setenv("NGSTPU_LINK", link)
    p = tmp_path / "in.fq"
    p.write_bytes(random_fastq(600, read_len=100, seed=90, dup_frac=0.4))
    _run_both(tmp_path, capsys, ["-i", str(p), "-s", "0", "-e", "50"])


def test_fast_path_gzip_var_len(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("NGSTPU_LINK", "device")
    p = tmp_path / "in.fq.gz"
    p.write_bytes(gz(random_fastq(500, read_len=80, seed=91, var_len=True,
                                  dup_frac=0.4)))
    _run_both(tmp_path, capsys, ["-i", str(p), "-s", "3", "-e", "60"])


@pytest.mark.parametrize("qc", ["device", "host"])
def test_generic_path_with_n(tmp_path, monkeypatch, capsys, qc):
    monkeypatch.setenv("NGSTPU_QC", qc)
    p = tmp_path / "in.fq"
    p.write_bytes(random_fastq(700, read_len=100, seed=92, with_n=True,
                               var_len=True, dup_frac=0.4))
    _run_both(tmp_path, capsys, ["-i", str(p), "-e", "40"])


def test_generic_path_mixed_alphabet(tmp_path, monkeypatch, capsys):
    """A later chunk widens the alphabet: one consistent repack."""
    monkeypatch.setenv("NGSTPU_QC", "device")
    monkeypatch.setenv("NGSTPU_NO_FASTPATH", "1")
    monkeypatch.setattr(fastq, "FastqChunkReader",
                        functools.partial(fastq.FastqChunkReader,
                                          chunk_bytes=16 << 10))
    p = tmp_path / "in.fq"
    p.write_bytes(random_fastq(300, read_len=60, seed=93, dup_frac=0.3)
                  + random_fastq(300, read_len=60, seed=94, with_n=True,
                                 name_prefix="late", dup_frac=0.3))
    _run_both(tmp_path, capsys, ["-i", str(p)])


def test_two_lanes(tmp_path, monkeypatch, capsys):
    """Multi-lane mode (tests/test_pipeline.py:31-48): per-lane prefixes,
    pooled staging buffers reused by the second lane."""
    monkeypatch.setenv("NGSTPU_LINK", "device")
    p1, p2 = tmp_path / "l1.fq", tmp_path / "l2.fq"
    p1.write_bytes(random_fastq(300, read_len=50, seed=61, dup_frac=0.4))
    p2.write_bytes(random_fastq(200, read_len=50, seed=62, dup_frac=0.4))
    err = _run_both(tmp_path, capsys,
                    ["-i", str(p1), "-i", str(p2), "-e", "30"],
                    prefixes=("o.1", "o.2"))
    assert len(err) == 4
