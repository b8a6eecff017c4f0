"""The plain reference of fastqc against hand-worked tiny inputs."""

from __future__ import annotations

import pytest

from conftest import FOLDER  # noqa: F401  (puts the checkout on the path)

from ngsbench.refs import fastqc as ref


def fastq(path, reads):
    """reads: (name, sequence, qualities) triples."""
    path.write_text("".join(f"{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    return str(path)


def row(text, first):
    """The fields of the line that starts with `first`."""
    for line in text.splitlines():
        f = line.split("\t")
        if f[0] == first:
            return f[1:]
    raise KeyError(first)


def test_one_tile(tmp_path):
    p = fastq(tmp_path / "a.fq", [
        ("@M1:1:FC:1:1101:100:200 1:N:0:1", "ACGTACGTAC", "I" * 10),
        ("@M1:1:FC:1:1101:101:201 1:N:0:1", "ACGTACGTAC", "5" * 10)])
    exp = ref.expected([p])
    tile = exp["_per_tile_mate1.tsv"].splitlines()
    assert tile[0] == "#tile\\cycle\t" + "\t".join(map(str, range(1, 129)))
    assert tile[1:] == ["1101\t" + "\t".join(["0.000"] * 128)]
    q = exp["_quality_mate1.tsv"]
    assert q.splitlines()[0] == "#" + "\t".join(map(str, range(1, 301)))
    assert row(q, str(ord("I"))) == ["1"] * 10 + ["0"] * 290
    assert row(q, str(ord("5"))) == ["1"] * 10 + ["0"] * 290
    assert row(q, "40") == ["0"] * 300
    assert exp["_length_mate1.tsv"] == "10\t2\n"
    nt = exp["_nucleotide_mate1.tsv"]
    assert row(nt, "A")[:10] == ["2", "0", "0", "0"] * 2 + ["2", "0"]
    assert row(nt, "T")[:11] == ["0", "0", "0", "2"] * 2 + ["0", "0", "0"]
    gc = exp["_gc_mate1.tsv"].splitlines()
    assert gc[0] == "#mean_gc\t50.000000" and row("\n".join(gc), "0.50") == \
        ["2"]
    # one read twice: one group of two, over 0.1% of the reads
    assert exp["_duplication.tsv"] == "#unique_reads\t1\t50.000%\n2\t1\n"
    assert exp["_overrepresented.tsv"].splitlines()[1:] == [
        "ACGTACGTAC\t2\t100.0000"]


def test_all_n(tmp_path):
    p = fastq(tmp_path / "n.fq", [(f"@r{i}", "NNNNN", "#####")
                                  for i in range(3)])
    exp = ref.expected([p])
    nt = exp["_nucleotide_mate1.tsv"]
    assert row(nt, "N")[:6] == ["3"] * 5 + ["0"]
    assert all(row(nt, b)[:5] == ["0"] * 5 for b in "TCAG")
    assert exp["_ncontent_mate1.tsv"] == "#cycle\tn_pct\n" + "".join(
        f"{c}\t100.0000\n" for c in range(1, 6))
    assert exp["_kmer_mate1.tsv"] == "#kmer\tcount\tmax_obs_exp\tposition\n"
    assert exp["_gc_mate1.tsv"].splitlines()[:2] == ["#mean_gc\t0.000000",
                                                     "0.00\t3"]
    assert "_per_tile_mate1.tsv" not in exp  # the names carry no tile
    adapter = exp["_adapter_mate1.tsv"].splitlines()
    assert len(adapter) == 129 and all(
        line.split("\t")[1:] == ["0.0000"] * 5 for line in adapter[1:])


def test_planted_adapter(tmp_path):
    p = fastq(tmp_path / "ad.fq", [
        ("@r0", "TTTTT" + "AGATCGGAAGAG" + "TTT", "F" * 20),
        ("@r1", "C" * 20, "F" * 20)])
    lines = ref.expected([p])["_adapter_mate1.tsv"].splitlines()
    assert lines[0].split("\t")[:2] == ["#cycle", "Illumina Universal Adapter"]
    cols = [line.split("\t") for line in lines[1:]]
    assert [c[1] for c in cols[:7]] == ["0.0000"] * 5 + ["50.0000"] * 2
    assert cols[-1][1] == "50.0000" and len(cols) == 128
    assert all(c[2:] == ["0.0000"] * 4 for c in cols)


def test_exact_duplicates_and_key_truncation(tmp_path):
    a = "ACGT" * 25
    a2 = a[:50] + "T" * 50  # the same first 50 bases: the same key
    b = "TGCA" * 25
    p = fastq(tmp_path / "d.fq", [(f"@r{i}", s, "F" * 100)
                                  for i, s in enumerate([a, a, a2, b, a])])
    exp = ref.expected([p])
    assert exp["_duplication.tsv"] == \
        "#unique_reads\t2\t40.000%\n1\t1\n4\t1\n"
    assert exp["_overrepresented.tsv"].splitlines()[1:] == [
        f"{a[:50]}\t4\t80.0000"]


def test_pairs_join_keys(tmp_path):
    r1 = fastq(tmp_path / "1.fq", [("@p0 1", "ACGTAC", "FFFFFF"),
                                   ("@p1 1", "ACGTAC", "FFFFFF"),
                                   ("@p2 1", "ACGTAC", "FFFFFF")])
    r2 = fastq(tmp_path / "2.fq", [("@p0 2", "GGGG", "FFFF"),
                                   ("@p1 2", "CCCC", "FFFF"),
                                   ("@p2 2", "GGGG", "FFFF")])
    exp = ref.expected([r1, r2])
    assert exp["_duplication.tsv"] == \
        "#unique_reads\t2\t66.667%\n1\t1\n2\t1\n"
    assert exp["_overrepresented.tsv"].splitlines()[1:] == [
        "ACGTACGGGG\t2\t66.6667"]
    assert exp["_length_mate2.tsv"] == "4\t3\n"


def test_binned_qualities(tmp_path):
    p = fastq(tmp_path / "q.fq", [("@r0", "ACGT", "#-8F"),
                                  ("@r1", "ACGT", "FFFF")])
    q = ref.expected([p])["_quality_mate1.tsv"]
    assert row(q, "35")[:5] == ["1", "0", "0", "0", "0"]
    assert row(q, "45")[:5] == ["0", "1", "0", "0", "0"]
    assert row(q, "56")[:5] == ["0", "0", "1", "0", "0"]
    assert row(q, "70")[:5] == ["1", "1", "1", "2", "0"]
    assert sum(int(v) for line in q.splitlines()[1:]
               for v in line.split("\t")[1:]) == 8


def test_compare_counts_lines(tmp_path):
    p = fastq(tmp_path / "a.fq", [("@M1:1:FC:1:1101:1:2 1:N:0:1", "ACGTA",
                                   "FFFFF")])
    exp = ref.expected([p])
    prefix = str(tmp_path / "out")
    for suffix, text in exp.items():
        (tmp_path / f"out{suffix}").write_text(text)
    assert set(ref.compare(exp, prefix).values()) == {0}
    lines = exp["_length_mate1.tsv"].splitlines()
    (tmp_path / "out_length_mate1.tsv").write_text("5\t2\n")
    (tmp_path / "out_kmer_mate1.tsv").unlink()
    bad = ref.compare(exp, prefix)
    assert bad["length"] == len(lines) == 1
    assert bad["kmer"] == 1  # the header, the file's one line
    assert sum(bad.values()) == 2


@pytest.mark.parametrize("sample", [2, 3])
def test_control_differs(tmp_path, sample):
    reads = [(f"@M1:1:FC:1:{1101 + i % 3}:1:2 1:N:0:1",
              "ACGT"[i % 4] * 30, "F" * 30) for i in range(12)]
    p = fastq(tmp_path / "c.fq", reads)
    exp, ctl = ref.expected([p]), ref.expected([p], sample=sample)
    for suffix, text in ctl.items():
        (tmp_path / f"ctl{suffix}").write_text(text)
    assert sum(ref.compare(exp, str(tmp_path / "ctl")).values()) > 0


def test_reads_of_several_lengths(tmp_path):
    """Keys of 50 bases for reads over 75, whole reads below: an 80-base
    read and a 50-base one share a key; two 60-base reads another; the
    tie goes to the larger key."""
    s = "ACGT" * 20
    p = fastq(tmp_path / "v.fq", [("@r0", s, "F" * 80),
                                  ("@r1", s[:60], "F" * 60),
                                  ("@r2", s[:60], "#" * 60),
                                  ("@r3", s[:50], "F" * 50)])
    exp = ref.expected([p])
    assert exp["_duplication.tsv"] == "#unique_reads\t2\t50.000%\n2\t2\n"
    assert exp["_overrepresented.tsv"].splitlines()[1:] == [
        f"{s[:60]}\t2\t50.0000", f"{s[:50]}\t2\t50.0000"]
    assert exp["_length_mate1.tsv"] == "50\t1\n60\t2\n80\t1\n"
    nt = exp["_nucleotide_mate1.tsv"]
    # cycles 49, 53, 61 and 81 are A in every read that reaches them
    a = row(nt, "A")
    assert [a[48], a[52], a[60], a[80]] == ["4", "3", "1", "0"]
    assert row(nt, "T")[51] == "3" and row(nt, "T")[79] == "1"


@pytest.mark.parametrize("field,tiles", [(b"+1101", ["1101"]),
                                         (b"11x", None)])
def test_tile_field_read_as_an_integer(tmp_path, field, tiles):
    p = tmp_path / "t.fq"
    p.write_bytes(b"@M1:1:FC:1:" + field + b":5:6 1:N:0:1\nACGT\n+\nFFFF\n")
    exp = ref.expected([str(p)])
    got = exp.get("_per_tile_mate1.tsv")
    assert (got is None) == (tiles is None)
    if tiles:
        assert [line.split("\t")[0] for line in got.splitlines()[1:]] == \
            tiles


def test_gzip_input_reads_as_plain(tmp_path):
    """A .fastq.gz, known by its magic and not its name, gives every file
    the plain copy gives, control included."""
    import gzip
    import json

    from ngsbench.gen import fastq as gen

    cfg = json.loads((FOLDER / "configs" / "novaseq_s4_pe150.json")
                     .read_text())
    plain = [str(tmp_path / f"m{m}.fq") for m in (1, 2)]
    gen.write_set(cfg, 6000, 2 ** 31 + 3, 0, plain)
    gz = []
    for m, p in enumerate(plain, 1):
        gz.append(str(tmp_path / f"m{m}.fastq"))
        gen.bgzf_file(p, gz[-1], 4)
        with gzip.open(gz[-1], "rb") as f:
            open(p, "wb").write(f.read())
    for sample in (1, 2):
        exp = ref.expected(plain, "cpu", sample)
        assert "_per_tile_mate2.tsv" in exp and "_duplication.tsv" in exp
        assert ref.expected(gz, "cpu", sample) == exp
