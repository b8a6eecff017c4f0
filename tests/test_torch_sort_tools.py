"""The port's sort-engine tools (device="cpu") against ngstpu's CLI: every
output file byte-equal (gzip outputs decompressed) and the same stderr
lines apart from timings, on the fast route with the sort placed on the
device or the host, and on the generic route."""

import gzip
import re

import pytest

from ngstpu.testing.fixtures import gz, random_fastq, random_fastq_pair
from ngstpu.tools.cli import main as jax_cli
from ngstpu_torch.ops import sortengine
from ngstpu_torch.tools.cli import main as torch_cli

ROUTES = {"device": {"NGSTPU_LINK": "device"},
          "host": {"NGSTPU_LINK": "host"},
          "generic": {"NGSTPU_LINK": "device", "NGSTPU_NO_FASTPATH": "1"}}
_TIMING = re.compile(r" at \d+\.\d{3} s$")


def _dup_records(data: bytes, k: int) -> bytes:
    """`data` with its first k records appended again (pair duplicates
    when applied to both mates)."""
    lines = data.split(b"\n")[:-1]
    return b"\n".join(lines + lines[:4 * k]) + b"\n"


def _inputs(tmp_path, name):
    """Input files for fixture `name`; PE gives two mates."""
    if name == "fixed":
        data = [random_fastq(400, 60, seed=11, dup_frac=0.4)]
    elif name == "varlen_gz":
        data = [gz(random_fastq(400, 80, seed=12, var_len=True,
                                dup_frac=0.4, with_comment=True))]
    elif name == "with_n":
        data = [random_fastq(400, 70, seed=13, var_len=True, with_n=True,
                             dup_frac=0.4)]
    elif name == "pe":
        r1, r2 = random_fastq_pair(300, 50, seed=14)
        data = [_dup_records(r1, 90), _dup_records(r2, 90)]
    elif name == "pe_varlen":
        r1, r2 = random_fastq_pair(300, 50, seed=15, var_len=True,
                                   min_len=20)
        data = [_dup_records(r1, 90), _dup_records(r2, 90)]
    paths = []
    for i, d in enumerate(data):
        p = tmp_path / f"{name}_{i + 1}.fq{'.gz' if name.endswith('gz') else ''}"
        p.write_bytes(d)
        paths.append(str(p))
    return paths


def _run_both(tmp_path, capsys, monkeypatch, route, tool, argv, outputs):
    """Run `tool` through both CLIs with OUT -> tmp_path/{jax,torch}/o;
    assert equal outputs and stderr. Returns the port's stderr lines."""
    for k in ("NGSTPU_LINK", "NGSTPU_NO_FASTPATH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    err, out = {}, {}
    for side, cli, pre in (("jax", jax_cli, []),
                           ("torch", torch_cli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        args = [str(d / "o") if a == "OUT" else a for a in argv]
        assert cli([*pre, tool, *args]) == 0
        err[side] = [ln for ln in capsys.readouterr().err.splitlines()
                     if not _TIMING.search(ln)]
        out[side] = {}
        for suffix in outputs:
            data = (d / f"o{suffix}").read_bytes()
            out[side][suffix] = (gzip.decompress(data)
                                 if suffix.endswith(".gz") else data)
    assert err["jax"] == err["torch"]
    for suffix in outputs:
        assert out["jax"][suffix] == out["torch"][suffix], suffix
        assert out["torch"][suffix]
    return err["torch"]


# ngstpu's device route sorts 256K-row padded partitions on the CPU, the
# slow case here: variable-length pairs take the other two routes only
UNIQ_CASES = [(name, route) for name in ("fixed", "varlen_gz", "with_n",
                                         "pe", "pe_varlen")
              for route in ROUTES if (name, route) != ("pe_varlen", "device")]


@pytest.mark.parametrize("name,route", UNIQ_CASES)
def test_gzfastq_uniq(tmp_path, capsys, monkeypatch, name, route):
    paths = _inputs(tmp_path, name)
    if len(paths) == 2:
        argv = ["-1", paths[0], "-2", paths[1], "-o", "OUT"]
        outputs = ("_1_uniq.fq", "_2_uniq.fq")
    else:
        argv = ["-1", paths[0], "-o", "OUT"]
        outputs = ("_uniq.fq", "_sortKeyUniq.fq")
    sorts = sortengine.SORTS["cpu"]
    err = _run_both(tmp_path, capsys, monkeypatch, route, "gzfastq_uniq",
                    argv, outputs)
    assert any(ln.startswith("unique reads number = ") for ln in err)
    # the device placement sorts with torch; the host one natively
    assert (sortengine.SORTS["cpu"] > sorts) == (
        route != "host" or name == "with_n")


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("flag,suffix", [("-s", "_sort_by_seq.fq"),
                                         ("-n", "_sort_by_name.fq")])
@pytest.mark.parametrize("name", ["fixed", "with_n"])
def test_gzfastq_sort(tmp_path, capsys, monkeypatch, route, flag, suffix,
                      name):
    """'host' on the fixed-length input is the streamed const-length
    sort; on the variable-length input the native permutation."""
    paths = _inputs(tmp_path, name)
    packs = sortengine.PACKS["bytes_to_words", "cpu"]
    _run_both(tmp_path, capsys, monkeypatch, route, "gzfastq_sort",
              ["-i", paths[0], flag, "-o", "OUT"], (suffix,))
    # names sort as raw bytes, packed on the device on the generic route
    assert (sortengine.PACKS["bytes_to_words", "cpu"] > packs) == (
        route == "generic" and flag == "-n")


def test_gzfastq_sort_list(tmp_path, capsys, monkeypatch):
    paths = _inputs(tmp_path, "with_n")
    _run_both(tmp_path, capsys, monkeypatch, "device", "gzfastq_sort_list",
              ["-i", paths[0], "-o", "OUT"], ("_sort_by_seq.fq",))


@pytest.mark.parametrize("order", ["-S", "-C"])
@pytest.mark.parametrize("name", ["fixed", "with_n"])
def test_gzfastq_uniqQ(tmp_path, capsys, monkeypatch, order, name):
    paths = _inputs(tmp_path, name)
    _run_both(tmp_path, capsys, monkeypatch, "device", "gzfastq_uniqQ",
              ["-1", paths[0], order, "-o", "OUT"], ("_sortKeyUniq.fq",))


@pytest.mark.parametrize("name", ["fixed", "with_n", "pe"])
def test_gzfastq_uniq_sort(tmp_path, capsys, monkeypatch, name):
    paths = _inputs(tmp_path, name)
    argv, outputs = ["-1", paths[0], "-o", "OUT"], ("_1_uniq.fq.gz",)
    if len(paths) == 2:
        argv += ["-2", paths[1]]
        outputs += ("_2_uniq.fq.gz",)
    _run_both(tmp_path, capsys, monkeypatch, "device", "gzfastq_uniq_sort",
              argv, outputs)


@pytest.mark.parametrize("top", [[], ["-r", "20"]])
def test_ordered_uniq(tmp_path, capsys, monkeypatch, top):
    from ngstpu_torch.tools.ordered_uniq import rank_of

    paths = _inputs(tmp_path, "with_n")
    _run_both(tmp_path, capsys, monkeypatch, "device", "ordered_uniq",
              ["-i", paths[0], *top, "-o", "OUT"], ("",))
    lines = (tmp_path / "torch" / "o").read_bytes().splitlines()
    seqs = [lines[i + 1] for i in range(0, len(lines), 4)]
    assert len(seqs) == (20 if top else len(set(seqs)))
    assert rank_of(seqs, seqs[3]) == 4 and rank_of(seqs, b"ZZZZ") == 0


@pytest.mark.parametrize("tool,argv,outputs", [
    ("gzfastq_uniq", ["-1", "IN", "-m", "4", "-o", "OUT"],
     ("_uniq.fq", "_sortKeyUniq.fq")),
    ("gzfastq_sort", ["-i", "IN", "-n", "-m", "4", "-o", "OUT"],
     ("_sort_by_name.fq",)),
])
def test_mesh_on_one_device(tmp_path, capsys, monkeypatch, tool, argv,
                            outputs):
    """-m 4 on the CPU counts one device: ngstpu's single-device path,
    which skips the fast route (ngstpu's own -m 4 shards over the test
    session's 8 virtual devices and is bit-identical to it)."""
    paths = _inputs(tmp_path, "varlen_gz")
    argv = [paths[0] if a == "IN" else a for a in argv]
    _run_both(tmp_path, capsys, monkeypatch, "device", tool, argv, outputs)


@pytest.mark.parametrize("n,dup", [(0, 0.0), (1234, 0.3), (10001, 0.5)])
def test_fastq_fixtures(n, dup):
    """The smoke test's inputs: random_fastq_fast byte-equal to ngstpu's,
    and pairs whose duplicates repeat both mates."""
    from ngstpu.testing import fixtures as jf
    from ngstpu_torch.testing import fixtures as tf

    assert tf.random_fastq_fast(n, 37, seed=5, dup_frac=dup) == \
        jf.random_fastq_fast(n, 37, seed=5, dup_frac=dup)
    mates = [d.split(b"\n")[1::4] for d in
             tf.random_fastq_pair_fast(n, 30, seed=6, dup_frac=dup)]
    assert len(mates[0]) == len(mates[1]) == n
    pairs = set(zip(*mates))
    assert len(set(mates[0])) == len(pairs) == len(set(mates[1]))
    assert (len(pairs) < n) == (dup > 0)
