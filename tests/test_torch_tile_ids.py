"""The port's tile-number parse (ngstpu_torch/ops/fastqc.py:parse_tile_ids)
on real batches from read_fastq_file: its native pass over the name blob
gives exactly what the per-name loop gives, values and types; every name
the native pass does not read falls back to the loop, with the loop's
answer; and the tile_rows_native / tile_rows_loop counters count the rows
each path was handed."""

import numpy as np
import pytest

from ngstpu.io.fastq import read_fastq_file as jax_read_fastq_file
from ngstpu.ops import fastqc as J
from ngstpu_torch.io import native as N
from ngstpu_torch.io.fastq import read_fastq_file
from ngstpu_torch.ops import fastqc as T
from ngstpu_torch.utils.timing import COUNTS


def _fastq(names) -> bytes:
    return b"".join(b"%s\nACGT\n+\nIIII\n" % n for n in names)


def _hiseq(i):  # hpngs_pe100's names
    return b"@HWI-D00360:112:C6RV2ANXX:1:%d:%d:%d 1:N:0:1" % (
        1101 + 100 * (i % 3) + i % 16, 1000 + 37 * i, 20000 + i)


def _novaseq(i):  # novaseq_s4_pe150's names
    return b"@A00123:8:HFWCKDSXX:1:%d:%05d:%05d 2:N:0:1" % (
        1101 + 1000 * (i % 2) + 100 * (i % 4) + i % 88, 10000 + i,
        37000 - i)


def _casava17(i):  # CASAVA < 1.8: 5 fields, the tile is field 3
    return b"@HWUSI-EAS100R:6:%d:941:%d#0/1" % (1 + i % 120, 1973 + i)


def _six_fields(i):  # 6 fields: the tile is field 3 too
    return b"@HWUSI:EAS100R:6:%d:941:%d#0/1" % (7 + i % 5, 1973 + i)


def _tab(i):  # a tab before the comment, and one with a space in it
    return b"@M01:2:FC1:1:%d:%d:%d\tBC:Z:ACGT 1:N" % (1101 + i % 7, i, i)


def _short_head(i):
    """A 5-field head, then a space or a tab and a comment with colons:
    only the stop makes the head's field 3 the tile."""
    j = (i + i // 10) % 2  # both stops at step 1 and at step 10
    sep = b" \t"[j:j + 1]
    return b"@HWUSI-EAS100R:6:%d:941:%d#0/1%sBC:Z:AC:GT:1:2" % (
        1 + i % 50, 1973 + i, sep)


def _bare(i):  # no comment at all
    return b"@M01:2:FC1:1:%d:%d:%d" % (2101 + i % 9, i, 5 * i)


def _mixed(i):
    """Names of mixed lengths, from 5 fields to heads of over 150 bytes,
    with the colons, the tile or the space far into the name."""
    pad = b"X" * (i % 150)
    return [_hiseq(i), _casava17(i), _tab(i), _bare(i),
            b"@" + pad + b":2:FC:1:%d:3:4 1:N:0:1" % (1102 + i % 5),
            b"@I:2:FC:1:%d:3:4" % (1103 + i % 4) + pad + b" c:o:m:m:e:n:t",
            b"@I:2:FC:1:%d:3:4" % (1104 + i % 3) + pad,
            b"@I:2:%s:1:%d:3:4:5:6 x" % (pad, 1105 + i % 2)][i % 8]


STYLES = {"hiseq": _hiseq, "novaseq": _novaseq, "casava17": _casava17,
          "six_fields": _six_fields, "tab": _tab, "bare": _bare,
          "short_head": _short_head, "mixed": _mixed}


def _batch(tmp_path, names):
    p = tmp_path / "r.fq"
    p.write_bytes(_fastq(names))
    return read_fastq_file(str(p))


def _same(got, exp):
    """parse_tile_ids' results equal, types included."""
    if exp is None:
        return got is None
    rows, ords, uniq = got
    return (type(got) is type(exp) and len(got) == 3
            and rows.dtype == exp[0].dtype == np.int64
            and ords.dtype == exp[1].dtype == np.int32
            and np.array_equal(rows, exp[0]) and np.array_equal(ords, exp[1])
            and type(uniq) is list and uniq == exp[2]
            and all(type(t) is int for t in uniq))


def _counted(fn):
    """fn()'s result and the change of both counters over it."""
    before = (COUNTS["tile_rows_native"], COUNTS["tile_rows_loop"])
    out = fn()
    return out, (COUNTS["tile_rows_native"] - before[0],
                 COUNTS["tile_rows_loop"] - before[1])


@pytest.mark.parametrize("step", [1, 10])
@pytest.mark.parametrize("n", [1, 437])
@pytest.mark.parametrize("style", sorted(STYLES))
def test_native_equals_loop(tmp_path, style, n, step):
    b = _batch(tmp_path, [STYLES[style](i) for i in range(n)])
    assert b.n == n
    got, counted = _counted(lambda: T.parse_tile_ids(b, step=step))
    sampled = len(range(0, n, step))
    assert counted == (sampled, 0)
    exp = T._parse_tile_ids_loop(b, step)
    assert exp is not None and _same(got, exp)


@pytest.mark.parametrize("step", [1, 10])
def test_empty_batch(tmp_path, step):
    b = _batch(tmp_path, [])
    assert b.n == 0
    got, counted = _counted(lambda: T.parse_tile_ids(b, step=step))
    assert got is None and T._parse_tile_ids_loop(b, step) is None
    assert counted == (0, 0)


@pytest.mark.parametrize("style", ["hiseq", "novaseq", "mixed"])
def test_native_equals_jax_package(tmp_path, style):
    """The native path against the JAX package's loop on its own batch."""
    names = [STYLES[style](i) for i in range(999)]
    b = _batch(tmp_path, names)
    got, counted = _counted(lambda: T.parse_tile_ids(b, step=10))
    assert counted == (100, 0)
    assert _same(got, J.parse_tile_ids(
        jax_read_fastq_file(str(tmp_path / "r.fq")), step=10))


# (a name at row 5 of 40 _hiseq names, whether the loop still finds tiles)
FALLBACK = {
    "non_digit": (b"@I:2:FC:1:11a1:3:4 1:N", False),
    "plus": (b"@I:2:FC:1:+12:3:4 1:N", True),
    "minus": (b"@I:2:FC:1:-12:3:4 1:N", True),
    "underscore": (b"@I:2:FC:1:1_2:3:4 1:N", True),
    "vertical_tab": (b"@I:2:FC:1:\x0b12:3:4 1:N", True),
    "nineteen_digits": (b"@I:2:FC:1:%d:3:4 1:N" % (10 ** 18 + 7), True),
    "empty_field": (b"@I:2:FC:1::3:4 1:N", False),
    "four_fields": (b"@I:2:FC:1101 1:N:0:1:2:3", False),
    "no_colon": (b"@read_5 1:N:0:1:2:3", False),
}


@pytest.mark.parametrize("case", sorted(FALLBACK))
def test_fallback_gives_the_loops_answer(tmp_path, case):
    name, has_tiles = FALLBACK[case]
    names = [_hiseq(i) for i in range(40)]
    names[5] = name
    b = _batch(tmp_path, names)
    got, counted = _counted(lambda: T.parse_tile_ids(b, step=1))
    assert counted == (0, 40)
    exp = T._parse_tile_ids_loop(b, 1)
    assert (exp is not None) == has_tiles
    assert _same(got, exp)
    # the same name off the sampled rows leaves the native pass in charge
    got, counted = _counted(lambda: T.parse_tile_ids(b, step=10))
    assert counted == (4, 0)
    assert _same(got, T._parse_tile_ids_loop(b, 10))


def test_over_2048_tiles(tmp_path):
    """2049 distinct tiles are not plausibly tiles: None on both paths."""
    names = [b"@I:2:FC:1:%d:3:4 1:N" % (1000 + i) for i in range(2049)]
    b = _batch(tmp_path, names)
    got, counted = _counted(lambda: T.parse_tile_ids(b, step=1))
    assert counted == (2049, 0)
    assert got is None and T._parse_tile_ids_loop(b, 1) is None
    got = T.parse_tile_ids(b.take(np.arange(2048)), step=1)
    assert _same(got, T._parse_tile_ids_loop(b.take(np.arange(2048)), 1))
    assert len(got[2]) == 2048


def test_no_native_takes_the_loop(tmp_path, monkeypatch):
    """NGSTPU_NO_NATIVE=1: no library, the loop, the same answer."""
    names = [_novaseq(i) for i in range(300)]
    b = _batch(tmp_path, names)
    native, _ = _counted(lambda: T.parse_tile_ids(b, step=10))
    monkeypatch.setenv("NGSTPU_NO_NATIVE", "1")
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_tried", False)
    assert N.get_lib() is None
    got, counted = _counted(lambda: T.parse_tile_ids(b, step=10))
    assert counted == (0, 30)
    assert _same(got, native) and _same(got, T._parse_tile_ids_loop(b, 10))


def test_no_name_blob_takes_the_loop():
    """A batch with no name blob (names through .name(i) alone)."""
    class Names:
        n = 30

        def name(self, i):
            return _hiseq(i)

    got, counted = _counted(lambda: T.parse_tile_ids(Names(), step=3))
    assert counted == (0, 10)
    assert _same(got, T._parse_tile_ids_loop(Names(), 3))
    assert got is not None


def test_last_name_at_the_blob_end():
    """The native pass reads each name only within its length: the last
    name ends the blob, at the end of its own allocation, and names cut
    short to 3 fields are read as cut."""
    names = [_bare(i) for i in range(5)]
    blob = np.frombuffer(b"".join(names), np.uint8).copy()
    lens = np.array([len(n) for n in names], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    tiles = N.tile_ids(blob, starts, lens, np.arange(5, dtype=np.int64))
    assert tiles.tolist() == [2101 + i % 9 for i in range(5)]
    cut = np.minimum(lens, 10)  # "@M01:2:FC1": 3 fields
    assert N.tile_ids(blob, starts, cut, np.arange(5, dtype=np.int64)) is None
