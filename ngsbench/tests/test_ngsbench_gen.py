"""The inputs: the same seed gives the same bytes, a file holds what its
configuration states (unique share, tiles, quality values), and a gzip
mix's files hold the plain mix's bytes."""

from __future__ import annotations

import collections
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

from conftest import FOLDER

from ngsbench.gen import fastq as gen

CONFIGS = ("hpngs_pe100", "novaseq_s4_pe150")


def config(name):
    return json.loads((FOLDER / "configs" / f"{name}.json").read_text())


def write(cfg, n, seed, d, index=0):
    mates = 2 if cfg["layout"] == "PE" else 1
    paths = [d / f"s{index}_m{m}.fq" for m in range(mates)]
    gen.write_set(cfg, n, seed, index, paths)
    return [p.read_bytes() for p in paths]


def records(data: bytes):
    lines = data.split(b"\n")[:-1]
    return lines[0::4], lines[1::4], lines[3::4]


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_bytes(name, tmp_path):
    cfg = config(name)
    for seed in (0, 2 ** 31 + 7, 5_000_000_011, -3):
        (tmp_path / "a").mkdir(exist_ok=True)
        (tmp_path / "b").mkdir(exist_ok=True)
        a = write(cfg, 2000, seed, tmp_path / "a")
        assert a == write(cfg, 2000, seed, tmp_path / "b")
    assert a != write(cfg, 2000, 1, tmp_path / "b")
    assert a != write(cfg, 2000, -3, tmp_path / "b", index=1)


@pytest.mark.parametrize("name", CONFIGS)
def test_files_match_config(name, tmp_path):
    cfg = config(name)
    n = 40000
    mates = [records(m) for m in write(cfg, n, 2 ** 31 + 1, tmp_path)]
    assert all(len(names) == n for names, _, _ in mates)
    assert all(len(s) == cfg["read_len"] for _, seqs, _ in mates
               for s in seqs)
    # the distinct reads (pairs), planting included, are 1 - dup_frac of
    # the rows, and the hot sequences
    keys = list(zip(*(seqs for _, seqs, _ in mates)))
    assert len(set(keys)) == n - round(cfg["dup_frac"] * n) + cfg["hot"]
    hot = sorted(collections.Counter(keys).values())[-cfg["hot"]:]
    assert all(abs(h / n - gen.HOT_SHARE) < 0.001 for h in hot)
    fc = cfg["names"]["flowcell"]
    tiles = {name.split(b":")[4] for name in mates[0][0]}
    assert len(tiles) == fc["surfaces"] * fc["swaths"] * fc["tiles_per_swath"]
    assert all(b" %d:N:0:1" % (m + 1) in mates[m][0][0]
               for m in range(len(mates)))
    if len(mates) == 2:  # mates named alike but for the mate number
        assert [a.split(b" ")[0] for a in mates[0][0]] == \
            [b.split(b" ")[0] for b in mates[1][0]]
    q = np.frombuffer(b"".join(mates[0][2]), np.uint8)
    counts = np.bincount(q, minlength=256)
    model = cfg["quality"]
    if model["kind"] == "binned":
        values = np.frombuffer(model["values"].encode(), np.uint8)
        assert set(np.flatnonzero(counts)) == set(values)
        share = counts[values] / counts.sum()
        assert np.abs(share - model["shares"]).max() < 0.005
    else:
        assert set(np.flatnonzero(counts)) == set(range(model["lo"],
                                                        model["hi"] + 1))
    seq = np.frombuffer(b"".join(mates[0][1]), np.uint8)
    n_share = (seq == ord("N")).sum() / n
    assert abs(n_share - cfg["n_frac"]) < 0.003


def inputs(tiny, workload, seed, d):
    """make_inputs of a tiny fixture cell under `d`."""
    from ngsbench import core

    root, _ = tiny
    d.mkdir()
    return core.make_inputs(core.Layout(root, root / "ngsbench").cell(
        workload), seed, d)


def test_mix_without_gzip_level_writes_todays_files(tiny, tmp_path):
    """Plain mixes (the plain cells' inputs): the same paths and bytes as
    write_set gives, synced, and no file but the mates."""
    seed = 2 ** 31 + 5
    sets = inputs(tiny, "tiny_pe", seed, tmp_path / "w")
    cfg = config("novaseq_s4_pe150")
    for j, s in enumerate(sets):
        assert s["paths"] == [str(tmp_path / "w" / "in" / f"s{j}_m{m}.fq")
                              for m in (1, 2)]
        assert s["files"] == [dict(reads=3000, bases=3000 * 150)] * 2
        (tmp_path / f"ref{j}").mkdir()
        want = write(cfg, 3000, seed, tmp_path / f"ref{j}", index=j)
        assert [open(p, "rb").read() for p in s["paths"]] == want
    assert len(list((tmp_path / "w" / "in").iterdir())) == 4


def bgzf_members(data: bytes):
    """(header, deflate body, CRC, ISIZE) of each member of a BGZF file,
    walked by the BSIZE of its BC extra field."""
    out, at = [], 0
    while at < len(data):
        head = data[at:at + 18]
        bsize = int.from_bytes(head[16:18], "little") + 1
        body = data[at + 18:at + bsize - 8]
        crc, isize = (int.from_bytes(data[at + bsize - k:at + bsize - k + 4],
                                     "little") for k in (8, 4))
        out.append((head, body, crc, isize))
        at += bsize
    assert at == len(data)
    return out


def test_gzip_mix_writes_the_plain_bytes_as_bgzf(tiny, tmp_path):
    """A gzip_level mix: each mate as BGZF (members of at most 64 KiB,
    each with its BC extra field, mtime 0 and no name, 0xff00 input bytes
    but the last, then the format's EOF member) that decompresses to
    exactly the plain mix's bytes; the plain files are gone; the same seed
    gives the same .gz bytes twice."""
    seed = 5_000_000_029
    plain = inputs(tiny, "tiny_pe", seed, tmp_path / "plain")
    gz = inputs(tiny, "tiny_pe_gz", seed, tmp_path / "gz")
    again = inputs(tiny, "tiny_pe_gz", seed, tmp_path / "again")
    assert sorted(p.name for p in (tmp_path / "gz" / "in").iterdir()) == [
        f"s{j}_m{m}.fq.gz" for j in (0, 1) for m in (1, 2)]
    for sp, sg, sa in zip(plain, gz, again):
        assert sg["paths"] == [str(tmp_path / "gz" / "in" / Path(p).name)
                               + ".gz" for p in sp["paths"]]
        assert sg["reads"] == sp["reads"]
        for p, g, a, f in zip(sp["paths"], sg["paths"], sa["paths"],
                              sg["files"]):
            data = open(g, "rb").read()
            assert data == open(a, "rb").read()
            assert f["compressed_bytes"] == len(data)
            want = open(p, "rb").read()
            members = bgzf_members(data)
            assert len(members) == -(-len(want) // gen.BGZF_BLOCK) + 1
            assert data.endswith(gen.BGZF_EOF)
            got = b""
            for k, (head, body, crc, isize) in enumerate(members[:-1]):
                # magic, deflate, FEXTRA alone, mtime 0, XLEN 6, "BC", 2
                assert head[:16] == bytes.fromhex(
                    "1f8b08040000000000ff060042430200")
                assert len(head) + len(body) + 8 <= 1 << 16
                block = zlib.decompress(body, -15)
                assert len(block) == isize == (
                    gen.BGZF_BLOCK if k < len(members) - 2 else
                    len(want) - k * gen.BGZF_BLOCK)
                assert zlib.crc32(block) == crc
                got += block
            assert got == want
            assert zlib.decompressobj(31).decompress(data) == \
                want[:gen.BGZF_BLOCK]
