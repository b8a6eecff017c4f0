"""The inputs: the same seed gives the same bytes, and a file holds what
its configuration states (unique share, tiles, quality values)."""

from __future__ import annotations

import collections
import json

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
