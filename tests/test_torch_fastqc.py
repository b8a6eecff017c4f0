"""The port's fastqc modules (ngstpu_torch/ops/fastqc.py, device="cpu") and
its fastqc CLI against ngstpu's, with exact equality: every result is an
integer count, and gc_frac is the same float32 division."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngstpu.io.fastq import read_fastq_file
from ngstpu.ops import fastqc as J
from ngstpu.tools.cli import main as jax_cli
from ngstpu_torch.ops import fastqc as T
from ngstpu_torch.ops import sortengine
from ngstpu_torch.testing.fixtures import (illumina_fastq_fast,
                                           illumina_fastq_pair_fast)
from ngstpu_torch.tools.cli import main as torch_cli

AD = np.frombuffer(b"".join(a for _, a in J.ADAPTERS),
                   np.uint8).reshape(len(J.ADAPTERS), -1)
MIXED = np.frombuffer(b"ACGTNacgtn.X\x00", np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(L, seed, B=None):
    """Mixed-alphabet reads with planted adapters, quality bytes >= 128
    and lens past the padded width."""
    rng = np.random.default_rng(seed)
    B = B or (500 if L > 512 else 2500)
    seq = rng.choice(MIXED, (B, L), p=[.2] * 4 + [.02] * 8 + [.04])
    seq = seq.astype(np.uint8)
    for i in range(0, B, 5):
        if L >= AD.shape[1]:
            p = int(rng.integers(0, L - AD.shape[1] + 1))
            seq[i, p:p + AD.shape[1]] = AD[i % len(AD)]
    qual = rng.integers(0, 256, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 9, B).astype(np.int32)
    return seq, qual, lens


@pytest.fixture(params=[1 << 19, 97], ids=["one_chunk", "chunked"])
def rows(request, monkeypatch):
    """The port's row chunk: the default, and one that splits the batch."""
    monkeypatch.setattr(T, "_ROWS", request.param)
    return request.param


LS = [20, 40, 90, 128, 301, 600]


@pytest.mark.parametrize("L", LS)
def test_fastqc_stats(L, rows):
    seq, qual, lens = _batch(L, seed=L)
    n_valid = len(lens) - 7
    before = T.FASTQC["fastqc_stats", "cpu"]
    got = T.fastqc_stats(_t(seq), _t(qual), _t(lens), n_valid)
    assert T.FASTQC["fastqc_stats", "cpu"] == before + 1
    exp = {k: np.asarray(v) for k, v in J.fastqc_stats(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lens),
        jnp.int32(n_valid)).items()}
    assert tuple(got["quality"].shape) == (L, 128)
    for k in ("quality", "ntval", "len_hist", "gc_frac"):
        assert str(got[k].dtype)[6:] == str(exp[k].dtype), k
        assert np.array_equal(got[k].numpy(), exp[k]), k
    if L > 512:  # reads past 512 cycles count in full
        assert (lens[:n_valid] > 512).any() and got["quality"][512:].sum() > 0


@pytest.mark.parametrize("max_len", [0, 1, 300, 511, 512, 600, 700])
def test_fastqc_stats_max_len(max_len):
    """len_hist for any max_len, lengths past it and past 512 included
    (JAX takes any max_len); the quality matrix stays [L, 128]."""
    seq, qual, lens = _batch(600, seed=7)
    lens[::11] = 600  # full-width reads
    n_valid = len(lens) - 4
    got = T.fastqc_stats(_t(seq), _t(qual), _t(lens), n_valid,
                         max_len=max_len)
    exp = J.fastqc_stats(jnp.asarray(seq), jnp.asarray(qual),
                         jnp.asarray(lens), jnp.int32(n_valid),
                         max_len=max_len)
    for k in ("quality", "len_hist"):
        assert np.array_equal(got[k].numpy(), np.asarray(exp[k])), k
    assert tuple(got["len_hist"].shape) == (max_len,)
    if max_len >= 600:
        assert int(got["len_hist"][599]) >= len(lens[:n_valid:11])


@pytest.mark.parametrize("L", [8, 20, 90, 128, 301])
def test_adapter_content(L, rows):
    """Including lens past the padded width (tests/test_fastqc.py:301). A
    width shorter than an adapter is held against ngstpu's host version:
    its device version cannot shift by more than the width."""
    seq, _, lens = _batch(L, seed=100 + L)
    got = T.adapter_content(_t(seq), _t(lens), len(lens) - 3, AD)
    if L < AD.shape[1]:
        exp = J.adapter_content_host(seq, lens, len(lens) - 3, AD)
    else:
        exp = np.asarray(J.adapter_content(
            jnp.asarray(seq), jnp.asarray(lens), jnp.int32(len(lens) - 3),
            jnp.asarray(AD)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), exp)
    if L >= 90:
        assert exp[:, -1].sum() > 0


@pytest.mark.parametrize("L", [40, 128, 600])
def test_per_tile_quality(L, rows):
    _, qual, lens = _batch(L, seed=200 + L)
    rng = np.random.default_rng(L)
    tiles = rng.integers(0, 12, len(lens)).astype(np.int32)
    got = T.per_tile_quality(_t(qual), _t(lens), len(lens) - 5, _t(tiles), 12)
    exp = J.per_tile_quality(jnp.asarray(qual), jnp.asarray(lens),
                             jnp.int32(len(lens) - 5), jnp.asarray(tiles), 12)
    for g, e in zip(got, exp):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("L", [20, 90, 128])
def test_kmer_position_counts(L, rows):
    seq, _, lens = _batch(L, seed=300 + L, B=1200)
    seq[::4, 3:10] = np.frombuffer(b"GATTACA", np.uint8)
    got = T.kmer_position_counts(_t(seq), _t(lens), len(lens) - 2)
    exp = np.asarray(J.kmer_position_counts(
        jnp.asarray(seq), jnp.asarray(lens), jnp.int32(len(lens) - 2)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), exp)
    assert T.kmer_report(exp) == J.kmer_report(exp)


class _Names:
    def __init__(self, names):
        self._names = names
        self.n = len(names)

    def name(self, i):
        return self._names[i]


def _host_case(name):
    """(port result, ngstpu result) of one numpy host helper."""
    seq, qual, lens = _batch(90, seed=7)
    B = len(lens)
    if name == "fastqc_stats_host":
        args = (seq, qual, lens, B - 4)
    elif name == "adapter_content_host":
        args = (seq, lens, B - 4, AD)
    elif name == "per_tile_quality_host":
        args = (qual, lens, B, np.arange(B, dtype=np.int32) % 9, 9)
    elif name == "kmer_position_counts_host":
        args = (seq, lens, B)
    elif name == "truncated_key":
        args = (seq, np.minimum(lens, 90) + 30)
    elif name == "dedup_groups_host_native":
        key, key_lens = J.truncated_key(seq[:, :40], lens % 40)
        key[B // 2:] = key[:B - B // 2]
        key_lens[B // 2:] = key_lens[:B - B // 2]
        args = (key, key_lens)
    elif name == "overrepresented":
        key = np.repeat(seq[:30, :20], np.arange(1, 31), axis=0)
        key_lens = np.full(len(key), 20, np.int32)
        counts, rep = J.dedup_groups_host_native(key, key_lens)
        args = (key, key_lens, counts, rep, len(key), 0.02, 12)
    elif name == "parse_tile_ids":
        names = [b"@M01:2:FC1:1:%d:%d:%d 1:N:0:1" % (1101 + i % 3, i, i)
                 for i in range(40)]
        args = (_Names(names), 3)
    elif name == "kmer_id_to_str":
        args = (0b01001111001100, 7)
    elif name == "kmer_report":
        s = seq.copy()
        s[::3, 5:12] = np.frombuffer(b"GATTACA", np.uint8)
        args = (J.kmer_position_counts_host(s, lens, B), 7, 20, 10, 3.0)
    return getattr(T, name)(*args), getattr(J, name)(*args)


HOST = ["fastqc_stats_host", "adapter_content_host", "per_tile_quality_host",
        "kmer_position_counts_host", "truncated_key",
        "dedup_groups_host_native", "overrepresented", "parse_tile_ids",
        "kmer_id_to_str", "kmer_report"]


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", HOST)
def test_host_copies(name):
    got, exp = _host_case(name)
    assert _equal(got, exp)
    assert got is not None and (not isinstance(got, list) or got)


def test_dedup_host_without_native_library(monkeypatch):
    """The lib-less branch runs the port's own _dedup_host."""
    import ngstpu.io.native as N

    seq, _, lens = _batch(40, seed=9)
    key, key_lens = J.truncated_key(seq, np.minimum(lens, 40))
    key[1000:] = key[:len(key) - 1000]
    key_lens[1000:] = key_lens[:len(key) - 1000]
    native = T.dedup_groups_host_native(key, key_lens)
    monkeypatch.setattr(N, "get_lib", lambda: None)
    for a, b in zip(T.dedup_groups_host_native(key, key_lens), native):
        assert np.array_equal(a, b)


def _inputs(tmp_path, name):
    """Tile-named inputs with planted adapters, N calls, variable lengths
    and hot duplicates."""
    kw = dict(n_tiles=7, dup_frac=0.3, hot=3, n_frac=0.05, adapter_frac=0.05)
    if name == "se":
        data = [illumina_fastq_fast(2400, 100, seed=31, min_len=60, **kw)]
    elif name == "se_600":
        data = [illumina_fastq_fast(300, 600, seed=32, min_len=450, **kw)]
    else:
        data = illumina_fastq_pair_fast(1500, 90, seed=33, min_len=40, **kw)
    paths = []
    for i, d in enumerate(data):
        p = tmp_path / f"{name}_{i + 1}.fq"
        p.write_bytes(d)
        paths.append(str(p))
    return paths


MATE_FILES = ["quality", "nucleotide", "length", "gc", "adapter",
              "ncontent", "per_tile", "kmer"]
MATE_PNGS = ["q20q30", "quality_heatmap", "nucleotide", "gc_density",
             "boxplotquality", "length", "adapter"]


@pytest.mark.parametrize("placement", ["device", "host"])
@pytest.mark.parametrize("name", ["se", "pe", "se_600"])
def test_fastqc_cli(tmp_path, monkeypatch, name, placement):
    paths = _inputs(tmp_path, name)
    monkeypatch.setenv("NGSTPU_LINK", placement)
    before = dict(T.FASTQC)
    sorts = sortengine.SORTS["cpu"]
    files = {}
    for side, cli, pre in (("jax", jax_cli, []),
                           ("torch", torch_cli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        assert cli([*pre, "fastqc", str(d / "qc"), *paths]) == 0
        files[side] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    mates = len(paths)
    want = {f"qc_{m}_mate{i}.{ext}" for i in range(1, mates + 1)
            for ms, ext in ((MATE_FILES, "tsv"), (MATE_PNGS, "png"))
            for m in ms}
    want |= {"qc_duplication.tsv", "qc_duplication.png",
             "qc_overrepresented.tsv"}
    assert set(files["torch"]) == want
    assert files["torch"].keys() == files["jax"].keys()
    for f, data in files["torch"].items():
        assert data == files["jax"][f], f
    # hot duplicates and planted adapters show in the report
    assert len(files["torch"]["qc_overrepresented.tsv"].splitlines()) > 1
    ran = {op: T.FASTQC[op, "cpu"] - before.get((op, "cpu"), 0) for op in
           ("fastqc_stats", "adapter_content", "per_tile_quality",
            "kmer_position_counts")}
    assert ran == {op: mates if placement == "device" else 0 for op in ran}
    assert (sortengine.SORTS["cpu"] > sorts) == (placement == "device")


def test_cli_quality_matrix_at_100_cycles(tmp_path):
    """fastqc_stats' [L, 128] quality matrix leaves the tool's chart width
    at the batch's padded width."""
    p = tmp_path / "r.fq"
    p.write_bytes(illumina_fastq_fast(300, 100, seed=5, n_tiles=3))
    b = read_fastq_file(str(p))
    st = T.fastqc_stats(_t(b.seq), _t(b.qual), _t(b.lens), b.n)
    assert st["quality"].shape[0] == b.seq.shape[1] == 128
    assert int(st["quality"][100:].sum()) == 0
    assert int(st["len_hist"][99]) == 300


@pytest.mark.parametrize("kw", [dict(), dict(dup_frac=0.3)])
def test_pair_fixture_renames_the_pair_draws(kw):
    """With nothing planted, the PE twin is random_fastq_pair_fast's reads
    under Illumina names whose tiles parse, ordered by tile."""
    from ngstpu_torch.testing.fixtures import random_fastq_pair_fast

    plain = random_fastq_pair_fast(500, 30, seed=4, **kw)
    named = illumina_fastq_pair_fast(500, 30, seed=4, n_tiles=96, **kw)
    for a, b, mate in zip(plain, named, (1, 2)):
        la, lb = a.split(b"\n"), b.split(b"\n")
        assert la[1::4] == lb[1::4] and la[3::4] == lb[3::4]
        assert all(n.endswith(b" %d:N:0:1" % mate) for n in lb[0::4][:-1])
        tiles = [int(n.split(b":")[4]) for n in lb[0::4][:-1]]
        assert len(set(tiles)) == 96 and tiles[0] == 1101
    heads = [[n.split(b" ")[0] for n in d.split(b"\n")[0::4]] for d in named]
    assert heads[0] == heads[1]
