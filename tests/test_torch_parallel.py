"""The port's parallel layer (ngstpu_torch/parallel, ops/qcstep.py,
ops/pileup.py, testing/pileup_profile.py) against the JAX package on the
CPU, exactly: JAX runs over make_mesh(n) on conftest's virtual CPU
devices, the port over make_mesh(n, devices=[cpu] * n), on the same numpy
inputs made from a seed."""

import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ngstpu.ops.pileup import depth_deltas as jax_depth_deltas
from ngstpu.ops.qcstep import qc_step as jax_qc_step
from ngstpu.parallel import dist as jdist
from ngstpu.parallel import dsort as jdsort
from ngstpu.parallel import mesh as jmesh
from ngstpu.parallel import multihost as jmulti
from ngstpu_torch.ops import sortengine
from ngstpu_torch.ops.pileup import depth_deltas
from ngstpu_torch.ops.qcstep import qc_step
from ngstpu_torch.parallel import (collectives, dist, dryrun, dsort, mesh,
                                   multihost, scalebench)

CPU = torch.device("cpu")
NS = [2, 4, 8]
REPO = pathlib.Path(__file__).resolve().parent.parent


def cpu_mesh(n, coord=None):
    return mesh.make_mesh(n, coord, devices=[CPU] * n)


def qc_batch(B, L, seed, max_len=None):
    """Bases with lowercase, N and other bytes; qualities with 3% wild
    bytes (some >= 128); lengths from -2 past L (to max_len)."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGTNacgtn.X", np.uint8)[rng.integers(0, 12,
                                                                (B, L))]
    qual = rng.integers(33, 75, (B, L)).astype(np.uint8)
    wild = rng.random((B, L)) < 0.03
    qual[wild] = rng.integers(0, 256, int(wild.sum()))
    lens = rng.integers(-2, (max_len or L + 6) + 1, B).astype(np.int32)
    return np.ascontiguousarray(seq), qual, lens


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("B,L,n_valid,n_qual,n_len,max_len", [
    (64, 32, 64, 128, 512, None),
    (100, 40, 77, 128, 512, 700),
    (50, 128, 0, 128, 512, None),
    (60, 36, 60, 64, 300, 400),
    (48, 24, 40, 1, 512, None),
])
def test_qc_step(B, L, n_valid, n_qual, n_len, max_len):
    seq, qual, lens = qc_batch(B, L, B + L, max_len)
    got = qc_step(*map(torch.from_numpy, (seq, qual, lens)), n_valid,
                  n_qual=n_qual, n_len=n_len)
    ref = jax_qc_step(seq, qual, lens, np.int32(n_valid), n_qual=n_qual,
                      n_len=n_len)
    assert set(got) == set(ref)
    for k in ref:
        same(got[k].numpy(), ref[k])


def test_qc_step_needs_whole_bytes():
    seq, qual, lens = qc_batch(8, 30, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        qc_step(*map(torch.from_numpy, (seq, qual, lens)), 8)
    with pytest.raises(Exception):
        jax_qc_step(seq, qual, lens, np.int32(8))


@pytest.mark.parametrize("n_qual", [0, 129])
def test_qc_step_n_qual_range(n_qual):
    seq, qual, lens = qc_batch(8, 32, 2)
    with pytest.raises(ValueError, match="n_qual"):
        qc_step(*map(torch.from_numpy, (seq, qual, lens)), 8, n_qual=n_qual)


def test_depth_deltas():
    rng = np.random.default_rng(4)
    n_pos, E = 1000, 700
    starts = rng.integers(-50, n_pos + 50, E).astype(np.int32)
    ends = (starts + rng.integers(0, 120, E)).astype(np.int32)
    valid = rng.random(E) < 0.8
    got = depth_deltas(*map(torch.from_numpy, (starts, ends, valid)), n_pos)
    same(got.numpy(), jax_depth_deltas(starts, ends, valid, n_pos))


@pytest.mark.parametrize("n", NS)
def test_sharded_qc_step(n):
    B, L = 16 * n, 64
    seq, qual, lens = qc_batch(B, L, n)
    n_valid = np.array([16 - (i % 5) for i in range(n)], np.int32)
    jm = jmesh.make_mesh(n)
    with jm:
        merged, gc, packed = jdist.sharded_qc_step(jm)(
            *jdist.shard_batch_arrays(jm, seq, qual, lens, n_valid))
    m = cpu_mesh(n)
    t_merged, t_gc, t_packed = dist.sharded_qc_step(m)(
        *dist.shard_batch_arrays(m, seq, qual, lens), n_valid)
    assert set(t_merged) == set(merged)
    for k in merged:
        same(t_merged[k].numpy(), merged[k])
    same(torch.cat(t_gc).numpy(), gc)
    same(torch.cat(t_packed).numpy(), packed)


@pytest.mark.parametrize("n", NS)
def test_sharded_pileup(n):
    rng = np.random.default_rng(10 + n)
    n_pos, E = 3000, 40 * n
    starts = rng.integers(-20, n_pos, E).astype(np.int32)
    ends = (starts + rng.integers(1, 200, E)).astype(np.int32)
    valid = rng.random(E) < 0.9
    jm = jmesh.make_mesh(n)
    with jm:
        ref = jdist.sharded_pileup(jm, n_pos)(
            *jdist.shard_batch_arrays(jm, starts, ends, valid))
    m = cpu_mesh(n)
    got = dist.sharded_pileup(m, n_pos)(
        *dist.shard_batch_arrays(m, starts, ends, valid))
    same(got.numpy(), ref)


def test_shard_batch_arrays_own_storage():
    m = cpu_mesh(4, coord=2)
    src = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    (shards,) = dist.shard_batch_arrays(m, src)
    # rows split over 'dp' (2 shards), replicated over 'coord'
    for s, t in zip(m.shards, shards):
        r = m.coords(s)[0]
        assert torch.equal(t, src[4 * r:4 * r + 4]) and t.is_contiguous()
        assert t.untyped_storage().data_ptr() != \
            src.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="split evenly"):
        dist.shard_batch_arrays(m, np.zeros(7))


def test_make_mesh():
    m = cpu_mesh(8, coord=2)
    assert (m.shape, m.axis_names, m.size) == ((4, 2), ("dp", "coord"), 8)
    assert m.coords(5) == (2, 1) and m.group is None
    assert cpu_mesh(3, coord=1).shape == (3, 1)
    assert mesh.make_mesh(devices=[CPU] * 5).shape == (5,)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        mesh.make_mesh(3, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="not divisible by coord=4"):
        cpu_mesh(6, coord=4)
    # the same rules as ngstpu's
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.make_mesh(6, coord=4)
    assert mesh.spread_devices(3, "cpu") == [CPU] * 3


def test_available_devices_and_tool_mesh(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU's device list")
    assert mesh.available_devices() == [CPU]
    assert mesh.tool_mesh(4, CPU) is None
    monkeypatch.setattr(mesh, "available_devices", lambda: [CPU] * 4)
    assert mesh.tool_mesh(1, CPU) is None
    assert mesh.tool_mesh(3, CPU).shape == (3,)
    assert mesh.tool_mesh(8, CPU).shape == (4,)
    assert mesh.tool_mesh(4, torch.device("cuda", 0)) is None


def test_collectives_in_process():
    m = cpu_mesh(4, coord=2)  # shard s at (dp, coord) = (s // 2, s % 2)
    comm = collectives.of(m)
    xs = [torch.full((2,), 10 * s + 1) for s in range(4)]
    assert [int(x[0]) for x in comm.psum(xs, "dp")] == [22, 42, 22, 42]
    assert [int(x[0]) for x in comm.psum(xs, "coord")] == [12, 12, 52, 52]
    assert comm.all_gather(xs, "dp")[1].tolist() == [11, 11, 31, 31]
    assert comm.axis_index("coord") == [0, 1, 0, 1]
    assert comm.axis_index("dp") == [0, 0, 1, 1]
    flat = cpu_mesh(3)
    ys = [torch.tensor([[10 * s + j] for j in range(3)]) for s in range(3)]
    out = collectives.of(flat).all_to_all(ys)
    # chunk j of shard i lands as chunk i of shard j
    assert [o.reshape(-1).tolist() for o in out] == [
        [0, 10, 20], [1, 11, 21], [2, 12, 22]]
    assert collectives.of(flat).collect(ys) == ys


def test_hash_rows_and_buckets():
    rng = np.random.default_rng(6)
    words = rng.integers(0, 1 << 32, (500, 3), dtype=np.uint32)
    assert (words >= 1 << 31).any()
    lens = rng.integers(0, 200, 500).astype(np.int32)
    ref = np.asarray(jdsort._hash_rows(words, lens))
    got = dsort._hash_rows(torch.from_numpy(words.view(np.int32)),
                           torch.from_numpy(lens)).numpy()
    assert np.array_equal(got, ref.astype(np.int64))
    for n in (2, 3, 4, 7, 8):
        assert np.array_equal(got % n, (ref % n).astype(np.int64))


def dup_keys(B, W, seed, distinct=40):
    """Heavily duplicated uint32 keys with the top bit set, lengths and
    quality sums with ties."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, (distinct, W), dtype=np.uint32)
    pool[:, 0] |= np.uint32(1 << 31)
    words = pool[rng.integers(0, distinct, B)]
    lens = rng.integers(30, 33, B).astype(np.int32)
    sumq = rng.integers(0, 50, B).astype(np.uint32)
    return np.ascontiguousarray(words), lens, sumq


@pytest.mark.parametrize("n", NS)
def test_exchange_dedup_per_shard(n):
    """Every shard's sorted columns and head flags equal JAX's shard for
    shard: a transposed all_to_all would show here as wrong rows."""
    B = 24 * n
    words, lens, sumq = dup_keys(B, 2, n)
    valid = np.arange(B) < B - 5
    gidx = np.arange(B, dtype=np.int32)
    jm = jmesh.make_mesh(n)
    with jm:
        args = [jax.device_put(a, NamedSharding(
            jm, P("dp", *([None] * (a.ndim - 1)))))
            for a in (words, lens, sumq, gidx, valid)]
        ref = [np.asarray(x) for x in jdsort.exchange_dedup(jm, 1.5)(*args)]
    m = cpu_mesh(n)
    got = dsort.exchange_dedup(m, 1.5)(*dist.shard_batch_arrays(
        m, words.view(np.int32), lens, sumq.view(np.int32), gidx, valid))
    for r, g in zip(ref, got):
        assert len(g) == n
        for r_shard, g_shard in zip(np.split(r, n), g):
            assert np.array_equal(g_shard.numpy(), r_shard.astype(
                g_shard.numpy().dtype))


@pytest.mark.parametrize("n", NS)
def test_distributed_dedup(n):
    B = 40 * n + 3  # not a multiple of n
    words, lens, sumq = dup_keys(B, 3, 20 + n)
    sumq[::7] = np.uint32(3_000_000_000)  # sums past 2**31 wrap alike
    ref = jdsort.distributed_dedup(jmesh.make_mesh(n), words, lens, sumq)
    got = dsort.distributed_dedup(cpu_mesh(n), words, lens, sumq)
    for r, g in zip(ref, got):
        same(g, r)
    # rep after the shuffle: the single-device dedup's, in the same order
    g1 = sortengine.dedup_groups(words, lens, sumq, B, CPU)
    assert np.array_equal(got[3], g1["rep"])
    assert np.array_equal(got[2], g1["counts"])


@pytest.mark.parametrize("length_first", [True, False])
@pytest.mark.parametrize("n", NS)
def test_distributed_sort(n, length_first):
    B = 30 * n + 1
    words, lens, _ = dup_keys(B, 3, 30 + n, distinct=25)
    ref = jdsort.distributed_sort(jmesh.make_mesh(n), words, lens,
                                  length_first)
    got = dsort.distributed_sort(cpu_mesh(n), words, lens, length_first)
    same(got, ref)
    single = sortengine.lex_argsort(sortengine.words_tensor(words, CPU),
                                    torch.from_numpy(lens), length_first)
    assert np.array_equal(got, single.numpy())


@pytest.mark.parametrize("what", ["dedup", "sort"])
def test_bucket_overflow_raises(what):
    """Skewed keys with a small pad_factor: both packages raise."""
    n, B = 4, 256
    words = np.full((B, 2), 7, np.uint32)
    lens = np.full(B, 20, np.int32)
    sumq = np.arange(B, dtype=np.uint32)
    for pkg, mk in ((jdsort, jmesh.make_mesh), (dsort, cpu_mesh)):
        with pytest.raises(RuntimeError, match="bucket overflow"):
            if what == "dedup":
                pkg.distributed_dedup(mk(n), words, lens, sumq,
                                      pad_factor=0.5)
            else:
                pkg.distributed_sort(mk(n), words, lens, pad_factor=0.01)


def test_pe_key():
    """dryrun's phase-5 key against ngstpu's concat_pairs and
    pack_words_host."""
    from ngstpu.io.native import concat_pairs
    from ngstpu.ops.hostsort import pack_words_host

    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    s1 = np.ascontiguousarray(acgt[rng.integers(0, 4, (50, 13))])
    s2 = np.ascontiguousarray(acgt[rng.integers(0, 4, (50, 22))])
    l1 = rng.integers(5, 14, 50).astype(np.int32)
    l2 = rng.integers(9, 23, 50).astype(np.int32)
    key, words, key_lens = dryrun.pe_key(s1, l1, s2, l2, CPU)
    ref_key = concat_pairs(s1, l1, s2, l2, 48)
    same(key, ref_key)
    same(words, pack_words_host(ref_key, "dna2"))
    same(key_lens, (l1 + l2).astype(np.int32))


def test_assign_shards_and_process_info(tmp_path):
    paths = []
    for i, size in enumerate([100, 5000, 300, 4000, 50, 2000, 5000]):
        p = tmp_path / f"f{i}.fq"
        p.write_bytes(b"x" * size)
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.fq"))
    for world in (1, 2, 3, 5):
        for rank in range(world):
            assert multihost.assign_shards(paths, rank, world) == \
                jmulti.assign_shards(paths, rank, world)
    assert multihost.process_info() == (0, 1)
    assert multihost.assign_shards(paths) == jmulti.assign_shards(paths)


def test_allreduce_stats_single_process():
    a = {"q": np.arange(12).reshape(3, 4), "n": np.array([5], np.int32)}
    got = multihost.allreduce_stats(a)
    ref = jmulti.allreduce_stats(a)
    for k in a:
        assert np.array_equal(got[k], ref[k]) and np.array_equal(got[k],
                                                                 a[k])


def test_dryrun_multichip_and_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jfn, jargs = mod.entry()
    fn, args = dryrun.entry("cpu")
    ref, got = jfn(*jargs), fn(*args)
    for k in ref:
        same(got[k].numpy(), ref[k])
    dryrun.dryrun_multichip(8, "cpu")
    dryrun.dryrun_multichip(3, "cpu")  # odd: coord 1


def test_scalebench_rows():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert scalebench.main(["--sizes", "1,2", "--reads-per-chip", "256",
                                "--len", "32", "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [r["n_dev"] for r in rows] == [1, 2]
    assert [r["reads"] for r in rows] == [256, 512]
    for r in rows:
        assert r["device"] == "cpu" and r["shards_per_device"] == r["n_dev"]
        for k in ("qc_reads_per_s", "dedup_reads_per_s",
                  "dedup_prod_reads_per_s", "dsort_reads_per_s",
                  "qc_scaling_eff"):
            assert r[k] > 0
    assert rows[0]["qc_scaling_eff"] == 1.0


def test_scalebench_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="is_available"):
        scalebench.main(["--sizes", "1", "--reads-per-chip", "64"])


def test_profile_stages_counts(tmp_path):
    from ngstpu.testing.pileup_profile import profile_stages as jax_profile
    from ngstpu_torch.testing.bamfixtures import random_bam_fast
    from ngstpu_torch.testing.pileup_profile import profile_stages

    bam = str(tmp_path / "p.bam")
    random_bam_fast(bam, [("c1", 40000), ("c2", 25000)], 3000, seed=8)
    got, ref = profile_stages(bam, window=5000), jax_profile(bam,
                                                            window=5000)
    for k in ("path", "compressed_bytes", "inflated_bytes", "events",
              "bedgraph_bytes"):
        assert got[k] == ref[k], k
    assert got["events"] > 0 and got["bedgraph_bytes"] > 0
    assert set(got["stages"]) == set(ref["stages"])
    assert got["stages"]["bgzf_scan"]["blocks"] == \
        ref["stages"]["bgzf_scan"]["blocks"]


def _fastq(tmp_path, name, pe):
    from ngstpu.testing.fixtures import random_fastq, random_fastq_pair

    if pe:
        # duplicated pairs: the first 90 records again on both mates
        datas = [d + b"\n".join(d.split(b"\n")[:360]) + b"\n"
                 for d in random_fastq_pair(300, 40, seed=41)]
    else:
        datas = [random_fastq(500, 70, seed=42, var_len=True, with_n=True,
                              dup_frac=0.4)]
    paths = []
    for i, d in enumerate(datas):
        p = tmp_path / f"{name}_{i + 1}.fq"
        p.write_bytes(d)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("tool,flag,pe", [
    ("gzfastq_uniq", None, False), ("gzfastq_uniq", None, True),
    ("gzfastq_sort", "-s", False), ("gzfastq_sort", "-n", False)])
def test_tools_mesh(tmp_path, capsys, monkeypatch, tool, flag, pe):
    """-m 4 over four CPU shards: the sharded path runs, and its outputs
    equal ngstpu's -m 4 (sharded over 4 of conftest's virtual devices)
    and the port's single-device path, byte for byte."""
    from ngstpu.tools.cli import main as jax_cli
    from ngstpu_torch.tools import gzfastq_sort, gzfastq_uniq
    from ngstpu_torch.tools.cli import main as torch_cli

    monkeypatch.setattr(mesh, "available_devices", lambda: [CPU] * 4)
    monkeypatch.setenv("NGSTPU_LINK", "device")
    monkeypatch.delenv("NGSTPU_NO_FASTPATH", raising=False)
    monkeypatch.delenv("NGSTPU_MESH", raising=False)
    sharded = []
    mod, fn = ((gzfastq_uniq, "distributed_dedup") if tool == "gzfastq_uniq"
               else (gzfastq_sort, "distributed_sort"))
    real = getattr(mod, fn)

    def counted(m, *a, **kw):
        sharded.append(m.size)
        return real(m, *a, **kw)

    monkeypatch.setattr(mod, fn, counted)
    paths = _fastq(tmp_path, "in", pe)
    if tool == "gzfastq_uniq":
        argv = ["-1", paths[0]] + (["-2", paths[1]] if pe else [])
        outputs = (("_1_uniq.fq", "_2_uniq.fq") if pe
                   else ("_uniq.fq", "_sortKeyUniq.fq"))
    else:
        argv = ["-i", paths[0], flag]
        outputs = ("_sort_by_seq.fq" if flag == "-s"
                   else "_sort_by_name.fq",)
    res = {}
    for side, cli, pre, mflag in (
            ("jax", jax_cli, [], ["-m", "4"]),
            ("torch", torch_cli, ["--device", "cpu"], ["-m", "4"]),
            ("single", torch_cli, ["--device", "cpu"], [])):
        out = tmp_path / side
        assert cli([*pre, tool, *argv, *mflag, "-o", str(out)]) == 0
        capsys.readouterr()
        res[side] = [pathlib.Path(f"{out}{s}").read_bytes()
                     for s in outputs]
        assert all(res[side])
    assert sharded == [4]
    assert res["torch"] == res["jax"] == res["single"]
