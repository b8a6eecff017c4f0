"""The port's BAM slice against the JAX package's: the copied host layer
(BGZF, BAM, BAI, the CIGAR walk, the window bins, the fixtures) gives the
same arrays and bytes on the same inputs, and the torch pileup sweep on
CPU tensors gives the same merged intervals as the jitted one."""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngstpu.io import bai as j_bai
from ngstpu.io import bam as j_bam
from ngstpu.io import bgzf as j_bgzf
from ngstpu.ops import bamops as j_ops
from ngstpu.testing import bamfixtures as j_fix
from ngstpu_torch.io import bai as t_bai
from ngstpu_torch.io import bam as t_bam
from ngstpu_torch.io import bgzf as t_bgzf
from ngstpu_torch.ops import bamops as t_ops
from ngstpu_torch.testing import bamfixtures as t_fix
from ngstpu_torch.utils import linkprobe

REFS = [("chr1", 100_000), ("chr2", 80_000), ("chrX", 43_000)]


def _equal(a, b) -> None:
    """Deep exact equality of arrays, tuples, lists and dataclasses."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """A few thousand reads over three references (M/D/M, M/I/M and M/N/M
    cigars, flagged reads), indexed by the port's writer."""
    p = str(tmp_path_factory.mktemp("bam") / "t.bam")
    j_fix.random_bam(p, REFS, n_reads=3000, seed=7, read_len=100)
    t_bai.write_bai(p)
    return p


def test_bam_stream_and_read_bam(bam):
    """BamStream's batches (small chunks, so records cross batch edges) and
    read_bam's columns, field by field."""
    _equal(t_bam.read_bam(bam), j_bam.read_bam(bam))
    t_s, j_s = t_bam.BamStream(bam, 4096), j_bam.BamStream(bam, 4096)
    _equal(t_s.header, j_s.header)
    t_cols, j_cols = list(t_s), list(j_s)
    assert len(t_cols) > 3
    _equal(t_cols, j_cols)
    _equal(t_bam.read_bam_header(bam), j_bam.read_bam_header(bam))


@pytest.mark.parametrize("mask", [t_bam.DEF_MASK, t_bam.FUNMAP])
def test_event_streams(bam, mask):
    """stream_chrom_events and stream_pileup_events yield the same (pos,
    delta) per reference."""
    for t_fn, j_fn, kw in (
            (t_ops.stream_chrom_events, j_ops.stream_chrom_events,
             dict(chunk_bytes=8192)),
            (t_bam.stream_pileup_events, j_bam.stream_pileup_events,
             dict(chunk_bytes=8192))):
        (th, tg), (jh, jg) = t_fn(bam, mask, **kw), j_fn(bam, mask, **kw)
        _equal(th, jh)
        _equal(list(tg), list(jg))


@pytest.mark.parametrize("prealloc", [None, "1000"])
def test_stream_depth_dense(bam, monkeypatch, prealloc):
    """The dense scatter, with every array preallocated and in the lazy
    (spill and handshake) regime."""
    if prealloc:
        monkeypatch.setenv("NGSTPU_DENSE_PREALLOC_MAX", prealloc)
    (th, tg) = t_bam.stream_depth_dense(bam, t_bam.DEF_MASK, chunk_bytes=8192)
    (jh, jg) = j_bam.stream_depth_dense(bam, j_bam.DEF_MASK, chunk_bytes=8192)
    _equal(th, jh)
    _equal(list(tg), list(jg))


def test_dense_negative_start_unsupported(tmp_path):
    recs = [j_fix.encode_record("a", 0, 10, 30, "100M", "ACGT" * 25),
            j_fix.encode_record("bad", 0, -7, 30, "100M", "ACGT" * 25)]
    p = str(tmp_path / "neg.bam")
    t_fix.make_bam(p, [("c1", 5000)], recs)
    for mod in (t_bam, j_bam):
        header, gen = mod.stream_depth_dense(p, mod.DEF_MASK)
        with pytest.raises(mod.DensePileupUnsupported):
            list(gen)


def test_choose_pileup_mode(bam, monkeypatch):
    for mode in (None, "events", "dense", "sparse", "bogus"):
        if mode is None:
            monkeypatch.delenv("NGSTPU_PILEUP_MODE", raising=False)
        else:
            monkeypatch.setenv("NGSTPU_PILEUP_MODE", mode)
        assert t_bam.choose_pileup_mode(bam) == j_bam.choose_pileup_mode(bam)


@pytest.mark.parametrize("level", [0, 1, 6])
def test_bgzf_and_write_bam_bytes(tmp_path, level):
    """compress_bgzf, read_bgzf, decompress_block_range and write_bam give
    the same bytes (several blocks, a short last block)."""
    rng = np.random.default_rng(level)
    data = rng.integers(0, 8, 200_000, dtype=np.uint8).tobytes()
    t_c = t_bgzf.compress_bgzf(data, level=level)
    assert t_c == j_bgzf.compress_bgzf(data, level=level)
    assert t_bgzf.decompress_bgzf(t_c) == data
    starts, lens, isizes = t_bgzf._scan_blocks(t_c)
    _equal((starts, lens, isizes), j_bgzf._scan_blocks(t_c))
    assert t_bgzf.decompress_block_range(t_c, starts, lens, isizes, 1, 3) \
        == j_bgzf.decompress_block_range(t_c, starts, lens, isizes, 1, 3)
    header, cols = t_bam.read_bam(str(_fixture_bam(tmp_path)))
    rec = cols.body.tobytes()
    for mod, name in ((t_bam, "t.bam"), (j_bam, "j.bam")):
        mod.write_bam(str(tmp_path / name), header, rec, level=level)
    assert (tmp_path / "t.bam").read_bytes() == (tmp_path / "j.bam").read_bytes()
    (tmp_path / "x.gz").write_bytes(t_c)
    assert t_bgzf.read_bgzf(str(tmp_path / "x.gz")) == data


def _fixture_bam(tmp_path):
    p = tmp_path / "f.bam"
    if not p.exists():
        j_fix.random_bam(str(p), REFS[:2], n_reads=500, seed=3)
    return p


def test_pooled_inflater(bam):
    """PooledInflater with and without prefetch hands back the stream's
    inflated bytes (the dense and event streams read through it)."""
    want = t_bgzf.read_bgzf(bam)
    for prefetch in (False, True):
        inf = t_bgzf.PooledInflater(bam, chunk_bytes=5000, prefetch=prefetch,
                                    reserve=64)
        got, carry = [], b""
        while True:
            chunk = inf.next_chunk(carry)
            if chunk is None:
                break
            got.append(chunk[:len(chunk) // 2].tobytes())
            carry = chunk[len(chunk) // 2:]
        inf.close()
        assert b"".join(got) + bytes(carry) == want


def _adversarial_bam(path: str) -> None:
    """Records the per-record BAI loop handles case by case: unmapped ones
    (tid -1) between mapped ones, spans over many 16 kb windows (long N
    skips), reads that straddle bin edges, one bin revisited after others
    (a new chunk), and a reference with no reads."""
    seq = "ACGT" * 10
    recs = []
    for i, (pos, cigar) in enumerate([
            (10, "40M"), (16370, "40M"), (16380, "20M50000N20M"),
            (16400, "40M"), (131060, "40M"), (200000, "10M900000N30M"),
            (200010, "40M"), (1048570, "40M"), (1048600, "40M")]):
        recs.append(j_fix.encode_record(f"a{i}", 0, pos, 30, cigar, seq))
        if i % 3 == 1:
            recs.append(j_fix.encode_record(f"u{i}", -1, -1, 0, "", seq,
                                            flag=4))
    recs += [j_fix.encode_record(f"b{i}", 2, 5 + 7000 * i, 30, "40M", seq)
             for i in range(30)]
    t_fix.make_bam(path, [("c1", 3_000_000), ("c2", 1000), ("c3", 300_000)],
                   recs)


def test_write_bai_bytes(bam, tmp_path):
    """The vectorized BAI writer against the JAX package's per-record loop,
    on the fixture, on a fast-fixture BAM and on the adversarial records;
    read_bai and region_voffsets agree too."""
    fast = str(tmp_path / "fast.bam")
    j_fix.random_bam_fast(fast, [("c1", 2_000_000), ("c2", 300_000)], 20_000,
                          seed=3)
    adv = str(tmp_path / "adv.bam")
    _adversarial_bam(adv)
    for p in (bam, fast, adv):
        t_bai.write_bai(p, p + ".t.bai")
        j_bai.write_bai(p, p + ".j.bai")
        with open(p + ".t.bai", "rb") as ft, open(p + ".j.bai", "rb") as fj:
            assert ft.read() == fj.read(), p
        refs = t_bai.read_bai(p + ".t.bai")
        _equal(refs, j_bai.read_bai(p + ".j.bai"))
        for tid in range(len(refs)):
            for beg, end in ((0, 1), (16000, 17000), (0, 1 << 29)):
                assert t_bai.region_voffsets(refs, tid, beg, end) == \
                    j_bai.region_voffsets(refs, tid, beg, end)


def test_bai_reg2bin_vec():
    rng = np.random.default_rng(5)
    beg = rng.integers(0, 1 << 28, 5000)
    end = beg + rng.integers(1, 1 << rng.integers(1, 28, 5000))
    got = t_bai.reg2bin_vec(beg, end)
    assert got.tolist() == [j_bai.reg2bin(int(b), int(e))
                            for b, e in zip(beg, end)]
    with pytest.raises(struct.error):
        t_bai._bin_table(np.array([-1]), np.array([1], np.uint64),
                         np.array([2], np.uint64))


@pytest.mark.parametrize("region", ["chr2:20,001-30,000", "chr1", "chrX:1-1",
                                    "chr1:99,000-100,000"])
def test_read_bam_region(bam, region):
    header, full = t_bam.read_bam(bam)
    ref, beg, end = t_ops.parse_region(header, region)
    assert (ref, beg, end) == j_ops.parse_region(header, region)
    _equal(t_ops.region_mask(full, ref, beg, end),
           j_ops.region_mask(full, ref, beg, end))
    _equal(t_bam.read_bam_region(bam, ref, beg, end),
           j_bam.read_bam_region(bam, ref, beg, end))
    assert t_ops.parse_region(header, "chrZ") == (-1, 0, 0)


def test_cigar_walks(bam):
    header, cols = t_bam.read_bam(bam)
    mask = (cols.flag & t_bam.DEF_MASK) == 0
    _equal(t_ops.cigar_m_events(cols, mask), j_ops.cigar_m_events(cols, mask))
    _equal(t_ops.ref_span(cols), j_ops.ref_span(cols))


@pytest.mark.parametrize("args", [
    ([("c1", 60000), ("c2", 40000)], 4000, 9, 100),
    ([("a", 5000)], 777, 1, 75),
    ([("a", 5000), ("b", 300)], 1, 2, 30),
    ([(f"chr{i}", 1_000_000) for i in range(1, 25)], 30000, 7, 100)])
def test_random_bam_fast_bytes(tmp_path, args):
    """The port's fixture writer gives the JAX package's bytes."""
    refs, n, seed, read_len = args
    for mod, name in ((t_fix, "t.bam"), (j_fix, "j.bam")):
        mod.random_bam_fast(str(tmp_path / name), refs, n, seed=seed,
                            read_len=read_len)
    assert (tmp_path / "t.bam").read_bytes() == (tmp_path / "j.bam").read_bytes()


def test_random_bam_and_records(tmp_path):
    for mod, name in ((t_fix, "t.bam"), (j_fix, "j.bam")):
        mod.random_bam(str(tmp_path / name), REFS, 300, seed=11, read_len=80)
    assert (tmp_path / "t.bam").read_bytes() == (tmp_path / "j.bam").read_bytes()
    for args in (("r1", 0, 5, 60, "10M2I8M3D20M5S", "ACGTN" * 8),
                 ("u", -1, -1, 0, "", "ACG", b"\x01\x02\x03", 4)):
        assert t_fix.encode_record(*args) == j_fix.encode_record(*args)


# (E, n_valid, position range, kind): duplicates everywhere, rows past
# n_valid, a single event, every event at one position
SWEEP_CASES = [(1, 1, 10, "random"), (1, 0, 10, "random"),
               (2000, 2000, 300, "random"), (2000, 1234, 300, "random"),
               (4096, 4096, 1 << 30, "random"), (777, 500, 1, "one_pos"),
               (1000, 1000, 50, "runs")]


def _sweep_input(E, pos_range, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "one_pos":
        pos = np.full(E, 12345, np.int32)
    else:
        pos = rng.integers(0, pos_range, E).astype(np.int32)
    delta = rng.choice(np.array([1, -1, 1, 2], np.int32), E)
    if kind == "runs":  # starts then ends, the event-stream layout
        ns = E // 2
        pos[ns:] = pos[:ns] + rng.integers(1, 30, ns)
        delta[:ns], delta[ns:] = 1, -1
    return pos, delta


def _compact(s_pos, cum, is_last):
    s_pos, cum, is_last = (np.asarray(x) for x in (s_pos, cum, is_last))
    return s_pos[is_last].astype(np.int64), cum[is_last].astype(np.int64)


@pytest.mark.parametrize("case", range(len(SWEEP_CASES)))
def test_sparse_pileup_sweep_fuzz(case):
    """The torch sweep on CPU tensors against ngstpu's jitted one:
    compacted (u_pos, u_depth) exact over seeded draws (the per-event rows
    may order a position's events differently), each call counted."""
    E, n_valid, pos_range, kind = SWEEP_CASES[case]
    for seed in range(5):
        pos, delta = _sweep_input(E, pos_range, kind, seed + 100 * case)
        before = t_ops.PILEUP["sparse_pileup_sweep", "cpu"]
        got = t_ops.sparse_pileup_sweep(torch.from_numpy(pos),
                                        torch.from_numpy(delta), n_valid)
        assert t_ops.PILEUP["sparse_pileup_sweep", "cpu"] == before + 1
        assert [x.dtype for x in got] == [torch.int32, torch.int32,
                                          torch.bool]
        want = j_ops.sparse_pileup_sweep(jnp.asarray(pos), jnp.asarray(delta),
                                         jnp.int32(n_valid))
        _equal(_compact(*got), _compact(*want))
        # what the pull hands the host: the valid rows' multiset
        np.testing.assert_array_equal(np.sort(got[0].numpy()[:n_valid]),
                                      np.sort(pos[:n_valid]))


@pytest.mark.parametrize("link", ["host", "device"])
@pytest.mark.parametrize("case", range(len(SWEEP_CASES)))
def test_merged_intervals(monkeypatch, link, case):
    """merged_intervals and merged_intervals_runs under both verdicts: the
    same intervals as ngstpu's; the torch sweep runs only on 'device'."""
    monkeypatch.setenv("NGSTPU_LINK", link)
    E, _, pos_range, kind = SWEEP_CASES[case]
    pos, delta = _sweep_input(E, pos_range, kind, case)
    for t_fn, j_fn in ((t_ops.merged_intervals, j_ops.merged_intervals),
                       (t_ops.merged_intervals_runs,
                        j_ops.merged_intervals_runs)):
        for placement in (None, link):
            before = t_ops.PILEUP["sparse_pileup_sweep", "cpu"]
            got = t_fn(pos, delta, placement, device="cpu")
            ran = t_ops.PILEUP["sparse_pileup_sweep", "cpu"] - before
            assert ran == (link == "device"), (t_fn.__name__, placement)
            _equal(got, j_fn(pos, delta, placement))
    z = np.zeros(0, np.int32)
    _equal(t_ops.merged_intervals(z, z, device="cpu"),
           j_ops.merged_intervals(z, z))


def test_merged_intervals_votes_on_the_pull(monkeypatch, tmp_path):
    """With no verdict, a pull of 4 MB or more votes through note_transfer
    (into the port's own cache); a forced verdict is never overwritten."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("NGSTPU_LINK", raising=False)
    monkeypatch.setattr(linkprobe, "_VERDICT", [])
    rng = np.random.default_rng(1)
    n = 600_000  # 5.4 MB pulled (s_pos, cum, is_last), 2.4 MB of pos
    pos = rng.integers(0, 1 << 24, n).astype(np.int32)
    delta = rng.choice(np.array([1, -1], np.int32), n)
    monkeypatch.setenv("NGSTPU_QC_BW_MIN", "0.000001")
    _equal(t_ops.merged_intervals(pos, delta, device="cpu"),
           t_ops.merged_intervals(pos, delta, "host", device="cpu"))
    assert linkprobe._VERDICT == ["device"]
    assert linkprobe._cached_verdict() == "device"
    monkeypatch.setenv("NGSTPU_QC_BW_MIN", "1e12")
    linkprobe.note_transfer(4 << 20, 1.0)
    assert linkprobe._VERDICT == ["host"]
    linkprobe.note_transfer((4 << 20) - 1, 1e-9)  # small: no vote
    assert linkprobe._VERDICT == ["host"]
    monkeypatch.setenv("NGSTPU_LINK", "device")
    monkeypatch.setenv("NGSTPU_QC_BW_MIN", "0.000001")
    linkprobe.note_transfer(64 << 20, 1.0)  # forced: no vote
    assert linkprobe._VERDICT == ["host"]


def test_pileup_emit_runs(bam):
    """The fused native emitter behind the events route, on a real
    chromosome's event layout."""
    header, gen = t_bam.stream_pileup_events(bam, t_bam.DEF_MASK)
    for (name, tlen), (pos, delta) in zip(
            zip(header.ref_names, header.ref_lens), gen):
        n_windows = tlen // 6000 + 1
        t_rows, t_bins = t_ops.pileup_emit_runs(pos, delta, name.encode(),
                                                6000, n_windows)
        j_rows, j_bins = j_ops.pileup_emit_runs(pos, delta, name.encode(),
                                                6000, n_windows)
        assert bytes(t_rows) == bytes(j_rows) and len(t_rows)
        _equal(t_bins, j_bins)


def _intervals(rng, W, tlen):
    k = int(rng.integers(0, 50))
    hi = tlen + 3 * W
    if not k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    edges = np.sort(rng.choice(np.arange(0, hi), size=min(2 * k, hi),
                               replace=False))
    if len(edges) % 2:
        edges = edges[:-1]
    starts, ends = edges[0::2], edges[1::2]
    ok = ends > starts
    return starts[ok].astype(np.int64), ends[ok].astype(np.int64)


@pytest.mark.parametrize("kind", ["depth", "wig"])
def test_window_bins_fuzz(kind):
    """depth_window_bins / wig_window_bins equal ngstpu's and the loop
    ports of bam2depth.c / bam2wig.c (the *_exact oracles), exactly: the
    bins are float64 sums of integer depth x bp products."""
    fast = getattr(t_ops, f"{kind}_window_bins")
    exact = getattr(t_ops, f"{kind}_window_bins_exact")
    j_fast = getattr(j_ops, f"{kind}_window_bins")
    j_exact = getattr(j_ops, f"{kind}_window_bins_exact")
    rng = np.random.default_rng(77)
    for _ in range(300):
        W = int(rng.choice([1, 2, 3, 5, 20, 100, 20000]))
        tlen = int(rng.integers(1, 40) * W + rng.integers(0, W))
        n_windows = int(rng.choice([tlen // W + 1, max(tlen // W, 1),
                                    tlen // W + 3]))
        starts, ends = _intervals(rng, W, tlen)
        depths = rng.integers(1, 30, len(starts)).astype(np.int64)
        args = (starts, ends, depths, W, n_windows, tlen)
        got = fast(*args)
        _equal(got, j_fast(*args))
        _equal(exact(*args), j_exact(*args))
        if kind == "depth" and len(ends) and ends.max() > tlen:
            continue  # past tlen the loop port clamps its window ends
            # and the vectorized bins (ngstpu's too) do not
        np.testing.assert_array_equal(got, exact(*args))

