"""The port's own host runtime against the JAX package's: each copied
module gives the same arrays and bytes on the same inputs, and both native
libraries and both buffer pools live side by side in one process."""

import dataclasses
import io
import os

import numpy as np
import pytest

from ngstpu.io import fastindex as j_fastindex
from ngstpu.io import fastq as j_fastq
from ngstpu.io import native as j_native
from ngstpu.ops import hostsort as j_hostsort
from ngstpu.ops import rle as j_rle
from ngstpu.ops import twobit_host as j_twobit_host
from ngstpu.rng import mt19937 as j_mt
from ngstpu.testing import fixtures as j_fixtures
from ngstpu.tools import emitters as j_emitters
from ngstpu.tools import fastq_trim as j_fastq_trim
from ngstpu.tools import gzfastq_sort as j_gzfastq_sort
from ngstpu.tools import gzfastq_uniq as j_gzfastq_uniq
from ngstpu.utils import bufpool as j_bufpool
from ngstpu.utils import png as j_png
from ngstpu_torch.io import fastindex as t_fastindex
from ngstpu_torch.io import fastq as t_fastq
from ngstpu_torch.io import native as t_native
from ngstpu_torch.ops import hostsort as t_hostsort
from ngstpu_torch.ops import rle as t_rle
from ngstpu_torch.ops import twobit_host as t_twobit_host
from ngstpu_torch.rng import mt19937 as t_mt
from ngstpu_torch.testing import fixtures as t_fixtures
from ngstpu_torch.tools import emitters as t_emitters
from ngstpu_torch.tools import fastq_trim as t_fastq_trim
from ngstpu_torch.tools import gzfastq_sort as t_gzfastq_sort
from ngstpu_torch.tools import gzfastq_uniq as t_gzfastq_uniq
from ngstpu_torch.utils import bufpool as t_bufpool
from ngstpu_torch.utils import png as t_png


def _equal(a, b) -> None:
    """Deep equality of arrays, tuples, lists, dicts and dataclasses."""
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


def test_native_libraries_load_side_by_side():
    """One process loads both libraries, from two files of their own."""
    jl, tl = j_native.get_lib(), t_native.get_lib()
    assert jl is not None and tl is not None
    assert t_native._SO.name == "libngsio_torch.so"
    assert j_native._SO != t_native._SO
    assert jl._name != tl._name
    assert jl.ngs_version() == tl.ngs_version()


FIXTURES = {
    "fixed": dict(n_reads=120, read_len=50, seed=3),
    "var_len_n": dict(n_reads=150, read_len=90, seed=4, var_len=True,
                      with_n=True),
    "dups_comment": dict(n_reads=200, read_len=40, seed=5, dup_frac=0.3,
                         with_comment=True),
    "qual_alphabet": dict(n_reads=80, read_len=30, seed=6,
                          qual_alphabet=b"#/7<BF"),
}


@pytest.mark.parametrize("case", list(FIXTURES))
def test_random_fastq(case):
    kw = FIXTURES[case]
    assert t_fixtures.random_fastq(**kw) == j_fixtures.random_fastq(**kw)


def test_random_fastq_pair_and_gz():
    t = t_fixtures.random_fastq_pair(90, 60, seed=8, var_len=True)
    j = j_fixtures.random_fastq_pair(90, 60, seed=8, var_len=True)
    assert t == j
    assert t_fixtures.gz(t[0]) == j_fixtures.gz(j[0])
    assert t_fixtures.random_fastq_fast(300, 70, seed=9, dup_frac=0.2) == \
        j_fixtures.random_fastq_fast(300, 70, seed=9, dup_frac=0.2)


@pytest.fixture
def fq(tmp_path):
    """Three inputs: ACGT fixed length, var length with N, and gzip."""
    paths = {}
    for name, data in (
            ("acgt.fq", j_fixtures.random_fastq(700, 100, seed=11,
                                                dup_frac=0.3)),
            ("n.fq", j_fixtures.random_fastq(500, 120, seed=12,
                                             var_len=True, with_n=True,
                                             dup_frac=0.2)),
            ("acgt.fq.gz", j_fixtures.gz(j_fixtures.random_fastq(
                400, 80, seed=13)))):
        (tmp_path / name).write_bytes(data)
        paths[name] = str(tmp_path / name)
    return paths


INPUTS = ["acgt.fq", "n.fq", "acgt.fq.gz"]


@pytest.mark.parametrize("name", INPUTS)
def test_read_fastq_file(fq, name):
    _equal(t_fastq.read_fastq_file(fq[name]),
           j_fastq.read_fastq_file(fq[name]))
    t_chunks = list(t_fastq.FastqChunkReader(fq[name], chunk_bytes=1 << 14))
    j_chunks = list(j_fastq.FastqChunkReader(fq[name], chunk_bytes=1 << 14))
    assert len(t_chunks) == len(j_chunks) > 1
    for a, b in zip(t_chunks, j_chunks):
        _equal(a, b)


def _index(mod, path):
    res = mod.index_fastq_fused(path, pool=f"test.{mod.__name__}")
    ix, rest = res[0], res[1:]
    # the data buffers differ in kind (pool view or mmap); their bytes agree
    d = {f.name: getattr(ix, f.name) for f in dataclasses.fields(ix)}
    d["data"] = np.asarray(d["data"]).tobytes()
    return d, [np.array(r) if isinstance(r, np.ndarray) else r for r in rest]


@pytest.mark.parametrize("name", INPUTS)
def test_index_fastq_fused(fq, name):
    t, j = _index(t_fastindex, fq[name]), _index(j_fastindex, fq[name])
    _equal(t, j)
    ix_t = t_fastindex.index_fastq(fq[name], pool="test.t.take")
    ix_j = j_fastindex.index_fastq(fq[name], pool="test.j.take")
    perm = np.random.default_rng(1).permutation(ix_t.n).astype(np.int64)
    vt, nt = t_fastindex.take_text(ix_t, perm, "test.t.text")
    vj, nj = j_fastindex.take_text(ix_j, perm, "test.j.text")
    assert nt == nj and bytes(vt[:nt]) == bytes(vj[:nj])


def _padded(seed: int, alphabet: bytes, B: int = 300, L: int = 48):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    pad = a[rng.integers(0, len(a), (B, L))]
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    pad[np.arange(L)[None, :] >= lens[:, None]] = 0
    return pad, lens


HOSTSORT = {
    "bytes_to_words_host": lambda m, p, ln: m.bytes_to_words_host(p),
    "classify_alphabet": lambda m, p, ln: m.classify_alphabet(p),
    "is_dna3_compatible": lambda m, p, ln: m.is_dna3_compatible(p, ln),
    "pack_dna2": lambda m, p, ln: m._pack_host(p, "dna2"),
    "pack_dna3": lambda m, p, ln: m._pack_host(p, "dna3"),
    "sort_perm_host": lambda m, p, ln: m.sort_perm_host(
        m.bytes_to_words_host(p), ln, True),
    "sum_quality_host": lambda m, p, ln: m.sum_quality_host(p),
}


@pytest.mark.parametrize("fn", list(HOSTSORT))
@pytest.mark.parametrize("alphabet", [b"ACGT", b"ACGTN.", b"ACGTRYKM"])
def test_hostsort(fn, alphabet):
    pad, lens = _padded(21, alphabet)
    _equal(HOSTSORT[fn](t_hostsort, pad, lens),
           HOSTSORT[fn](j_hostsort, pad, lens))


RNG = {
    "gsl_fisher_yates": lambda m: m.gsl_fisher_yates(5000, 4357),
    "sample_indices": lambda m: m.sample_indices(10000, 777, 4357),
    "glibc_rand_first": lambda m: [m.glibc_rand_first(s)
                                   for s in (0, 1, 7, 12345, 2 ** 31 - 1)],
    "mt19937_draws": lambda m: m.MT19937(99).draws(3000),
    "x31_hash_batch": lambda m: m.x31_hash_batch(
        np.frombuffer(b"@read_1@r2@third_name@x", np.uint8),
        np.array([0, 7, 10, 21]), np.array([7, 3, 11, 2])),
}


@pytest.mark.parametrize("fn", list(RNG))
def test_rng(fn):
    _equal(RNG[fn](t_mt), RNG[fn](j_mt))


def test_rle_and_twobit_host():
    rng = np.random.default_rng(5)
    for _ in range(20):
        q = bytes(np.frombuffer(b"#/7<BF", np.uint8)[
            rng.integers(0, 6, int(rng.integers(1, 300)))])
        enc = t_rle.mrle_encode(q)
        assert enc == j_rle.mrle_encode(q)
        assert t_rle.mrle_decode(enc, len(q)) == j_rle.mrle_decode(enc, len(q))
    seq = np.frombuffer(b"ACGTNacgtu", np.uint8)[rng.integers(0, 10, (40, 64))]
    packed = t_twobit_host.pack2bit_np(seq)
    _equal(packed, j_twobit_host.pack2bit_np(seq))
    _equal(t_twobit_host.unpack2bit_np(packed),
           j_twobit_host.unpack2bit_np(packed))
    s = seq[0].tobytes()
    assert t_twobit_host.pack2bit_host(s) == j_twobit_host.pack2bit_host(s)


def test_png():
    def draw(m):
        c = m.Canvas(120, 80)
        c.filled_rectangle(5, 5, 60, 40, (200, 30, 30))
        c.rectangle(0, 0, 119, 79, (0, 0, 0))
        c.text(8, 50, "Q30 99.5%", (0, 0, 255))
        return c.to_png()

    assert draw(t_png) == draw(j_png)


def test_bufpool_default_directory(monkeypatch):
    """The port's pool takes a directory (and so a flock) of its own, and
    one that differs from checkout to checkout."""
    seen = []

    def makedirs(path, *a, **k):
        seen.append(path)
        raise OSError("not made in a test")

    monkeypatch.delenv("NGSTPU_SHM_POOL_DIR", raising=False)
    monkeypatch.setenv("NGSTPU_SHM_POOL", "1")
    monkeypatch.setattr(os, "makedirs", makedirs)
    assert j_bufpool._shm_init() == "" and t_bufpool._shm_init() == ""
    assert seen == [f"/dev/shm/ngstpu-pool-{os.geteuid()}",
                    t_bufpool.default_dir()]
    assert seen[1].startswith(f"/dev/shm/ngstpu_torch-pool-{os.geteuid()}-")
    elsewhere = "/elsewhere/ngstpu_torch/utils/bufpool.py"
    monkeypatch.setattr(t_bufpool, "__file__", elsewhere)
    assert t_bufpool.default_dir() != seen[1]
    assert t_bufpool._pool is not j_bufpool._pool


def test_emitters_host_half(fq):
    """The partition bounds and the native host sort's groups."""
    bucket = np.random.default_rng(2).integers(0, 1000, 256)
    _equal(t_emitters._partition_bounds(bucket, t_emitters.N_PARTS),
           j_emitters._partition_bounds(bucket, j_emitters.N_PARTS))
    assert (t_emitters.CHUNK_RECORDS, t_emitters.N_PARTS) == \
        (j_emitters.CHUNK_RECORDS, j_emitters.N_PARTS)
    res = {}
    for side, fi, em in (("t", t_fastindex, t_emitters),
                         ("j", j_fastindex, j_emitters)):
        ix, words, sumq, _, _, _, ok = fi.index_fastq_fused(
            fq["acgt.fq"], pool=f"test.em.{side}")
        assert ok
        groups = em._sort_host_async(words, ix.seq_len, sumq, True)
        res[side] = [(np.array(r), np.array(c)) for r, c in groups]
    _equal(res["t"], res["j"])


def test_ring_writer_and_sinks(tmp_path):
    """_RingWriter over _RecyclingSink and _CloningSink writes the bytes
    it was given, in order (the clone into a second file), as ngstpu's
    does."""
    blocks = [np.frombuffer(bytes([65 + k]) * (1000 + 77 * k), np.uint8)
              for k in range(9)]
    want = b"".join(b.tobytes() for b in blocks)
    for side, em in (("t", t_emitters), ("j", j_emitters)):
        p1, p2, p3 = (tmp_path / f"{side}{i}" for i in range(3))
        # unbuffered, as the tools open them: the clone reads f2's bytes
        # back from the file
        with open(p1, "wb", buffering=0) as f1, \
                open(p2, "wb", buffering=0) as f2, \
                open(p3, "wb", buffering=0) as f3:
            for sink in (em._RecyclingSink(f1), em._CloningSink(f2, f3)):
                w = em._RingWriter(sink, [f"test.ring.{side}.a",
                                          f"test.ring.{side}.b"])
                for b in blocks:
                    name = w.acquire()
                    w.submit(name, b, len(b))
                w.close()
        assert p1.read_bytes() == p2.read_bytes() == p3.read_bytes() == want
    assert em._fresh(str(p1)) == str(p1) and not p1.exists()


def test_tool_helpers(fq):
    """gzfastq_uniq._emit and _pad4, gzfastq_sort.emit_permuted, and
    fastq_trim.trim_batch give ngstpu's bytes."""
    batch = j_fastq.read_fastq_file(fq["n.fq"])
    rng = np.random.default_rng(4)
    rep = np.sort(rng.choice(batch.n, 200, replace=False)).astype(np.int64)
    counts = rng.integers(1, 9, 200).astype(np.int64)
    perm = rng.permutation(batch.n).astype(np.int64)
    out = {}
    for side, uq, so in (("t", t_gzfastq_uniq, t_gzfastq_sort),
                         ("j", j_gzfastq_uniq, j_gzfastq_sort)):
        a, b = io.BytesIO(), io.BytesIO()
        uq._emit(a, batch, rep, counts)
        so.emit_permuted(b, batch, perm)
        out[side] = (a.getvalue(), b.getvalue(),
                     [uq._pad4(n) for n in range(12)])
    assert out["t"] == out["j"] and out["t"][0] and out["t"][1]
    for start, end in ((0, 50), (10, 70), (200, 300)):
        _equal(t_fastq_trim.trim_batch(batch, start, end),
               j_fastq_trim.trim_batch(batch, start, end))
