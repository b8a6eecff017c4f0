"""The port's QCAccumulator and fastq_count against the JAX package's."""

import io
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngstpu.ops.count import QCAccumulator as JaxQC
from ngstpu.testing.fixtures import random_fastq
from ngstpu.tools import fastq_count as jax_fastq_count
from ngstpu_torch.ops.count import QCAccumulator
from ngstpu_torch.tools import fastq_count


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for B, L in ((700, 100), (1500, 128), (300, 600), (1024, 150)):
        qual = rng.integers(33, 75, (B, L), dtype=np.uint8)
        qual[rng.random((B, L)) < 0.01] = 200
        lens = rng.integers(0, L + 1, B, dtype=np.int32)
        out.append((qual, lens, B - int(rng.integers(0, 50))))
    return out


@pytest.mark.parametrize("mode", ["device", "host"])
def test_accumulator_matches_jax(monkeypatch, mode):
    monkeypatch.setenv("NGSTPU_QC", mode)
    ref, acc = JaxQC(), QCAccumulator("cpu")
    for qual, lens, n in _batches(5):
        ref.add_batch(qual, lens, n)
        acc.add_batch(qual, lens, n)
    np.testing.assert_array_equal(acc.quality, ref.quality)
    np.testing.assert_array_equal(acc.seq_len, ref.seq_len)
    assert acc.stats() == ref.stats()
    assert fastq_count._row("x.fq", acc) == jax_fastq_count._row("x.fq", ref)
    assert fastq_count._len_detail(acc) == jax_fastq_count._len_detail(ref)


def test_from_state_continues_jax_totals(monkeypatch):
    monkeypatch.setenv("NGSTPU_QC", "device")
    batches = _batches(6)
    ref = JaxQC()
    for qual, lens, n in batches[:2]:
        ref.add_batch(qual, lens, n)
    acc = QCAccumulator.from_state(np.asarray(ref._dev_q),
                                   np.asarray(ref._dev_len), "cpu")
    for qual, lens, n in batches[2:]:
        ref.add_batch(qual, lens, n)
        acc.add_batch(qual, lens, n)
    assert acc._dev_q.dtype == torch.int32
    np.testing.assert_array_equal(acc.quality, ref.quality)
    np.testing.assert_array_equal(acc.seq_len, ref.seq_len)
    assert acc.stats() == ref.stats()


def test_merge_and_host_partials(monkeypatch):
    monkeypatch.setenv("NGSTPU_QC", "device")
    (q1, l1, n1), (q2, l2, n2) = _batches(7)[:2]
    a, b = QCAccumulator("cpu"), QCAccumulator("cpu")
    ra, rb = JaxQC(), JaxQC()
    a.add_batch(q1, l1, n1)
    ra.add_batch(q1, l1, n1)
    b.add_batch(q2, l2, n2)
    rb.add_batch(q2, l2, n2)
    a.merge(b)
    ra.merge(rb)
    assert a.stats() == ra.stats()
    hq = np.asarray(ra._dev_q).astype(np.uint64)
    hl = np.asarray(ra._dev_len).astype(np.uint64)
    w = QCAccumulator.from_host_partials(hq, hl)
    assert w.stats() == JaxQC.from_host_partials(hq, hl).stats()


@pytest.mark.parametrize("fastpath", [True, False])
def test_fastq_count_cli_matches_jax(tmp_path, monkeypatch, fastpath):
    monkeypatch.setenv("NGSTPU_QC", "device")
    if not fastpath:
        monkeypatch.setenv("NGSTPU_NO_FASTPATH", "1")
    files = []
    for k, kw in enumerate([dict(var_len=True, with_n=True), dict()]):
        p = tmp_path / f"f{k}.fq"
        p.write_bytes(random_fastq(500 + 100 * k, read_len=90, seed=30 + k,
                                   **kw))
        files.append(str(p))
    outs = []
    for main, kw in ((fastq_count.main, dict(device="cpu")),
                     (jax_fastq_count.main, {})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["-H", "-L", *files], **kw) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") == 1 + 3 * len(files)


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        QCAccumulator("cuda")
