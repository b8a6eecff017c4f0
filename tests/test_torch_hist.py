"""The port's QC histogram (kernels/hist_cuda.py) against the JAX package:
the Pallas kernel in interpret mode, the XLA histogram and the native host
histogram. Counts are integers, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngstpu.io.native import get_lib
from ngstpu.kernels.hist_pallas import qc_hist_pallas
from ngstpu.ops.count import qc_histograms as jax_qc_histograms
from ngstpu_torch.kernels import hist_cuda
from ngstpu_torch.ops.count import qc_histograms


def _batch(seed, B, L, n_valid):
    rng = np.random.default_rng(seed)
    qual = rng.integers(33, 75, (B, L), dtype=np.uint8)
    wild = rng.random((B, L)) < 0.05  # bytes >= 128 are never counted
    qual[wild] = rng.integers(0, 256, int(wild.sum()), dtype=np.uint8)
    lens = rng.integers(0, L + 1, B, dtype=np.int32)
    lens[:7] = 0  # zero-length reads
    return qual, lens, n_valid


CASES = [(1024, 100, 1000), (2048, 128, 2048), (1024, 600, 777),
         (2048, 600, 1500)]


@pytest.mark.parametrize("B,L,n_valid", CASES)
def test_plain_matches_pallas_interpret(B, L, n_valid):
    qual, lens, n_valid = _batch(B + L, B, L, n_valid)
    hq, hl = hist_cuda.qc_hist_plain(torch.from_numpy(qual),
                                     torch.from_numpy(lens), n_valid)
    ref = np.asarray(qc_hist_pallas(jnp.asarray(qual), jnp.asarray(lens),
                                    jnp.int32(n_valid), interpret=True))
    C = min(L, 512)
    assert hq.dtype == torch.int32 and tuple(hq.shape) == (512, 128)
    np.testing.assert_array_equal(hq.numpy()[:C], ref.T[:C])
    assert not hq.numpy()[C:].any()
    want_len = np.bincount(np.clip(lens[:n_valid], 0, 511), minlength=512)
    np.testing.assert_array_equal(hl.numpy(), want_len)


@pytest.mark.parametrize("B,L,n_valid", CASES)
def test_plain_matches_xla_and_native(B, L, n_valid):
    qual, lens, n_valid = _batch(B * 3 + L, B, L, n_valid)
    hq, hl = hist_cuda.qc_hist_plain(torch.from_numpy(qual),
                                     torch.from_numpy(lens), n_valid)
    ch, lh = jax_qc_histograms(jnp.asarray(qual), jnp.asarray(lens),
                               jnp.int32(n_valid))
    C = min(L, 512)
    np.testing.assert_array_equal(hq.numpy()[:C], np.asarray(ch)[:C])
    np.testing.assert_array_equal(hl.numpy(), np.asarray(lh))
    # the port's own plain qc_histograms agrees with the JAX one
    tch, tlh = qc_histograms(torch.from_numpy(qual), torch.from_numpy(lens),
                             n_valid)
    np.testing.assert_array_equal(tch.numpy(), np.asarray(ch))
    np.testing.assert_array_equal(tlh.numpy(), np.asarray(lh))
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    nq = np.zeros((512, 128), np.uint64)
    nl = np.zeros(512, np.uint64)
    lib.ngs_qc_hist(np.ascontiguousarray(qual[:n_valid]),
                    np.ascontiguousarray(lens[:n_valid]), n_valid, L, 128,
                    512, nq, nl, 0)
    np.testing.assert_array_equal(hq.numpy().astype(np.uint64), nq)
    np.testing.assert_array_equal(hl.numpy().astype(np.uint64), nl)


def test_accumulate_in_place_on_cpu():
    tq = torch.zeros((512, 128), dtype=torch.int32)
    tl = torch.zeros(512, dtype=torch.int32)
    ptr = tq.data_ptr()
    want_q = np.zeros((512, 128), np.int64)
    want_l = np.zeros(512, np.int64)
    launches = hist_cuda.LAUNCHES
    for seed, (B, L, n) in enumerate([(1024, 100, 1000), (512, 640, 300)]):
        qual, lens, n = _batch(seed, B, L, n)
        hist_cuda.qc_hist_accumulate_(tq, tl, torch.from_numpy(qual),
                                      torch.from_numpy(lens), n)
        ch, lh = jax_qc_histograms(jnp.asarray(qual), jnp.asarray(lens),
                                   jnp.int32(n))
        want_q[:min(L, 512)] += np.asarray(ch)[:512]
        want_l += np.asarray(lh)
    assert tq.data_ptr() == ptr
    np.testing.assert_array_equal(tq.numpy(), want_q)
    np.testing.assert_array_equal(tl.numpy(), want_l)
    assert hist_cuda.LAUNCHES == launches  # the CPU never launches


def test_wrapper_rejects_bad_input():
    tq = torch.zeros((512, 128), dtype=torch.int32)
    tl = torch.zeros(512, dtype=torch.int32)
    qual = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hist_cuda.qc_hist_accumulate_(tq, tl, qual,
                                      torch.zeros(4, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        hist_cuda.qc_hist_accumulate_(tq[:256], tl, qual,
                                      torch.zeros(4, dtype=torch.int32), 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,n_valid", CASES + [(262144, 128, 262000)])
def test_kernel_matches_plain_on_card(cuda, B, L, n_valid):
    qual, lens, n_valid = _batch(B + 2 * L, B, L, n_valid)
    q = torch.from_numpy(qual).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    tq = torch.zeros((512, 128), dtype=torch.int32, device=cuda)
    tl = torch.zeros(512, dtype=torch.int32, device=cuda)
    launches = hist_cuda.LAUNCHES
    hist_cuda.qc_hist_accumulate_(tq, tl, q, ln, n_valid)
    torch.cuda.synchronize()
    assert hist_cuda.LAUNCHES == launches + 1
    pq, pl = hist_cuda.qc_hist_plain(q, ln, n_valid)
    assert torch.equal(tq, pq) and torch.equal(tl, pl)
