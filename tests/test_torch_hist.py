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
    with pytest.raises(ValueError):  # totals are [n_cycle, 128]
        hist_cuda.qc_hist_accumulate_(tq[:, :64], tl, qual,
                                      torch.zeros(4, dtype=torch.int32), 4)


@pytest.mark.parametrize("n_cycle,n_len", [(100, 302), (600, 2), (1000, 1000),
                                           (64, 512)])
@pytest.mark.parametrize("L", [100, 600])
def test_plain_other_sizes_match_xla(L, n_cycle, n_len):
    """n_cycle and n_len other than 512: the cycles below min(L, n_cycle)
    equal JAX's [L, 128] qc_histograms, the rest are zero; the length
    histogram equals JAX's at n_len bins."""
    qual, lens, n_valid = _batch(L + n_cycle + n_len, 700, L, 650)
    lens[::9] = L + 50  # lengths past the width and past n_len
    hq, hl = hist_cuda.qc_hist_plain(torch.from_numpy(qual),
                                     torch.from_numpy(lens), n_valid,
                                     n_cycle, n_len)
    ch, lh = jax_qc_histograms(jnp.asarray(qual), jnp.asarray(lens),
                               jnp.int32(n_valid), n_len=n_len)
    C = min(L, n_cycle)
    assert tuple(hq.shape) == (n_cycle, 128) and tuple(hl.shape) == (n_len,)
    np.testing.assert_array_equal(hq.numpy()[:C], np.asarray(ch)[:C])
    assert not hq.numpy()[C:].any()
    np.testing.assert_array_equal(hl.numpy(), np.asarray(lh))
    tq = torch.zeros((n_cycle, 128), dtype=torch.int32)
    tl = torch.zeros(n_len, dtype=torch.int32)
    hist_cuda.qc_hist_accumulate_(tq, tl, torch.from_numpy(qual),
                                  torch.from_numpy(lens), n_valid)
    assert torch.equal(tq, hq) and torch.equal(tl, hl)


def _emulate(plan, qual, lens):
    """csrc/qc_hist.cu's index arithmetic in numpy, block by block: the
    16-byte words that hold each row's live tile bytes copied into its
    staged slot with the row's (live cycles, slot offset) pair, each lane's
    byte read back at offset + lc, and the lengths of tile 0's blocks
    counted in plan.len_bins shared bins (merged at the end) or, past
    them, straight into the totals."""
    B, L = qual.shape
    flat = qual.reshape(-1)
    total = B * L
    tq = np.zeros((plan.n_cycle, 128), np.int64)
    tl = np.zeros(plan.n_len, np.int64)
    C = min(L, plan.n_cycle)
    rc = plan.rows_per_chunk
    n_chunks = -(-plan.n_rows // rc)
    for ty in range(plan.grid_y):
        c0 = ty * plan.tile_c
        c1 = min(C, c0 + plan.tile_c)
        for bx in range(plan.grid_x):
            table = np.zeros((128, plan.tile_c), np.int64)
            s_len = np.zeros(plan.len_bins, np.int64)
            for chunk in range(bx, n_chunks, plan.grid_x):
                r0 = chunk * rc
                nr = min(rc, plan.n_rows - r0)
                stage = np.full(rc * plan.pitch, 255, np.int64)
                meta = []
                for row in range(nr):
                    r = r0 + row
                    if ty == 0:
                        b = min(max(int(lens[r]), 0), plan.n_len - 1)
                        if b < plan.len_bins:
                            s_len[b] += 1
                        else:
                            tl[b] += 1
                    live_end = min(max(int(lens[r]), c0), c1)
                    start = r * L + c0
                    end = start - c0 + live_end
                    meta.append((live_end - c0, row * plan.pitch + start % 16))
                    dst = row * plan.pitch
                    for a in range(start - start % 16, end, 16):
                        assert dst + 16 <= (row + 1) * plan.pitch
                        hi = min(a + 16, total)
                        stage[dst:dst + hi - a] = flat[a:hi]
                        dst += 16
                for row in range(nr):
                    r = r0 + row
                    live, off = meta[row]
                    for lc in range(max(0, live)):
                        q = stage[off + lc]
                        assert q == qual[r, c0 + lc]
                        if q < 128:
                            table[q, lc] += 1
            tq[c0:c0 + plan.tile_c] += table.T[:plan.n_cycle - c0]
            tl[:plan.len_bins] += s_len[:plan.n_len]
    return tq, tl


SHAPES = [(100, 512), (128, 512), (600, 512), (640, 512), (100, 100),
          (128, 128), (600, 600), (640, 640)]


@pytest.mark.parametrize("L,n_cycle", SHAPES)
def test_plan_launch(L, n_cycle):
    """The launch's sizes: tiles cover the counted cycles, every staged
    row segment fits its slot, the block fits two to an SM's shared
    memory, and the grid strides over the chunks within the card's
    resident blocks."""
    for B in (262144, 10_000_000):
        plan = hist_cuda.plan_launch(B, L, n_cycle, 302, slots=132)
        C = min(L, n_cycle)
        assert plan.tile_c % 32 == 0 and plan.tile_c <= hist_cuda.TILE_MAX
        assert (plan.grid_y - 1) * plan.tile_c < C <= \
            plan.grid_y * plan.tile_c
        assert plan.threads == 32 * hist_cuda.WARPS <= 1024
        words = (plan.tile_c + 15 + 15) // 16
        assert plan.pitch >= 16 * words and words <= 32  # a word a lane
        assert plan.rows_per_chunk % hist_cuda.WARPS == 0
        assert plan.smem <= hist_cuda.SMEM_MAX
        assert plan.len_bins % 4 == 0  # the ring starts 16-byte aligned
        assert plan.grid_x * plan.grid_y <= 132
        chunks = -(-B // plan.rows_per_chunk)
        assert 1 <= plan.grid_x <= chunks
    small = hist_cuda.plan_launch(3000, L, n_cycle, 512, slots=132)
    chunks = -(-3000 // small.rows_per_chunk)
    assert small.grid_x == min(chunks, 132 // small.grid_y)
    assert small.n_rows == 3000


@pytest.mark.parametrize("L,n_cycle", SHAPES)
def test_kernel_indexing_emulated(L, n_cycle):
    """The kernel's copy and count arithmetic, run in numpy on the plan of
    a small batch (several chunks per block, a partial last chunk, odd
    row offsets mod 16), equals the plain version."""
    B = 173
    qual, lens, n_valid = _batch(L * 7 + n_cycle, B, L, 170)
    lens[::5] = L + 3
    plan = hist_cuda.plan_launch(B, L, n_cycle, 302, n_valid, slots=4)
    plan = hist_cuda.dataclasses.replace(plan, rows_per_chunk=16, grid_x=3)
    tq, tl = _emulate(plan, qual, lens)
    pq, pl = hist_cuda.qc_hist_plain(torch.from_numpy(qual),
                                     torch.from_numpy(lens), n_valid,
                                     n_cycle, 302)
    np.testing.assert_array_equal(tq, pq.numpy())
    np.testing.assert_array_equal(tl, pl.numpy())


@pytest.mark.parametrize("n_len", [302, 512, 602, 1000])
def test_kernel_length_bins_emulated(n_len):
    """fastqc_stats' length bins past the kernel's LEN_BINS_MAX shared ones
    (max_len 600 gives 602): the emulated kernel, whose bins past
    plan.len_bins go straight to the totals, equals the plain version."""
    B, L = 97, 600
    qual, lens, n_valid = _batch(n_len, B, L, 95)
    lens[:] = np.random.default_rng(n_len).integers(0, n_len + 50, B)
    plan = hist_cuda.plan_launch(B, L, L, n_len, n_valid, slots=4)
    assert plan.len_bins == min(-(-n_len // 4) * 4, hist_cuda.LEN_BINS_MAX)
    plan = hist_cuda.dataclasses.replace(plan, rows_per_chunk=32, grid_x=2)
    tq, tl = _emulate(plan, qual, lens)
    pq, pl = hist_cuda.qc_hist_plain(torch.from_numpy(qual),
                                     torch.from_numpy(lens), n_valid, L,
                                     n_len)
    np.testing.assert_array_equal(tq, pq.numpy())
    np.testing.assert_array_equal(tl, pl.numpy())
    if n_len > hist_cuda.LEN_BINS_MAX:
        assert tl[hist_cuda.LEN_BINS_MAX:].sum() > 0


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
