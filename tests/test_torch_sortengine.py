"""The port's sort engine against the JAX package's: permutations and group
heads must be equal exactly (both sorts are stable on the same keys)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngstpu.ops import sortengine as jse
from ngstpu_torch.ops import sortengine as se


def _rows(seed, B=3000, W=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 32, (B // 3, W), dtype=np.uint32)
    base[:, 0] |= np.uint32(1 << 31) * (rng.random(B // 3) < 0.5)
    pick = rng.integers(0, B // 3, B)
    words = base[pick]  # ~3 copies of each row
    lens = rng.integers(20, 40, B // 3, dtype=np.int32)[pick]
    lens[rng.random(B) < 0.1] += 1  # equal words, different lengths
    sumq = rng.integers(0, 3000, B, dtype=np.uint32)
    assert (words >= 1 << 31).any()
    return words, lens, sumq


def _t(words, lens, sumq):
    return (se.words_tensor(words, torch.device("cpu")),
            torch.from_numpy(lens), torch.from_numpy(sumq.view(np.int32)))


@pytest.mark.parametrize("length_first", [False, True])
def test_lex_argsort_matches_jax(length_first):
    words, lens, _ = _rows(1)
    ref = np.asarray(jse.lex_argsort(jnp.asarray(words), jnp.asarray(lens),
                                     length_first=length_first))
    got = se.lex_argsort(*_t(words, lens, np.zeros(len(lens), np.uint32))[:2],
                         length_first=length_first)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("length_first", [False, True])
@pytest.mark.parametrize("words_encode_len", [False, True])
@pytest.mark.parametrize("maybe_padding", [False, True])
def test_dedup_sorted_matches_jax(length_first, words_encode_len,
                                  maybe_padding):
    words, lens, sumq = _rows(2)
    n_valid = len(lens) - 37 if maybe_padding else len(lens)
    ref = jse.dedup_sorted(jnp.asarray(words), jnp.asarray(lens),
                           jnp.asarray(sumq), jnp.int32(n_valid),
                           length_first=length_first,
                           words_encode_len=words_encode_len,
                           maybe_padding=maybe_padding)
    got = se.dedup_sorted(*_t(words, lens, sumq), n_valid,
                          length_first=length_first,
                          words_encode_len=words_encode_len,
                          maybe_padding=maybe_padding)
    np.testing.assert_array_equal(got["perm"].numpy(), np.asarray(ref["perm"]))
    np.testing.assert_array_equal(got["is_head"].numpy(),
                                  np.asarray(ref["is_head"]))
    assert int(got["n_groups"]) == int(ref["n_groups"])


@pytest.mark.parametrize("length_key", [False, True])
def test_sort_partition_matches_jax(length_key):
    words, lens, sumq = _rows(3)
    n_valid = len(lens) - 100
    ref_perm, ref_head = jse.sort_partition(
        jnp.asarray(words), jnp.asarray(lens), jnp.int32(n_valid),
        length_key=length_key)
    perm, head = se.sort_partition(*_t(words, lens, sumq)[:2], n_valid,
                                   length_key=length_key)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(ref_perm))
    np.testing.assert_array_equal(head.numpy(), np.asarray(ref_head))
    p, h = perm.numpy()[:n_valid], head.numpy()[:n_valid]
    rep, counts = se.rep_counts_host(p, h, n_valid, sumq)
    ref_rep, ref_counts = jse.rep_counts_host(p, h, n_valid, sumq)
    np.testing.assert_array_equal(rep, ref_rep)
    np.testing.assert_array_equal(counts, ref_counts)


def test_pack_for_dedup_widens_words():
    rng = np.random.default_rng(4)
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (50, 30))]
    words, encode_len = se.pack_for_dedup(seq, torch.device("cpu"))
    ref, ref_encode = jse.pack_for_dedup(seq)
    assert encode_len == ref_encode is True
    assert words.dtype == torch.int64
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(ref).astype(np.int64))
