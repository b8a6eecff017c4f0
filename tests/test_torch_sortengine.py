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


def _padded(seed, alphabet, B=400, L=37):
    """Zero-padded rows of `alphabet` bytes with ragged lengths."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet),
                                                         (B, L))]
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    seq[np.arange(L)[None, :] >= lens[:, None]] = 0
    return np.ascontiguousarray(seq), lens


@pytest.mark.parametrize("packer,alphabet,L", [
    ("bytes_to_words", bytes(range(1, 256)), 36),  # top bit set
    ("dna2_words", b"ACGT", 37),
    ("dna3_words", b".ACGNT", 37),
])
def test_device_packers_match_jax(packer, alphabet, L):
    seq, _ = _padded(7, alphabet, L=L)
    ref = np.asarray(getattr(jse, packer)(jnp.asarray(seq)))
    before = se.PACKS[packer, "cpu"]
    got = getattr(se, packer)(torch.from_numpy(seq))
    assert se.PACKS[packer, "cpu"] == before + 1
    assert got.dtype == torch.int64
    if packer == "bytes_to_words":
        assert (ref >= 1 << 31).any()
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("alphabet", [b"ACGTN", b"ACGTX"])
def test_seq_words_matches_jax(alphabet):
    seq, _ = _padded(8, alphabet, L=40)
    ref = np.asarray(jse.seq_words(seq))
    got = se.seq_words(seq, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("kind", ["dna2", "dna3"])
def test_pack_words_without_native_lib_packs_on_device(monkeypatch, kind):
    """No native lib: the port packs with its own device packers (the JAX
    package's host fallback imports jax)."""
    seq, _ = _padded(9, b"ACGT" if kind == "dna2" else b"ACGTN")
    ref = jse.pack_words_host(seq, kind)
    monkeypatch.setattr(se, "_pack_host", lambda padded, kind: None)
    before = se.PACKS[f"{kind}_words", "cpu"]
    got = se.pack_words(seq, kind, torch.device("cpu"))
    assert se.PACKS[f"{kind}_words", "cpu"] == before + 1
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)


def _groups_equal(got, ref):
    for key in ("perm", "head_pos", "counts", "rep"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), key)
    assert got["n_groups"] == ref["n_groups"]


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("length_first", [False, True])
def test_dedup_groups_matches_jax(monkeypatch, spill, length_first):
    """tests/test_sort_uniq.py's spill check, held against the port: the
    device path and the host lexsort (limit 1 on both sides) agree."""
    rng = np.random.default_rng(5)
    B = 2048
    words = rng.integers(0, 50, (B, 3)).astype(np.uint32)
    words[:, 0] |= np.uint32(1 << 31) * (rng.random(B) < 0.5)
    lens = rng.integers(10, 30, B).astype(np.int32)
    sumq = rng.integers(0, 3000, B).astype(np.uint32)
    if spill:
        monkeypatch.setattr(jse, "DEVICE_DEDUP_LIMIT", 1)
        monkeypatch.setattr(se, "DEVICE_DEDUP_LIMIT", 1)
    ref = jse.dedup_groups(jnp.asarray(words), jnp.asarray(lens),
                           jnp.asarray(sumq), B, length_first=length_first)
    before = se.SORTS["cpu"]
    got = se.dedup_groups(words, lens, sumq, B, torch.device("cpu"),
                          length_first=length_first)
    assert se.SORTS["cpu"] == before + (not spill)
    _groups_equal(got, ref)


def test_dedup_limit_counts_uint32_key_bytes(monkeypatch):
    """NGSTPU_DEVICE_DEDUP_LIMIT counts bytes of uint32 key words, as in
    ngstpu (words.size * 4), not of the port's int64 words; a spill never
    copies the words to the device."""
    rng = np.random.default_rng(6)
    B, W = 500, 3
    words = rng.integers(0, 9, (B, W)).astype(np.uint32)
    lens = np.full(B, 20, np.int32)
    sumq = rng.integers(0, 99, B).astype(np.uint32)
    dev = torch.device("cpu")
    monkeypatch.setattr(se, "DEVICE_DEDUP_LIMIT", B * W * 4)
    before = se.SORTS["cpu"]
    on_device = se.dedup_groups(words, lens, sumq, B, dev)
    assert se.SORTS["cpu"] == before + 1

    def no_upload(*a, **k):
        raise AssertionError("spilled words went to the device")

    monkeypatch.setattr(se, "words_tensor", no_upload)
    monkeypatch.setattr(se, "DEVICE_DEDUP_LIMIT", B * W * 4 - 1)
    spilled = se.dedup_groups(words, lens, sumq, B, dev)
    assert se.SORTS["cpu"] == before + 1
    _groups_equal(spilled, on_device)



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("packer,alphabet", [
    ("bytes_to_words", bytes(range(1, 256))), ("dna2_words", b"ACGT"),
    ("dna3_words", b".ACGNT")])
def test_device_packers_on_card(cuda, packer, alphabet):
    seq, _ = _padded(10, alphabet, B=100000,
                     L=100 if packer == "bytes_to_words" else 101)
    before = se.PACKS[packer, "cuda"]
    got = getattr(se, packer)(torch.from_numpy(seq).to(cuda))
    assert se.PACKS[packer, "cuda"] == before + 1
    want = getattr(se, packer)(torch.from_numpy(seq))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_dedup_groups_on_card(cuda):
    words, lens, sumq = _rows(11, B=300000, W=7)
    got = se.dedup_groups(words, lens, sumq, len(lens), cuda)
    want = se.dedup_groups(words, lens, sumq, len(lens), torch.device("cpu"))
    for key in ("perm", "head_pos", "counts", "rep"):
        np.testing.assert_array_equal(got[key], want[key], key)
