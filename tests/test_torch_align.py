"""ngstpu_torch.ops.align against ngstpu.ops.align on the CPU: the batched
Smith-Waterman functions give exactly ngstpu's int32 outputs (ties
included) on the same seeded inputs, and the copied numpy functions give
the same answers as ngstpu's."""

import numpy as np
import pytest
import torch

from ngstpu.ops import align as j_align
from ngstpu_torch.ops import align as t_align

SCORING2 = dict(match=2, mismatch=4, gap_open=4, gap_extend=1)


def _pad(x: np.ndarray, lens: np.ndarray) -> np.ndarray:
    x[np.arange(x.shape[1])[None, :] >= lens[:, None]] = 0
    return x


def _case(name: str):
    """(query, qlens, target, tlens, h0, scoring) of one named case."""
    scoring = {}
    if name == "random":  # tests/test_align.py's oracle shape
        rng = np.random.default_rng(4)
        B, Lq, Lt = 16, 24, 32
        q = rng.integers(65, 69, (B, Lq)).astype(np.uint8)
        t = rng.integers(65, 69, (B, Lt)).astype(np.uint8)
        qlens = rng.integers(5, Lq + 1, B).astype(np.int32)
        tlens = rng.integers(5, Lt + 1, B).astype(np.int32)
    elif name in ("planted", "scoring2"):  # test_align's kswr shape
        rng = np.random.default_rng(3)
        B, Lq, Lt = 220, 28, 36
        qlens = rng.integers(1, Lq + 1, B).astype(np.int32)
        tlens = rng.integers(1, Lt + 1, B).astype(np.int32)
        q = rng.choice(list(b"ACGT"), (B, Lq)).astype(np.uint8)
        t = rng.choice(list(b"ACGT"), (B, Lt)).astype(np.uint8)
        for i in range(0, B, 2):
            L = int(min(qlens[i], tlens[i], 12))
            t[i, :L] = q[i, :L]
            if tlens[i] >= 2 * L + 4:
                t[i, L + 4:2 * L + 4] = q[i, :L]
        if name == "scoring2":
            scoring = SCORING2
    elif name == "seeded":  # test_align's ksw_extend shape
        rng = np.random.default_rng(5)
        B, Lq, Lt = 220, 30, 34
        qlens = rng.integers(1, Lq + 1, B).astype(np.int32)
        tlens = rng.integers(1, Lt + 1, B).astype(np.int32)
        q = rng.choice(list(b"ACGT"), (B, Lq)).astype(np.uint8)
        t = rng.choice(list(b"ACGT"), (B, Lt)).astype(np.uint8)
        for i in range(0, B, 2):
            L = int(min(qlens[i], tlens[i]))
            t[i, :L] = q[i, :L]
            if L > 6:
                t[i, L // 2] = (t[i, L // 2] + 1) % 4 + 65
    elif name == "two_letter":  # a two-letter alphabet: ties everywhere
        rng = np.random.default_rng(6)
        B, Lq, Lt = 96, 20, 26
        q = rng.choice(list(b"AC"), (B, Lq)).astype(np.uint8)
        t = rng.choice(list(b"AC"), (B, Lt)).astype(np.uint8)
        qlens = rng.integers(1, Lq + 1, B).astype(np.int32)
        tlens = rng.integers(1, Lt + 1, B).astype(np.int32)
    elif name in ("short", "width1"):  # lengths 0 and 1
        rng = np.random.default_rng(7)
        B, Lq, Lt = (64, 3, 4) if name == "short" else (16, 1, 1)
        q = rng.choice(list(b"ACGT"), (B, Lq)).astype(np.uint8)
        t = rng.choice(list(b"ACGT"), (B, Lt)).astype(np.uint8)
        qlens = rng.integers(0, Lq + 1, B).astype(np.int32)
        tlens = rng.integers(0, Lt + 1, B).astype(np.int32)
        qlens[:4], tlens[:4] = (0, 0, 1, 1), (0, 1, 0, 1)
    else:
        raise ValueError(name)
    h0 = rng.integers(0, 25, B).astype(np.int32)
    return _pad(q, qlens), qlens, _pad(t, tlens), tlens, h0, scoring


CASES = ["random", "planted", "seeded", "two_letter", "short", "width1",
         "scoring2"]


def _run(fn: str, q, qlens, t, tlens, h0, scoring):
    """fn's outputs from both packages, as numpy arrays by name."""
    tq, tql, tt, ttl, th0 = map(torch.from_numpy, (q, qlens, t, tlens, h0))
    if fn == "score":
        return ({"score": j_align.sw_score_batch(q, qlens, t, tlens,
                                                 **scoring)},
                {"score": t_align.sw_score_batch(tq, tql, tt, ttl,
                                                 **scoring)})
    if fn == "align":
        return (j_align.sw_align_batch(q, qlens, t, tlens, **scoring),
                t_align.sw_align_batch(tq, tql, tt, ttl, **scoring))
    w = int(fn.removeprefix("extend"))
    names = ("score", "qle", "tle")
    return (dict(zip(names, j_align.sw_extend_batch(
                q, qlens, t, tlens, h0, w=w, **scoring))),
            dict(zip(names, t_align.sw_extend_batch(
                tq, tql, tt, ttl, th0, w=w, **scoring))))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["score", "align", "extend3", "extend100"])
def test_sw_matches_ngstpu(fn, case):
    """Every output of the port equals ngstpu's jitted function's, exactly
    and in dtype int32."""
    j_out, t_out = _run(fn, *_case(case))
    assert j_out.keys() == t_out.keys()
    for name in j_out:
        want = np.asarray(j_out[name])
        got = t_out[name].numpy()
        assert got.dtype == want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=f"{fn} {name}")


def test_sw_empty_pairs():
    """A zero-length query or target scores 0 with te = qe = -1, and an
    extension of it keeps h0 with qle = tle = 0."""
    q, qlens, t, tlens, h0, _ = _case("short")
    tq, tql, tt, ttl, th0 = map(torch.from_numpy, (q, qlens, t, tlens, h0))
    res = t_align.sw_align_batch(tq, tql, tt, ttl)
    score = t_align.sw_score_batch(tq, tql, tt, ttl)
    best, qle, tle = t_align.sw_extend_batch(tq, tql, tt, ttl, th0)
    empty = (qlens == 0) | (tlens == 0)
    assert empty[:3].all() and empty.sum() > 3
    for x in (score, res["score"]):
        assert (x.numpy()[empty] == 0).all()
    assert (res["te"].numpy()[empty] == -1).all()
    assert (res["qe"].numpy()[empty] == -1).all()
    assert (best.numpy()[empty] == h0[empty]).all()
    assert (qle.numpy()[empty] == 0).all() and (tle.numpy()[empty] == 0).all()


def _extend_cells_scalar(q: bytes, t: bytes, h0: int, w: int) -> int:
    """The cells ksw_extend_scalar's inner loop visits (default scoring)."""
    qlen = len(q)
    ge, gapoe = 2, 7
    h0 = max(h0, 0)
    eh_h = np.zeros(qlen + 2, np.int64)
    eh_e = np.zeros(qlen + 2, np.int64)
    eh_h[0] = h0
    eh_h[1] = h0 - gapoe if h0 > gapoe else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > ge:
        eh_h[j] = eh_h[j - 1] - ge
        j += 1
    w = min(w, max(int((qlen - 5) / ge + 1.0), 1))
    beg, end, cells = 0, qlen, 0
    for i in range(len(t)):
        f, h1, m, mj = 0, max(h0 - (5 + ge * (i + 1)), 0), 0, -1
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        cells += max(end - beg, 0)
        for jj in range(beg, end):
            h, e = eh_h[jj], eh_e[jj]
            eh_h[jj] = h1
            h += 1 if q[jj] == t[i] else -3
            h = max(h, e, f)
            h1 = h
            if h >= m:
                m, mj = h, jj
            h = max(h - gapoe, 0)
            eh_e[jj] = max(e - ge, h)
            f = max(f - ge, h)
        eh_h[end] = h1
        eh_e[end] = 0
        if m == 0:
            break
        jj = mj
        while jj >= beg and eh_h[jj]:
            jj -= 1
        beg = jj + 1
        jj = mj + 2
        while jj <= end and eh_h[jj]:
            jj += 1
        end = jj
    return cells


@pytest.mark.parametrize("w", [3, 100])
def test_sw_extend_cells(w):
    """`cells` adds each pair's band cells: those the scalar ksw_extend
    visits before its band closes or a zero row ends it."""
    q, qlens, t, tlens, h0, _ = _case("seeded")
    cells = torch.zeros(len(q), dtype=torch.int64)
    out = t_align.sw_extend_batch(*map(torch.from_numpy,
                                       (q, qlens, t, tlens, h0)),
                                  w=w, cells=cells)
    plain = t_align.sw_extend_batch(*map(torch.from_numpy,
                                         (q, qlens, t, tlens, h0)), w=w)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    want = [_extend_cells_scalar(bytes(q[i, :qlens[i]]),
                                 bytes(t[i, :tlens[i]]), int(h0[i]), w)
            for i in range(len(q))]
    assert cells.tolist() == want
    assert 0 < sum(want) < int((qlens.astype(np.int64) * tlens).sum())


def test_kswr_second_best_matches_ngstpu():
    """The copied second-best extraction on 400 random batches with small
    values (ties, runs and window collisions)."""
    rng = np.random.default_rng(123)
    for trial in range(400):
        B = int(rng.integers(1, 6))
        T = int(rng.integers(1, 24))
        row_max = rng.integers(0, 8, (B, T)).astype(np.int64)
        score = rng.integers(-2, 10, B).astype(np.int64)
        te = rng.integers(0, T, B).astype(np.int64)
        minsc = int(rng.integers(0, 6))
        max_match = int(rng.integers(1, 4))
        got = t_align.kswr_second_best(row_max, score, te, minsc, max_match)
        want = j_align.kswr_second_best(row_max, score, te, minsc,
                                        max_match)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"trial {trial}")


@pytest.mark.parametrize("oracle", ["ksw_align_scalar", "ksw_extend_scalar",
                                    "sw_score_numpy"])
def test_scalar_oracles_match_ngstpu(oracle):
    """The copied scalar oracles on 60 random pairs (two scorings)."""
    rng = np.random.default_rng(11)
    for trial in range(60):
        q = bytes(rng.choice(list(b"ACGT"), int(rng.integers(0, 14))))
        t = bytes(rng.choice(list(b"ACGT"), int(rng.integers(0, 18))))
        if trial % 2 and q:
            t = t[:3] + q[1:] + t[3:]
        scoring = SCORING2 if trial % 3 == 0 else {}
        args = (q, t)
        if oracle == "ksw_extend_scalar":
            args += (int(rng.integers(0, 20)), int(rng.integers(1, 8)))
        elif oracle == "ksw_align_scalar":
            scoring = {**scoring, "minsc": int(rng.integers(1, 6))}
        got = getattr(t_align, oracle)(*args, **scoring)
        want = getattr(j_align, oracle)(*args, **scoring)
        if isinstance(want, dict):
            row_max = want.pop("row_max")
            np.testing.assert_array_equal(got.pop("row_max"), row_max)
        assert got == want, (trial, got, want)
