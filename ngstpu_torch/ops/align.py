"""Batched Smith-Waterman local alignment on torch tensors.

The port of ngstpu/ops/align.py. Each of ngstpu's three `lax.scan`
programs becomes a Python loop over the scanned axis whose body is a
fixed chain of torch ops on [B, L] int32 lanes: no host sync and no
data-dependent branch inside the loop, so a batch is a fixed sequence of
launches, as the scan was one program. The scan's
`associative_scan(jnp.maximum)` along a row is `torch.cummax`. All
arithmetic is exact int32, as in ngstpu, and every tie-break follows
ngstpu's (first or last index by an index min/max, never an argmax over
booleans). The scoring parameters are Python ints, as ngstpu's static
arguments are.

Scoring: match/mismatch constants (a, -b) like ksw_sse2's common use, gap
open/extend (q, r) with affine semantics E = max(H - q - r, E - r).

`kswr_second_best` and the scalar oracles (`ksw_align_scalar`,
`ksw_extend_scalar`, `sw_score_numpy`) are numpy, copied from ngstpu.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tf

NEG = -10_000
I32 = torch.int32


def _sub(a: torch.Tensor, b: torch.Tensor, match: int,
         mismatch: int) -> torch.Tensor:
    """int32 match / -mismatch where a == b."""
    return (a == b).to(I32) * (match + mismatch) - mismatch


def sw_score_batch(query: torch.Tensor, qlens: torch.Tensor,
                   target: torch.Tensor, tlens: torch.Tensor, match: int = 1,
                   mismatch: int = 3, gap_open: int = 5,
                   gap_extend: int = 2) -> torch.Tensor:
    """query uint8 [B, Lq], target uint8 [B, Lt] (zero-padded), int32
    lengths [B], all on one device -> int32 [B] there.

    Local (Smith-Waterman) score with affine gaps; padding positions are
    masked out of the recurrence. Loops over query rows with [B, Lt]
    lanes."""
    B, Lq = query.shape
    Lt = target.shape[1]
    dev = target.device
    idx = torch.arange(Lt, dtype=I32, device=dev)
    tmask = idx[None, :] < tlens[:, None]
    H = torch.zeros((B, Lt), dtype=I32, device=dev)
    E = torch.full((B, Lt), NEG, dtype=I32, device=dev)
    best = torch.zeros(B, dtype=I32, device=dev)
    for i in range(Lq):
        active = (qlens > i)[:, None]
        sub = torch.where(tmask, _sub(target, query[:, i:i + 1], match,
                                      mismatch), NEG)
        # H_diag for column j is H_prev[j-1]; column 0's diagonal is 0
        H_diag = tf.pad(H[:, :-1], (1, 0))
        E = torch.maximum(H - gap_open - gap_extend, E - gap_extend)
        h_with_e = torch.maximum((H_diag + sub).clamp_min(0), E)
        # F[j] = max_k<=j (h_with_e[k] - gap_open - (j-k)*gap_extend) as a
        # running max of g + j*ge, shifted one column
        run = torch.cummax(h_with_e - gap_open + idx * gap_extend,
                           dim=1).values
        F = tf.pad((run - idx * gap_extend)[:, :-1] - gap_extend, (1, 0),
                   value=NEG)
        H = torch.where(active & tmask, torch.maximum(h_with_e, F), 0)
        best = torch.maximum(best, H.amax(1))
        E = torch.where(active, E, NEG)
    return best


def sw_align_batch(query: torch.Tensor, qlens: torch.Tensor,
                   target: torch.Tensor, tlens: torch.Tensor, match: int = 1,
                   mismatch: int = 3, gap_open: int = 5,
                   gap_extend: int = 2) -> dict:
    """Full ksw_align surface, batched: best score + END POSITIONS.

    Walks TARGET rows with query positions as lanes (ksw's orientation,
    reference klib/ksw.h:63, ksw.c ksw_i16). Returns a dict of tensors on
    the inputs' device:
      score   int32 [B]  best local score
      te      int32 [B]  END position on the target: FIRST row attaining
                         the global max (ksw's strict `imax > gmax`)
      qe      int32 [B]  END position on the query at that row: first
                         query position attaining the row max in natural
                         order (ksw's striped order is not reproduced)
      row_max int32 [B, Lt] per-target-row maxima, the input to
                         kswr_second_best.
    Empty/padded rows and lanes are masked; scores are exact int32."""
    B, Lq = query.shape
    Lt = target.shape[1]
    dev = query.device
    idxq = torch.arange(Lq, dtype=I32, device=dev)
    qmask = idxq[None, :] < qlens[:, None]
    Hd = torch.zeros((B, Lq), dtype=I32, device=dev)
    E = torch.zeros_like(Hd)
    Hmax = torch.zeros_like(Hd)
    gmax = torch.zeros(B, dtype=I32, device=dev)
    te = torch.full((B,), -1, dtype=I32, device=dev)
    row_max = []
    for i in range(Lt):
        valid = tlens > i
        active = valid[:, None]
        sub = torch.where(qmask, _sub(query, target[:, i:i + 1], match,
                                      mismatch), NEG)
        h_noF = torch.maximum(tf.pad(Hd[:, :-1], (1, 0)) + sub,
                              E).clamp_min(0)
        # F(j) = max_{k<j} (g(k) - (j-1-k)*gape), g = max(H-gapoe, 0)
        g = (h_noF - gap_open - gap_extend).clamp_min(0)
        run = torch.cummax(g + idxq * gap_extend, dim=1).values
        F = tf.pad(run[:, :-1] - idxq[1:] * gap_extend + gap_extend, (1, 0))
        H = torch.maximum(h_noF, F.clamp_min(0))
        H = torch.where(qmask & active, H, 0)
        E2 = torch.maximum(H - gap_open - gap_extend,
                           E - gap_extend).clamp_min(0)
        E = torch.where(active, E2, E)
        Hd = torch.where(active, H, Hd)
        m_i = H.amax(1)
        better = (m_i > gmax) & valid
        gmax = torch.where(better, m_i, gmax)
        te = torch.where(better, i, te)
        Hmax = torch.where(better[:, None], H, Hmax)
        row_max.append(torch.where(valid, m_i, 0))
    first = torch.where(Hmax == gmax[:, None], idxq, Lq).amin(1)
    qe = torch.where(gmax > 0, first, -1).to(I32)
    return dict(score=gmax, te=te, qe=qe, row_max=torch.stack(row_max, 1))


def kswr_second_best(row_max: np.ndarray, score: np.ndarray, te: np.ndarray,
                     minsc: int, max_match: int):
    """Second-best score/end from per-row maxima — the KSW_XSUBO b-array
    logic of ksw.c: rows with row-max >= minsc compress into contiguous
    runs keeping each run's first strict maximum; the second best is the
    best entry whose target end falls outside te ± ceil(score/max_match)
    (ksw.c end of ksw_u8/ksw_i16). Returns (score2, te2) int arrays, -1
    where unset.

    Vectorized across the batch: one numpy pass over the T target rows.
    The C "b array" compresses to chains — a qualifying row starts a chain
    when the previous row was not the chain's stored max, and extends it
    only by strict improvement (the stored-row contiguity quirk of the
    reference code means a non-improving row is DISCARDED and breaks the
    chain) — so each chain's final (max, row) is the only entry the window
    filter ever sees, finalized here the moment the chain dies."""
    B, T = row_max.shape
    rm = row_max.astype(np.int64)
    keep = rm >= minsc
    sc = score.astype(np.int64)
    w = (sc + max_match - 1) // max_match
    low = te.astype(np.int64) - w
    high = te.astype(np.int64) + w
    score2 = np.full(B, -1, np.int64)
    te2 = np.full(B, -1, np.int64)
    alive = np.zeros(B, bool)
    cur_max = np.zeros(B, np.int64)
    eligible = sc > 0

    def finalize(dies, last_row):
        sel = (dies & eligible & ((last_row < low) | (last_row > high))
               & (cur_max > score2))
        score2[sel] = cur_max[sel]
        te2[sel] = last_row

    for i in range(T):
        m = rm[:, i]
        improves = alive & keep[:, i] & (m > cur_max)
        starts = ~alive & keep[:, i]
        dies = alive & ~improves
        finalize(dies, i - 1)
        upd = improves | starts
        cur_max = np.where(upd, m, cur_max)
        alive = upd
    finalize(alive, T - 1)
    none = eligible & (score2 < 0)
    score2[none] = 0  # kswr default score2=0 when tracking found none
    return score2, te2


def sw_extend_batch(query: torch.Tensor, qlens: torch.Tensor,
                    target: torch.Tensor, tlens: torch.Tensor,
                    h0: torch.Tensor, w: int = 100, match: int = 1,
                    mismatch: int = 3, gap_open: int = 5,
                    gap_extend: int = 2, *,
                    cells: torch.Tensor | None = None):
    """Batched ksw_extend: banded seed-extension from an anchor scored h0
    (reference klib/ksw.h:65, ksw.c ksw_extend). Per pair returns int32
    (score, qle, tle) on the inputs' device: the best extension score
    (>= h0) and the one-past-end query/target lengths of the extension (0
    when nothing beats h0).

    Replicates the C semantics as a loop over target rows with the
    adaptive band carried as [beg, end) per pair: row-max ties keep the
    LATER query column (mj), the global max keeps the EARLIEST row
    (strict >), a zero row max terminates the extension, and the band
    narrows to the nonzero H run around mj.

    `cells`, when given, is an int64 [B] tensor on the device into which
    each pair's band cells are added: the cells a scalar ksw_extend
    computes for these inputs (the work the bound of a measurement
    counts)."""
    B, Lq = query.shape
    Lt = target.shape[1]
    dev = query.device
    gapoe = gap_open + gap_extend
    qlens = qlens.to(I32)
    h0 = h0.to(I32)
    # band width clamp (ksw_extend "adjust $w"): per-pair max_gap, divided
    # in float32 and truncated toward zero as ngstpu does
    max_gap = ((qlens * match - gap_open).to(torch.float32) / gap_extend
               + 1.0).to(I32)
    w_eff = max_gap.clamp_min(1).clamp_max(w)

    jidx = torch.arange(Lq + 1, dtype=I32, device=dev)[None, :]
    lane = jidx[:, :-1]  # query columns 0..Lq-1
    # first row: A[0]=h0, A[1]=max(h0-gapoe,0), then -gape chain while the
    # previous value > gape (ksw_extend "fill the first row")
    m1 = (h0 - gapoe).clamp_min(0)[:, None]
    chain = m1 - (jidx - 1) * gap_extend
    prev_ok = (m1 - (jidx - 2) * gap_extend) > gap_extend
    A = torch.where(jidx == 0, h0[:, None],
                    torch.where(jidx == 1, m1,
                                torch.where(prev_ok, chain, 0)))
    E = torch.zeros((B, Lq + 1), dtype=I32, device=dev)
    beg = torch.zeros(B, dtype=I32, device=dev)
    end = qlens
    best = h0
    bi = torch.full((B,), -1, dtype=I32, device=dev)
    bj = torch.full((B,), -1, dtype=I32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    for i in range(Lt):
        in_t = (tlens > i) & alive
        beg_i = torch.maximum(beg, i - w_eff)
        end_i = torch.minimum(torch.minimum(end, i + w_eff + 1), qlens)
        h1 = (h0 - (gap_open + gap_extend * (i + 1))).clamp_min(0)
        inb = (lane >= beg_i[:, None]) & (lane < end_i[:, None])
        if cells is not None:
            cells += (inb & in_t[:, None]).sum(1)
        sub = _sub(query, target[:, i:i + 1], match, mismatch)
        h_noF = torch.where(inb, torch.maximum(A[:, :-1] + sub, E[:, :-1]),
                            NEG)
        # F(beg)=0; F(j+1) = max(F(j)-gape, max(H(j)-gapoe, 0)): the g>=0
        # terms dominate the zero seed, so one max-scan over in-band g
        # (out-of-band forced NEG) reproduces the row recurrence exactly
        g = torch.where(inb, (h_noF - gapoe).clamp_min(0), NEG)
        run = torch.cummax(g + lane * gap_extend, dim=1).values
        # F(j) = max_{k<j} (g(k) - (j-1-k)*gape)  [zero seed dominated]
        F = tf.pad(run[:, :-1] - lane[:, 1:] * gap_extend + gap_extend,
                   (1, 0), value=NEG)
        F = torch.where(lane == beg_i[:, None], 0, F)
        H = torch.where(inb, torch.maximum(h_noF, F), 0)
        # row max, ties keep the LATER column (ksw_extend `mj = m>h?mj:j`)
        m = H.amax(1)
        last = torch.where(H == m[:, None], lane, -1).amax(1)
        mj = torch.where(m > 0, last, -1)
        # E(i+1,j) = max(E-gape, max(H-gapoe,0)); only inside the band;
        # eh[end].e = 0
        E2 = torch.cat([torch.where(
            inb, torch.maximum(E[:, :-1] - gap_extend,
                               (H - gapoe).clamp_min(0)), E[:, :-1]),
            E[:, -1:]], 1)
        E2 = torch.where(jidx == end_i[:, None], 0, E2)
        # A'[j] = H(i, j-1) for j in [beg, end]; A[beg] = h1
        upd = (jidx >= beg_i[:, None]) & (jidx <= end_i[:, None])
        A2 = torch.where(upd, tf.pad(H, (1, 0)), A)
        A2 = torch.where(jidx == beg_i[:, None], h1[:, None], A2)
        # band update off the NEW A (= H(i, j-1)): beg' = 1 + last zero in
        # [beg, mj] (else beg); end' = first zero in [mj+2, end] (else end+1)
        zer = A2 == 0
        in_lo = (jidx >= beg_i[:, None]) & (jidx <= mj[:, None])
        lzmax = torch.where(zer & in_lo, jidx, -1).amax(1)
        beg2 = torch.where(lzmax >= 0, lzmax + 1, beg_i)
        in_hi = (jidx >= mj[:, None] + 2) & (jidx <= end_i[:, None])
        hzmin = torch.where(zer & in_hi, jidx, Lq + 2).amin(1)
        end2 = torch.where(hzmin <= Lq + 1, hzmin, end_i + 1)
        # global best: strict >, earliest row; zero row max ends extension
        better = (m > best) & in_t
        best = torch.where(better, m, best)
        bi = torch.where(better, i, bi)
        bj = torch.where(better, mj, bj)
        alive = alive & (m > 0) & (tlens > i) | (alive & (tlens <= i))
        keep = in_t[:, None]
        A = torch.where(keep, A2, A)
        E = torch.where(keep, E2, E)
        beg = torch.where(in_t, beg2, beg)
        end = torch.where(in_t, end2, end)
    return best, bj + 1, bi + 1


def ksw_align_scalar(q: bytes, t: bytes, match=1, mismatch=3, gap_open=5,
                     gap_extend=2, minsc=0x10000):
    """Scalar oracle for sw_align_batch: exact-int local SW over target
    rows with ksw's update order (ksw.c ksw_u8/ksw_i16 semantics — H/E/F
    floored at 0 like the saturating lanes, te = first row attaining the
    global max, qe = first in-row max in natural query order, and the
    KSW_XSUBO b-array second-best). Returns a dict of kswr_t fields."""
    Lq, Lt = len(q), len(t)
    gapoe = gap_open + gap_extend
    Hd = np.zeros(Lq, np.int64)
    E = np.zeros(Lq, np.int64)
    gmax, te, Hmax = 0, -1, np.zeros(Lq, np.int64)
    row_max = np.zeros(Lt, np.int64)
    for i in range(Lt):
        H = np.zeros(Lq, np.int64)
        f = 0
        for j in range(Lq):
            sub = match if q[j] == t[i] else -mismatch
            hd = Hd[j - 1] if j else 0
            h = max(hd + sub, E[j], f, 0)
            H[j] = h
            hp = max(h - gapoe, 0)
            E[j] = max(E[j] - gap_extend, hp, 0)
            f = max(f - gap_extend, hp, 0)
        Hd = H
        m = int(H.max()) if Lq else 0
        row_max[i] = m
        if m > gmax:
            gmax, te, Hmax = m, i, H.copy()
    qe = int(np.argmax(Hmax == gmax)) if gmax > 0 else -1
    score2, te2 = kswr_second_best(row_max[None, :], np.array([gmax]),
                                   np.array([te]), minsc, match)
    return dict(score=gmax, te=te, qe=qe, score2=int(score2[0]),
                te2=int(te2[0]), row_max=row_max)


def ksw_extend_scalar(q: bytes, t: bytes, h0: int, w: int = 100, match=1,
                      mismatch=3, gap_open=5, gap_extend=2):
    """Scalar oracle for sw_extend_batch: a direct port of ksw_extend
    (reference klib/ksw.c:362-434) — banded, adaptive [beg,end), row-max
    ties keep the later column, zero row max terminates. TEST ORACLE ONLY.
    Returns (score, qle, tle)."""
    qlen, tlen = len(q), len(t)
    gapoe = gap_open + gap_extend
    h0 = max(h0, 0)
    eh_h = np.zeros(qlen + 2, np.int64)
    eh_e = np.zeros(qlen + 2, np.int64)
    eh_h[0] = h0
    eh_h[1] = h0 - gapoe if h0 > gapoe else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > gap_extend:
        eh_h[j] = eh_h[j - 1] - gap_extend
        j += 1
    max_gap = int((qlen * match - gap_open) / gap_extend + 1.0)
    max_gap = max(max_gap, 1)
    w = min(w, max_gap)
    best, max_i, max_j = h0, -1, -1
    beg, end = 0, qlen
    for i in range(tlen):
        f, h1, m, mj = 0, max(h0 - (gap_open + gap_extend * (i + 1)), 0), 0, -1
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        for jj in range(beg, end):
            h, e = eh_h[jj], eh_e[jj]
            eh_h[jj] = h1
            h += match if q[jj] == t[i] else -mismatch
            h = max(h, e, f)
            h1 = h
            if h >= m:
                m, mj = h, jj
            h = max(h - gapoe, 0)
            e = max(e - gap_extend, h)
            eh_e[jj] = e
            f = max(f - gap_extend, h)
        eh_h[end] = h1
        eh_e[end] = 0
        if m == 0:
            break
        if m > best:
            best, max_i, max_j = m, i, mj
        jj = mj
        while jj >= beg and eh_h[jj]:
            jj -= 1
        beg = jj + 1
        jj = mj + 2
        while jj <= end and eh_h[jj]:
            jj += 1
        end = jj
    return best, max_j + 1, max_i + 1


def sw_score_numpy(q: bytes, t: bytes, match=1, mismatch=3, gap_open=5,
                   gap_extend=2) -> int:
    """Reference DP oracle (O(Lq*Lt) scalar)."""
    Lq, Lt = len(q), len(t)
    H = np.zeros((Lq + 1, Lt + 1), dtype=np.int64)
    E = np.full((Lq + 1, Lt + 1), NEG, dtype=np.int64)
    F = np.full((Lq + 1, Lt + 1), NEG, dtype=np.int64)
    best = 0
    for i in range(1, Lq + 1):
        for j in range(1, Lt + 1):
            E[i, j] = max(H[i - 1, j] - gap_open - gap_extend,
                          E[i - 1, j] - gap_extend)
            F[i, j] = max(H[i, j - 1] - gap_open - gap_extend,
                          F[i, j - 1] - gap_extend)
            s = match if q[i - 1] == t[j - 1] else -mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            best = max(best, H[i, j])
    return int(best)
