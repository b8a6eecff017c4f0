"""Vectorized cigar walking + sparse pileup sweep.

The reference walks cigars record-by-record inserting M-block start/end
positions into hash tables (reference bam2depth.c:86-110), then sweeps the
sorted key union with a running depth (bam2depth.c:203-236). Here:

- cigar -> events: one numpy pass over the flattened cigar arrays computes
  per-op reference offsets by segmented exclusive cumsum; M-op block
  [start, end) events fall out as flat arrays (no per-record loop).
- events -> intervals: a device sort + cumsum (torch ops on an explicit
  device, sparse_pileup_sweep) or the native host radix sweep produces
  depth breakpoints; equal-depth neighbors merge exactly like the C
  sweep's `last_depth==Count` branch.

Advance set per the C walk: M(0), D(2), N(3) advance the reference
cursor; I/S/H/P/=/X do not (bam2depth.c:94-107 — note =/X are ignored
entirely, a reference quirk we preserve).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

BAM_CMATCH, BAM_CINS, BAM_CDEL, BAM_CREF_SKIP = 0, 1, 2, 3

# device sweeps per (op, device type): chip_smoke.py reads it to show that
# the card did the work
PILEUP: collections.Counter = collections.Counter()


def cigar_m_events(cols, rec_mask: np.ndarray):
    """Flat M-block events for records where rec_mask is True.

    Returns (tid[E], start[E], end[E]) int32/int64 numpy arrays.
    """
    R = cols.n
    if R == 0 or len(cols.cigar_op) == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    rec_id = np.repeat(np.arange(R, dtype=np.int64), cols.n_cigar)
    op = cols.cigar_op
    ln = cols.cigar_len.astype(np.int64)
    advances = (op == BAM_CMATCH) | (op == BAM_CDEL) | (op == BAM_CREF_SKIP)
    adv_len = np.where(advances, ln, 0)
    csum = np.cumsum(adv_len)
    excl = csum - adv_len
    base = excl[cols.cigar_offset.astype(np.int64)]  # per record
    off_in_rec = excl - base[rec_id]

    is_block = (op == BAM_CMATCH) & rec_mask[rec_id]
    starts = (cols.pos[rec_id].astype(np.int64) + off_in_rec)[is_block]
    ends = starts + ln[is_block]
    tids = cols.tid[rec_id][is_block]
    return tids.astype(np.int32), starts.astype(np.int32), ends.astype(np.int32)


def stream_chrom_events(path: str, flag_mask: int,
                        chunk_bytes: int = 32 << 20):
    """Bounded-memory per-chromosome pileup events from a BAM.

    Returns (header, generator of (pos, delta) int32 array pairs, one per
    reference in header order). The BAM decodes in O(chunk) batches
    (io.bam.BamStream); records failing `flag & flag_mask == 0` or with
    tid < 0 are skipped (the bam2depth/bam2wig filters, reference
    bam2depth.c:90 / bam2wig.c:88). Coordinate-grouped inputs release each
    chromosome's events as soon as the stream moves past its tid — the
    per-chromosome working set of the reference's bam_fetch loop
    (bam2depth.c:325-339) without requiring an index; inputs with
    interleaved tids fall back to accumulating until EOF (same outputs).
    """
    from ..io.bam import BamStream

    stream = BamStream(path, chunk_bytes)
    header = stream.header
    n_refs = header.n_refs

    def gen():
        pending: dict[int, list] = {}
        emitted = 0  # next tid to yield
        monotone = True
        last_tid = -1
        empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))

        def flush(t):
            pieces = pending.pop(t, None)
            if not pieces:
                return empty
            pos = np.concatenate([p for p, _ in pieces])
            delta = np.concatenate([d for _, d in pieces])
            return pos, delta

        for cols in stream:
            # tid outside the header is skipped INCLUDING the monotone
            # tracking (like the native scanners): one corrupt huge tid
            # must not poison last_tid and flush later chromosomes early
            mask = ((cols.flag & flag_mask) == 0) & (cols.tid >= 0) \
                & (cols.tid < n_refs)
            tids, starts, ends = cigar_m_events(cols, mask)
            if len(tids):
                order = np.argsort(tids, kind="stable")
                st = tids[order]
                sp = np.concatenate([starts[order], ends[order]])
                sd = np.concatenate([np.ones(len(st), np.int32),
                                     -np.ones(len(st), np.int32)])
                bounds = np.searchsorted(st, np.arange(st[0], st[-1] + 2))
                for i, t in enumerate(range(int(st[0]), int(st[-1]) + 1)):
                    lo, hi = int(bounds[i]), int(bounds[i + 1])
                    if lo == hi:
                        continue
                    idx = np.concatenate([np.arange(lo, hi),
                                          len(st) + np.arange(lo, hi)])
                    pending.setdefault(t, []).append((sp[idx], sd[idx]))
                bt = cols.tid[mask]
                if monotone and len(bt):
                    if bt[0] < last_tid or (np.diff(bt) < 0).any():
                        monotone = False
                    else:
                        last_tid = int(bt[-1])
            if monotone:
                while emitted < last_tid and emitted < n_refs:
                    yield flush(emitted)
                    emitted += 1
        for t in range(emitted, n_refs):
            yield flush(t)

    return header, gen()


def ref_span(cols) -> np.ndarray:
    """Per-record reference span (bam_calend - pos): sum of M/D/N/=/X op
    lengths (samtools bam.h bam_calend semantics)."""
    R = cols.n
    if R == 0:
        return np.zeros(0, np.int64)
    op = cols.cigar_op
    ln = cols.cigar_len.astype(np.int64)
    consumes = ((op == 0) | (op == 2) | (op == 3) | (op == 7) | (op == 8))
    w = np.where(consumes, ln, 0)
    csum = np.concatenate([[0], np.cumsum(w)])
    lo = cols.cigar_offset.astype(np.int64)
    hi = lo + cols.n_cigar.astype(np.int64)
    return csum[hi] - csum[lo]


def parse_region(header, region: str) -> tuple[int, int, int]:
    """samtools bam_parse_region: "chr", "chr:beg", "chr:beg-end"
    (1-based inclusive input -> 0-based half-open)."""
    name, _, rest = region.partition(":")
    try:
        ref = header.ref_names.index(name)
    except ValueError:
        return -1, 0, 0
    beg, end = 0, 1 << 29
    if rest:
        b, _, e = rest.partition("-")
        if b:
            beg = max(int(b.replace(",", "")) - 1, 0)
        if e:
            end = int(e.replace(",", ""))
    return ref, beg, end


def region_mask(cols, ref: int, beg: int, end: int) -> np.ndarray:
    """Records a bam_fetch over [beg,end) of `ref` would visit: overlap by
    alignment span."""
    spans = ref_span(cols)
    endpos = cols.pos.astype(np.int64) + np.maximum(spans, 1)
    return (cols.tid == ref) & (cols.pos < end) & (endpos > beg)


def sparse_pileup_sweep(pos: torch.Tensor, delta: torch.Tensor,
                        n_valid: int):
    """Sort events and return per-event (sorted_pos, cumulative_depth,
    is_group_last) — host code compresses to merged intervals.

    pos int32 [E], delta int32 [E], both on the device the sweep runs on;
    invalid rows (>= n_valid) are pushed to the end with a sentinel
    position and excluded. The sort need not be stable: only the
    cumulative depth at each position's last row leaves the caller, and
    it does not depend on the order within a position.
    """
    E = pos.shape[0]
    valid = torch.arange(E, device=pos.device) < n_valid
    key = torch.where(valid, pos, torch.full_like(pos, 0x7FFFFFFF))
    s_pos, order = torch.sort(key)
    s_valid = valid[order]
    cum = torch.cumsum(torch.where(s_valid, delta[order], 0), 0,
                       dtype=torch.int32)
    nxt = torch.cat([s_pos[1:], torch.full_like(s_pos[:1], -1)])
    is_last = (s_pos != nxt) & s_valid
    PILEUP["sparse_pileup_sweep", pos.device.type] += 1
    return s_pos, cum, is_last


def merged_intervals(pos: np.ndarray, delta: np.ndarray,
                     placement: str | None = None,
                     device: str | torch.device = "cuda"):
    """Host wrapper: events -> (starts, ends, depths) of maximal
    constant-depth intervals with depth > 0 (the bedGraph rows).
    placement='host' pins the sweep to the native radix path (the
    event-mode WGS pipeline, where shipping tens of MB of events to a
    device over a thin link can never beat a sub-second host sort); any
    other verdict sweeps on `device`."""
    if len(pos) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    n = len(pos)
    u_pos = u_depth = None
    # placement: on a thin host<->device link the event round-trip costs
    # more than a host sort+sweep (utils/linkprobe). A known host verdict
    # applies at ANY size (small transfers are RTT-dominated on a tunnel);
    # with no verdict yet, big inputs probe and small ones try the device
    # (the realized pull bandwidth below then votes via note_transfer).
    from ..utils.linkprobe import link_verdict, note_transfer, probe_link

    verdict = placement or link_verdict()
    if verdict is None and pos.nbytes >= (8 << 20):
        verdict = probe_link(pos)
    if verdict == "host":
        from ..io.native import get_lib

        lib = get_lib()
        if lib is not None:
            u_pos = np.empty(n, np.int64)
            u_depth = np.empty(n, np.int64)
            k = lib.ngs_pileup_sweep(
                np.ascontiguousarray(pos, np.int32),
                np.ascontiguousarray(delta, np.int32),
                n, u_pos, u_depth, 0)
            u_pos, u_depth = u_pos[:k], u_depth[:k]
    if u_pos is None:
        # no power-of-two padding of the event count (the JAX package
        # pads only to bound XLA recompiles): n_valid = n
        dev = torch.device(device)
        s_pos, cum, is_last = sparse_pileup_sweep(
            torch.from_numpy(np.ascontiguousarray(pos, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(delta, np.int32)).to(dev),
            n)
        # the vote times the pull alone: the sweep has finished before
        # the clock starts
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        s_pos, cum, is_last = (s_pos.cpu().numpy(), cum.cpu().numpy(),
                               is_last.cpu().numpy())
        note_transfer(s_pos.nbytes + cum.nbytes + is_last.nbytes,
                      time.monotonic() - t0)
        u_pos = s_pos[is_last].astype(np.int64)
        u_depth = cum[is_last].astype(np.int64)
    return _intervals_from_sweep(u_pos, u_depth)


def _intervals_from_sweep(u_pos: np.ndarray, u_depth: np.ndarray):
    """(unique position, cumulative depth) rows -> merged bedGraph
    intervals with depth > 0."""
    if len(u_pos) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    # boundaries where depth changes (baseline 0 before the first key)
    prev = np.concatenate([[0], u_depth[:-1]])
    keep = u_depth != prev
    b_pos = u_pos[keep]
    b_depth = u_depth[keep]
    if len(b_pos) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    starts = b_pos[:-1]
    ends = b_pos[1:]
    depths = b_depth[:-1]
    nz = depths > 0
    return starts[nz], ends[nz], depths[nz]


def merged_intervals_runs(pos: np.ndarray, delta: np.ndarray,
                          placement: str | None = None,
                          device: str | torch.device = "cuda"):
    """merged_intervals for events in the stream_pileup_events flush
    layout ([all starts | all ends], delta [+1... | -1...]): the native
    split sweep (ngs_pileup_sweep_se) peels the mostly-ascending starts
    of a coordinate-sorted BAM into a monotone main stream, radix-sorts
    only the small multi-M-run remainder plus the ends, and 3-way merges
    — roughly halving the generic sweep's sort work (any starts order is
    handled; a layout violation falls back with identical output)."""
    n = len(pos)
    ns = n // 2
    if placement == "host" and n and ns * 2 == n:
        from ..io.native import get_lib

        lib = get_lib()
        starts, ends = pos[:ns], pos[ns:]
        if (lib is not None and (delta[:ns] == 1).all()
                and (delta[ns:] == -1).all()):
            u_pos = np.empty(n, np.int64)
            u_depth = np.empty(n, np.int64)
            k = lib.ngs_pileup_sweep_se(
                np.ascontiguousarray(starts, np.int32),
                np.ascontiguousarray(ends, np.int32), ns, u_pos, u_depth, 0)
            return _intervals_from_sweep(u_pos[:k], u_depth[:k])
    return merged_intervals(pos, delta, placement, device)


_EMIT_ROTATE = [0]


def pileup_emit_runs(pos: np.ndarray, delta: np.ndarray, name: bytes,
                     window: int, n_windows: int
                     ) -> tuple[memoryview, np.ndarray] | None:
    """Fully fused event-mode bam2depth emitter: one native pass
    (ngs_pileup_emit_se) produces the merged bedGraph row bytes AND the
    exact depth_window_bins — equivalent to merged_intervals_runs +
    format_int3_rows + depth_window_bins but with no (u_pos, u_depth)
    intermediates or numpy interval passes (the python chain round-trips
    hundreds of MB through memory on a WGS run). Requires the
    stream_pileup_events flush layout ([all starts | all ends]); returns
    None when the native lib is absent or the layout doesn't hold
    (callers fall back to the unfused chain with identical output)."""
    from ..io.native import get_lib

    n = len(pos)
    ns = n // 2
    if n == 0:
        return b"", np.zeros(n_windows, np.float64)
    if ns * 2 != n:
        return None
    lib = get_lib()
    if lib is None or not ((delta[:ns] == 1).all()
                           and (delta[ns:] == -1).all()):
        return None
    from ..utils.bufpool import get_buffer

    bins = np.zeros(n_windows + 2, np.float64)
    cap = (n + 2) * (len(name) + 70)
    # pooled 3-rotation text buffer, returned as a ZERO-COPY view: a
    # fresh ~20MB allocation + .tobytes() copy per chromosome cost
    # ~0.3-0.5 core-seconds of fault+memcpy noise per WGS run. CONTRACT:
    # the view is valid until the THIRD following call — the bam2depth
    # emit loop (even through its 1-deep prefetch) writes each
    # chromosome's rows before pulling two more.
    slot = _EMIT_ROTATE[0]
    _EMIT_ROTATE[0] = (slot + 1) % 3
    text = get_buffer(f"bamops.emit{slot}", cap)
    w = lib.ngs_pileup_emit_se(
        np.ascontiguousarray(pos[:ns], np.int32),
        np.ascontiguousarray(pos[ns:], np.int32), ns,
        np.frombuffer(name, np.uint8), len(name), window, bins, n_windows,
        text, cap, 0)
    if w < 0:  # cap bound above is a proof; defensive only
        raise ValueError("pileup emit buffer overflow")
    import os

    if os.environ.get("NGSTPU_DEBUG_POOLVIEWS"):
        # debug mode: hand back an owned copy so a consumer that holds a
        # view past the 3-slot rotation window reads CORRECT data while
        # the default zero-copy mode is being bisected (the rotation
        # contract is enforced only by comments)
        return bytes(text[:w]), bins[:n_windows]
    return text[:w].data, bins[:n_windows]


def depth_window_bins(starts, ends, depths, window: int,
                      n_windows: int, target_len: int) -> np.ndarray:
    """bam2depth window bins: clean depth*bp overlap per window
    (bam2depth.c:132-176 reduces to exact interval/window overlap)."""
    bins = np.zeros(n_windows + 2, dtype=np.float64)
    if len(starts) == 0:
        return bins[:n_windows]
    W = window
    ls, le, d = starts.astype(np.int64), ends.astype(np.int64), depths.astype(np.float64)
    fw = ls // W
    lw = np.maximum((le - 1) // W, fw)
    np.clip(fw, 0, n_windows + 1, out=fw)
    np.clip(lw, 0, n_windows + 1, out=lw)
    single = fw == lw
    # first window overlap
    first_end = np.minimum(le, (fw + 1) * W)
    np.add.at(bins, fw, (first_end - ls) * d)
    # last window overlap (distinct from first)
    multi = ~single
    np.add.at(bins, lw[multi], (le[multi] - lw[multi] * W) * d[multi])
    # full middle windows via diff-array
    mid = multi & (lw > fw + 1)
    diff = np.zeros(n_windows + 3, dtype=np.float64)
    np.add.at(diff, fw[mid] + 1, W * d[mid])
    np.add.at(diff, lw[mid], -W * d[mid])
    bins += np.cumsum(diff)[:n_windows + 2]
    return bins[:n_windows]


def wig_window_bins_exact(starts, ends, depths, window: int,
                          n_windows: int, target_len: int) -> np.ndarray:
    """Direct port of bam2wig.c:130-175 overlap() — TEST ORACLE ONLY
    (production uses the vectorized wig_window_bins, fuzz-proven equal on
    the sorted non-overlapping intervals the bedGraph sweep emits).

    Processes printed intervals in ascending order with the same window
    cursor + rewind mechanism, including the off-by-one quirks.
    """
    bins = np.zeros(n_windows + 2, dtype=np.float64)
    j = 0
    subject_count = 0
    W = window
    for ls, le, d in zip(starts.tolist(), ends.tolist(), depths.tolist()):
        if subject_count > 1:
            j = j - subject_count if j - subject_count >= 0 else 0
        subject_count = 0
        while j <= n_windows:
            ws = W * j
            we = (j + 1) * W - 1
            if we > target_len:
                we = target_len
            if le < ws:
                break
            if ls < ws:
                if le < we:
                    bins[j] += (le - ws) * d
                    subject_count += 1
                    break
                else:
                    bins[j] += (we - ws + 1) * d
                    j += 1
                    subject_count += 1
            else:
                if ls <= we:
                    if le <= we:
                        bins[j] += (le - ls) * d
                        subject_count += 1
                        break
                    else:
                        bins[j] += (we - ls) * d
                        j += 1
                        subject_count += 1
                else:
                    j += 1
    return bins[:n_windows]


def depth_window_bins_exact(starts, ends, depths, window: int,
                            n_windows: int, target_len: int) -> np.ndarray:
    """Direct port of bam2depth.c:132-176 overlap() — oracle for tests."""
    bins = np.zeros(n_windows + 2, dtype=np.float64)
    j = 0
    subject_count = 0
    W = window
    for ls, le, d in zip(starts.tolist(), ends.tolist(), depths.tolist()):
        if subject_count > 1:
            j = j - subject_count if j - subject_count >= 0 else 0
        subject_count = 0
        while j <= n_windows:
            ws = W * j
            we = (j + 1) * W
            if we > target_len:
                we = target_len
            if le < ws:
                break
            if ls <= ws:
                if le <= we:
                    bins[j] += (le - ws) * d
                    subject_count += 1
                    break
                else:
                    bins[j] += (we - ws) * d
                    j += 1
                    subject_count += 1
            else:
                if ls < we:
                    if le <= we:
                        bins[j] += (le - ls) * d
                        subject_count += 1
                        break
                    else:
                        bins[j] += (we - ls) * d
                        j += 1
                        subject_count += 1
                else:
                    j += 1
    return bins[:n_windows]


def wig_window_bins(starts, ends, depths, window: int,
                    n_windows: int, target_len: int) -> np.ndarray:
    """bam2wig window bins, vectorized — equal to wig_window_bins_exact
    (the bam2wig.c:130-175 port) on ascending non-overlapping intervals,
    which is what the bedGraph sweep feeds it.

    Decomposition of the C loop's quirky arithmetic: every window gets the
    true depth*bp overlap against span [j*W, (j+1)*W), EXCEPT
    (a) an interval that starts inside a window and spills past it counts
        one bp less there (the `we-ls` branch uses the inclusive end);
    (b) an interval entering window j from the left and ending exactly on
        its inclusive last position (le == we(j)) takes the `le >= we`
        FULL branch and counts one EXTRA bp there;
    (c) the window containing target_len uses the inclusive span
        [wc*W, target_len+1): quirks (a)/(b) apply against the clamped
        boundary, so that window is recomputed directly;
    (d) windows past that one receive (target_len - j*W + 1) * depth rows
        from any interval crossing j*W — the loop keeps walking with the
        clamped `we` (negative filler; normally beyond the returned range).
    """
    W = window
    nb = n_windows + 3
    bins = np.zeros(nb, dtype=np.float64)
    if len(starts) == 0:
        return bins[:n_windows]
    ls = starts.astype(np.int64)
    le = ends.astype(np.int64)
    d = depths.astype(np.float64)
    fw = ls // W
    lw = (le - 1) // W
    single = fw == lw
    fwc = np.clip(fw, 0, nb - 1)
    np.add.at(bins, fwc, np.where(single, le - ls, (fw + 1) * W - ls) * d)
    multi = ~single
    np.add.at(bins, np.clip(lw[multi], 0, nb - 1),
              (le[multi] - lw[multi] * W) * d[multi])
    mid = multi & (lw > fw + 1)
    diff = np.zeros(nb + 1, dtype=np.float64)
    np.add.at(diff, np.clip(fw[mid] + 1, 0, nb), W * d[mid])
    np.add.at(diff, np.clip(lw[mid], 0, nb), -W * d[mid])
    bins += np.cumsum(diff)[:nb]
    # quirk (a): starts-inside-and-spills intervals count one bp less
    spill = le >= (fw + 1) * W
    np.add.at(bins, fwc[spill], -d[spill])
    # quirk (b): ends-on-inclusive-window-boundary intervals count one more
    lt = le // W
    bmask = (le % W == W - 1) & (ls < lt * W)
    np.add.at(bins, np.clip(lt[bmask], 0, nb - 1), d[bmask])
    # quirk (c): the clamped window recomputed directly
    wc = target_len // W
    if wc * W + W - 1 > target_len and 0 <= wc < n_windows:
        ws = wc * W
        m = (le >= ws) & (ls <= target_len)
        lsm, lem, dm = ls[m], le[m], d[m]
        ov = np.minimum(lem, target_len + 1) - np.maximum(lsm, ws)
        corr = ((lsm < ws) & (lem == target_len)).astype(np.int64) \
            - ((lsm >= ws) & (lem >= target_len + 1)).astype(np.int64)
        bins[wc] = float(np.sum((ov + corr) * dm))
    # quirk (d): clamped-filler rows for returned windows past wc
    for j in range(max(wc + 1, 0), n_windows):
        ws = j * W
        m = (ls < ws) & (le >= ws)
        bins[j] = float(np.sum((target_len - ws + 1) * d[m]))
    return bins[:n_windows]
