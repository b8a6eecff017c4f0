"""bam_sliding_count: per-window read count, base count and GC% + hits PNG.

Parity target: reference bam_sliding_count.c. Streaming mode (no -r):
every record with tid>=0 and !FUNMAP lands in window
(uint16)(pos/window) — the 16-bit truncation for >65535 windows is a
reference quirk we preserve (:117). Per window: read count, GC-base count
(4-bit codes 2/4, cal_GC :84-91), base count. calc_winGC (:126-138)
converts window GC to percent in FLOAT32 arithmetic and accumulates
chromosome sums in float32 ascending-window order — reproduced with
sequential float32 accumulation so the %f outputs are bit-identical.
Output "{outfile}.txt" (:140-164): header with max_target_window column
triples, one row per chromosome WITH reads (lazy-alloc skip :155), row =
name, len, sum_count, sum_base, (double)sum_base/len %f, sum_GC %f, then
per window (k+1, count %u, GC% %f). The whole-genome hits PNG
("{bam}_hits.png", geometry of draw_hits :274-329, 95th-percentile scaled)
renders through our dependency-free canvas; PNG bytes are not a parity
surface. -r region mode uses indexed fetch in the reference; we filter
the stream to the region (same records for sorted inputs).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..io.bam import FUNMAP
from ..utils.png import Canvas, write_png
from ..utils.timing import StageTimer


def accumulate(header, batches, window: int, region: str | None = None):
    """Per-chrom window sums over a stream of columnar batches (bounded
    memory: only the per-window arrays persist across batches).
    Returns (dict tid -> (bins u32, gc_sums i64, len_sums i64), total)."""
    reg = None
    if region:
        from ..ops.bamops import parse_region

        ref, beg, end = parse_region(header, region)
        if ref < 0:
            sys.stderr.write(f"bam2bed: Invalid region {region}\n")
            raise SystemExit(1)
        sys.stdout.write(f"{header.ref_names[ref]}\t{beg}\t{end}\n")
        reg = (ref, beg, end)
    out = {}
    total = 0
    for cols in batches:
        mask = (cols.tid >= 0) & ((cols.flag & FUNMAP) == 0)
        if reg is not None:
            from ..ops.bamops import region_mask

            mask = mask & region_mask(cols, *reg)
        total += int(mask.sum())
        tid = cols.tid[mask]
        pos = cols.pos[mask]
        gc = cols.gc[mask]
        lq = cols.l_qseq[mask]
        win = (pos.astype(np.int64) // window).astype(np.uint16) \
            .astype(np.int64)
        for j in np.unique(tid):
            sel = tid == j
            n_windows = header.ref_lens[j] // window + 1
            nbins = max(n_windows, int(win[sel].max()) + 1)
            bins = np.bincount(win[sel], minlength=nbins)[:n_windows]
            gcs = np.bincount(win[sel], weights=gc[sel].astype(np.float64),
                              minlength=nbins)[:n_windows].astype(np.int64)
            lens = np.bincount(win[sel], weights=lq[sel].astype(np.float64),
                               minlength=nbins)[:n_windows].astype(np.int64)
            prev = out.get(int(j))
            if prev is None:
                out[int(j)] = [bins.astype(np.uint32), gcs, lens]
            else:
                prev[0] += bins.astype(np.uint32)
                prev[1] += gcs
                prev[2] += lens
    return out, total


def f32_seq_sum(arr: np.ndarray) -> np.float32:
    """Sequential float32 accumulation (C loop order)."""
    return np.add.accumulate(arr.astype(np.float32), dtype=np.float32)[-1] \
        if len(arr) else np.float32(0)


def process(path: str, window: int, outfile_rows: list, header_state: dict,
            timer: StageTimer, region: str | None = None) -> None:
    header = batches = None
    if region:
        # BAI-driven partial decode: inflate only blocks overlapping the
        # region (the reference's indexed fetch, bam_sliding_count.c:394-409)
        from ..io.bam import read_bam_region

        name, _, rest = region.partition(":")
        beg, end = 0, 1 << 29
        if rest:
            b, _, e = rest.partition("-")
            if b:
                beg = max(int(b.replace(",", "")) - 1, 0)
            if e:
                end = int(e.replace(",", ""))
        try:
            got = read_bam_region(path, name, beg, end)
        except ValueError:  # unknown ref name: full scan reports it
            got = None
        if got is not None:
            header, batches = got[0], [got[1]]
    if header is None:
        from ..io.bam import BamStream

        stream = BamStream(path)
        header, batches = stream.header, stream
    by_tid, total = accumulate(header, batches, window, region)
    sys.stderr.write(f"Done load bam file {path} at {timer.elapsed():.3f} s\n")

    max_target_window = max(header.ref_lens) // window + 1 if header.ref_lens else 0
    header_state.setdefault("max_window", max_target_window)
    header_state.setdefault("header", header)

    for j, (name, tlen) in enumerate(zip(header.ref_names, header.ref_lens)):
        if j not in by_tid:
            continue
        bins, gcs, lens = by_tid[j]
        sum_count = int(bins.sum())
        sum_base = int(lens.sum())
        sum_gc_f = f32_seq_sum(gcs)
        sum_gc = np.float32(sum_gc_f / np.float32(sum_base) * np.float32(100)) \
            if sum_base else np.float32(0)
        # per-window GC%: float32 gc/len*100, zero stays zero (:134)
        with np.errstate(invalid="ignore", divide="ignore"):
            gc_pct = np.where(
                gcs != 0,
                (gcs.astype(np.float32) / lens.astype(np.float32)
                 * np.float32(100)),
                gcs.astype(np.float32))
        mean_cov = sum_base / tlen
        row = [f"{name}\t{tlen}\t{sum_count}\t{sum_base}\t{mean_cov:f}\t{float(sum_gc):f}"]
        for k in range(len(bins)):
            row.append(f"\t{k + 1}\t{int(bins[k])}\t{float(gc_pct[k]):f}")
        outfile_rows.append("".join(row) + "\n")

    draw_hits(path, header, by_tid, window)
    sys.stderr.write(f"Done draw hit {path}_hits.png at {timer.elapsed():.3f} s\n")


def draw_hits(path: str, header, by_tid, window: int) -> None:
    """Whole-genome hits scatter mirroring draw_hits geometry
    (bam_sliding_count.c:274-329)."""
    max_target_window = max(header.ref_lens) // window + 1 if header.ref_lens else 1
    left, top = 50, 50
    each_window_size = 0.2
    chrom_h = 40
    height = header.n_refs * (chrom_h + 10) + 2 * top
    width = int(max_target_window * each_window_size + 2 * left)
    canvas = Canvas(max(width, 1), max(height + top, 1))
    blue = (70, 130, 180)
    black = (0, 0, 0)
    y = top
    for j, name in enumerate(header.ref_names):
        x = float(left)
        y += chrom_h + 10
        canvas.text(0, y - 20, name, black, scale=2)
        n_windows = header.ref_lens[j] // window + 1
        canvas.rectangle(int(x), y - chrom_h,
                         int(left + n_windows * each_window_size), y, black)
        if j not in by_tid:
            continue
        bins = by_tid[j][0]
        if len(bins) == 0:
            continue
        srt = np.sort(bins)
        p95 = int(srt[int(0.95 * len(srt))])
        for k in range(len(bins)):
            x += each_window_size
            dy = 0 if p95 == 0 else int(bins[k]) * chrom_h // p95
            canvas.set_pixel(int(x), y - dy, blue)
    canvas.filled_rectangle(left, y, left + chrom_h, y + chrom_h, blue)
    write_png(path + "_hits.png", canvas)


def main(argv: list[str]) -> int:
    timer = StageTimer()
    outfile, window = "out", 20000
    if not argv:
        _usage()
        return 1
    opts, files = getopt.gnu_getopt(argv, "o:w:r:s:h?")
    region = None
    for flag, val in opts:
        if flag == "-o":
            outfile = val
        elif flag == "-w":
            window = int(val)
        elif flag == "-r":
            region = val  # C also falls through to -s; region handled below
        elif flag == "-s":
            pass
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if not files:
        _usage()
        return 1
    rows: list[str] = []
    header_state: dict = {}
    reg = region if (region and region != "-") else None
    for path in files:
        process(path, window, rows, header_state, timer, reg)

    with open(outfile + ".txt", "wb") as out:
        max_w = header_state.get("max_window", 0)
        head = ["#chr\tchr_len\tchr_sum_read_count\tchr_sum_base\t"
                "chr_mean_cov\tchr_mean_GC%"]
        for k in range(max_w):
            head.append(f"\t{k + 1}\tcount\tGC%")
        out.write(("".join(head) + "\n").encode())
        out.write("".join(rows).encode())
    sys.stderr.write(f"Done output {outfile}.txt at {timer.elapsed():.3f} s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch bam_sliding_count [-o OUTFILE] [-w WINDOW_SIZE] [-r region] [-s 0] [-h] bam1 ...\n")
