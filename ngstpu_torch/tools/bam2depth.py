"""bam2depth: BAM -> per-base bedGraph + windowed mean depth (+wig).

Parity target: reference bam2depth.c. Per input BAM i (1-based):
- basename(bam).{i}.bedGraph — merged constant-depth intervals
  "chr\\tstart\\tend\\tdepth" (hash2BedGraph :203-236)
- {outfile}.{i}.depth — every window "chr\\tws\\twe\\tmean" with
  we=min((j+1)W, len) and mean=bins/W at %.2f (output_bins :238-246)
- with -W: {outfile}.{i}.wig (variableStep, nonzero bins only) and
  {outfile}.{i}.chromSize.txt
Read filter: skip flag & BAM_DEF_MASK (unmapped|secondary|qcfail|dup) or
tid<0 (:90); M-ops (op 0 only) produce [start,end) events, D/N advance,
I/S/H/P/=/X ignored (:94-107). All chromosomes are processed in header
order; default outfile "-" streams to stdout. The reference requires a
.bai and bam_fetch; we stream the whole (coordinate-grouped) file —
identical output for indexed inputs. -r falls through to -s in the C
getopt (missing break, :281-284) and is effectively ignored; accepted
here for compatibility.

The events and dense engines run on the host (native library); the
sparse route (NGSTPU_PILEUP_MODE=sparse, no native library, or the dense
engine's DensePileupUnsupported retry) sweeps each chromosome's events on
`device` unless the link verdict says host (ops/bamops.merged_intervals).
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np
import torch

from ..io.bam import DEF_MASK, DensePileupUnsupported
from ..io.native import format_int3_rows
from ..io.stream import open_text_output, with_suffix
from ..ops.bamops import depth_window_bins, stream_chrom_events
from ..utils.iopipe import prefetch1 as _prefetch1
from ..utils.timing import StageTimer


def _sparse_rows_and_bins(header, events, window: int,
                          placement: str | None,
                          device: str | torch.device):
    from ..ops.bamops import merged_intervals_runs, pileup_emit_runs

    for (name, tlen), (pos, delta) in zip(
            zip(header.ref_names, header.ref_lens), events):
        n_windows = tlen // window + 1
        if placement == "host":
            # fused native pass: sweep + interval merge + row format +
            # window bins together (no int64 intermediates)
            out = pileup_emit_runs(pos, delta, name.encode(), window,
                                   n_windows)
            if out is not None:
                yield out
                continue
        starts, ends, depths = merged_intervals_runs(pos, delta, placement,
                                                     device)
        rows_b = (format_int3_rows(name.encode(), starts, ends, depths)
                  if len(starts) else b"")
        yield rows_b, depth_window_bins(starts, ends, depths, window,
                                        n_windows, tlen)


def process_bam(path: str, index1: int, outfile: str, window: int,
                wig: bool, timer: StageTimer,
                device: str | torch.device = "cuda") -> None:
    from ..io.bam import (choose_pileup_mode, stream_depth_dense,
                          stream_pileup_events)
    from ..io.native import depth_emit_dense

    mode = choose_pileup_mode(path)
    if mode == "events":
        # low-depth WGS shape: O(events) radix sweep instead of the
        # O(genome) dense scatter; the 1-deep prefetch overlaps chrom
        # k's file write with the decode+sweep+format of chrom k+1
        ev = stream_pileup_events(path, DEF_MASK, pooled_flush=True)
        if ev is not None:
            header, events = ev
            _emit_outputs(path, header,
                          _prefetch1(_sparse_rows_and_bins(
                              header, events, window, "host", device)),
                          index1, outfile, window, wig, timer)
            return
        mode = "dense"  # no native lib: the dense probe below also
        # returns None and the sparse path runs
    dense = (stream_depth_dense(path, DEF_MASK, recycle=True)
             if mode != "sparse" else None)
    if dense is not None:
        # fast path: fused native dense pileup — per-chrom delta scatter
        # during the chunked decode, then one emit pass producing the
        # bedGraph rows and the exact window bins together.
        # zero_after restores each recycled delta buffer during that same
        # pass (no bulk re-zeroing); the 1-deep prefetch thread overlaps
        # chrom k's emit pass with the decode of chrom k+1 — safe because
        # the delta array is fully consumed inside the generator body
        # before the item is handed over
        header, per_ref = dense
        rows_and_bins = _prefetch1(
            depth_emit_dense(delta, evs, name.encode(), window,
                             tlen // window + 1, zero_after=True)
            for (name, tlen), (delta, evs) in zip(
                zip(header.ref_names, header.ref_lens), per_ref))
        try:
            _emit_outputs(path, header, rows_and_bins, index1, outfile,
                          window, wig, timer)
            return
        except DensePileupUnsupported:
            pass  # corrupt coordinates: redo on the sparse event path
            # (outputs below reopen with truncation, so no partial rows)
    header, events = stream_chrom_events(path, DEF_MASK)
    _emit_outputs(path, header,
                  _sparse_rows_and_bins(header, events, window, None, device),
                  index1, outfile, window, wig, timer)


def _emit_outputs(path, header, rows_and_bins, index1: int, outfile: str,
                  window: int, wig: bool, timer: StageTimer) -> None:
    bedgraph = open_text_output(
        with_suffix(os.path.basename(path), f".{index1}.bedGraph"))
    depth_out = open_text_output(with_suffix(outfile, f".{index1}.depth"))
    wig_out = chr_out = None
    if wig:
        wig_out = open_text_output(with_suffix(outfile, f".{index1}.wig"))
        chr_out = open_text_output(
            with_suffix(outfile, f".{index1}.chromSize.txt"))
    handles = (bedgraph, depth_out, wig_out, chr_out)

    done_refs = [0]
    try:
        _emit_loop(header, rows_and_bins, bedgraph, depth_out, wig_out,
                   chr_out, window, wig, timer, done_refs)
    except DensePileupUnsupported:
        # close the first attempt's handles explicitly so the sparse-path
        # rerun reopens truncated files, never racing GC finalizers; a
        # stdout stream cannot be truncated, so a mid-stream failure there
        # must surface instead of double-emitting earlier chromosomes
        for f in handles:
            if f is not None and f is not sys.stdout:
                f.close()
        if done_refs[0] and any(f is sys.stdout for f in handles):
            raise ValueError(
                "corrupt BAM coordinates after partial stdout output; "
                "rerun with -o FILE to allow the sparse-path retry")
        raise
    for f in handles:
        if f is not None and f is not sys.stdout:
            f.close()
    sys.stderr.write(
        f"Converted {path} to wig format at {timer.elapsed():.3f} s\n")


def _emit_loop(header, rows_and_bins, bedgraph, depth_out, wig_out,
               chr_out, window: int, wig: bool, timer: StageTimer,
               done_refs: list) -> None:
    import time as _time

    from .emitters import _PageRecycler

    # the bedGraph is the big output (hundreds of MB on WGS) and its
    # page-cache allocation can be the dominant non-decode cost of the
    # wall on slow-fault hosts — adaptive recycling with a small window
    # (the probe skips it when pages are cheap)
    rec = (None if bedgraph is sys.stdout
           else _PageRecycler(bedgraph.buffer, window=96 << 20,
                              start=160 << 20))
    rec_off = 0
    for (name, tlen), (rows_b, bins) in zip(
            zip(header.ref_names, header.ref_lens), rows_and_bins):
        n_windows = tlen // window + 1
        if len(rows_b):
            if bedgraph is sys.stdout:  # keep text-layer ordering on stdout
                bedgraph.write(bytes(rows_b).decode())
            else:
                # bytes straight to the OS buffer: decode+re-encode
                # through the text layer costs a full extra pass
                t0 = _time.monotonic()
                bedgraph.buffer.write(rows_b)
                if rec is not None:
                    rec.note_write(len(rows_b), _time.monotonic() - t0)
                    rec_off += len(rows_b)
                    rec.wrote(rec_off)
        ws = np.arange(n_windows, dtype=np.int64) * window
        we = np.minimum(ws + window, tlen)
        rows = [f"{name}\t{int(ws[i])}\t{int(we[i])}\t{bins[i] / window:.2f}\n"
                for i in range(n_windows)]
        depth_out.write("".join(rows))
        if wig:
            wig_out.write(f"variableStep chrom={name} span={window}\n")
            nz = np.flatnonzero(bins)
            wig_out.write("".join(
                f"{int(ws[i])}\t{bins[i] / window:.2f}\n" for i in nz))
            chr_out.write(f"{name}\t{tlen}\n")
        timer.checkpoint(name)
        sys.stderr.write(f"{name} at {timer.elapsed():.3f} s\n")
        done_refs[0] += 1


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    timer = StageTimer()
    outfile, window, wig = "-", 20000, False
    if not argv:
        _usage()
        return 1
    opts, files = getopt.gnu_getopt(argv, "o:w:r:s:Wh?")
    for flag, val in opts:
        if flag == "-o":
            outfile = val
        elif flag == "-w":
            window = int(val)
        elif flag == "-W":
            wig = True
        elif flag in ("-r", "-s"):
            pass  # -r falls through to -s in the C getopt; both unused
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if not files:
        _usage()
        return 1
    for i, path in enumerate(files, 1):
        process_bam(path, i, outfile, window, wig, timer, device)
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] bam2depth [-o OUTFILE] [-w WINDOW_SIZE] [-r region] [-W] [-s 0] [-h] bam1 bam2 ...\n")
