"""bam2wig: BAM -> variableStep wig of windowed mean depth + chromSize.

Parity target: reference bam2wig.c. Differences from bam2depth preserved:
- filter only BAM_FUNMAP (:88) — secondary/qcfail/dup reads DO count
- window arithmetic with inclusive window_end=(j+1)*W-1 and its
  off-by-one quirks (overlap :130-175) — reproduced exactly
- outputs only {outfile}.{i}.wig (variableStep span=W header per chrom,
  nonzero windows "ws\\tmean" :245-253) and {outfile}.{i}.chromSize.txt
  (always, :322); no bedGraph. Default outfile "-" -> both to stdout,
  interleaved per chromosome in wig-then-chromSize order.

As in bam2depth, the events and dense engines run on the host and the
sparse route sweeps on `device` unless the link verdict says host.
"""

from __future__ import annotations

import getopt
import sys

import numpy as np
import torch

from ..io.bam import FUNMAP
from ..io.stream import open_text_output, with_suffix
from ..ops.bamops import merged_intervals, stream_chrom_events, wig_window_bins
from ..utils.timing import StageTimer


def process_bam(path: str, index1: int, outfile: str, window: int,
                timer: StageTimer,
                device: str | torch.device = "cuda") -> None:
    from ..io.bam import (DensePileupUnsupported, choose_pileup_mode,
                          stream_depth_dense, stream_pileup_events)
    from ..io.native import depth_intervals_dense
    from .bam2depth import _prefetch1

    mode = choose_pileup_mode(path)
    if mode == "events":
        # low-depth WGS shape: O(events) radix sweep (see bam2depth)
        ev = stream_pileup_events(path, FUNMAP, pooled_flush=True)
        if ev is not None:
            from ..ops.bamops import merged_intervals_runs

            header, events = ev
            _emit_wig(path, header,
                      _prefetch1(merged_intervals_runs(pos, delta, "host",
                                                       device)
                                 for pos, delta in events),
                      index1, outfile, window, timer)
            return
        mode = "dense"
    dense = (stream_depth_dense(path, FUNMAP, recycle=True)
             if mode != "sparse" else None)
    if dense is not None:
        # fast path: the same fused dense pileup as bam2depth; the merged
        # (start, end, depth) columns come straight from the delta array
        # (ngs_depth_intervals ≡ merged_intervals) and feed the SAME
        # vectorized wig binning, so output parity is unchanged
        header, per_ref = dense
        intervals = _prefetch1(
            depth_intervals_dense(delta, evs, zero_after=True)
            for delta, evs in per_ref)
        try:
            _emit_wig(path, header, intervals, index1, outfile, window,
                      timer)
            return
        except DensePileupUnsupported:
            pass  # corrupt coordinates: redo on the sparse event path

    header, events = stream_chrom_events(path, FUNMAP)
    _emit_wig(path, header,
              (merged_intervals(pos, delta, device=device)
               for pos, delta in events),
              index1, outfile, window, timer)


def _emit_wig(path, header, intervals, index1: int, outfile: str,
              window: int, timer: StageTimer) -> None:
    from ..io.bam import DensePileupUnsupported

    wig_out = open_text_output(with_suffix(outfile, f".{index1}.wig"))
    chr_out = open_text_output(with_suffix(outfile, f".{index1}.chromSize.txt"))

    done = 0
    try:
        for (name, tlen), (starts, ends, depths) in zip(
                zip(header.ref_names, header.ref_lens), intervals):
            n_windows = tlen // window + 1
            bins = wig_window_bins(starts, ends, depths, window,
                                   n_windows, tlen)
            wig_out.write(f"variableStep chrom={name} span={window}\n")
            ws = np.arange(n_windows, dtype=np.int64) * window
            nz = np.flatnonzero(bins)
            wig_out.write("".join(
                f"{int(ws[i])}\t{bins[i] / window:.2f}\n" for i in nz))
            chr_out.write(f"{name}\t{tlen}\n")
            sys.stderr.write(f"{name} at {timer.elapsed():.3f} s\n")
            done += 1
    except DensePileupUnsupported:
        # close explicitly so the sparse rerun reopens truncated files;
        # stdout cannot be truncated — surface instead of double-emitting
        for f in (wig_out, chr_out):
            if f is not sys.stdout:
                f.close()
        if done and sys.stdout in (wig_out, chr_out):
            raise ValueError(
                "corrupt BAM coordinates after partial stdout output; "
                "rerun with -o FILE to allow the sparse-path retry")
        raise

    for f in (wig_out, chr_out):
        if f is not sys.stdout:
            f.close()
    sys.stderr.write(
        f"Converted {path} to wig format at {timer.elapsed():.3f} s\n")


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    timer = StageTimer()
    outfile, window = "-", 20000
    if not argv:
        _usage()
        return 1
    opts, files = getopt.gnu_getopt(argv, "o:w:r:s:h?")
    for flag, val in opts:
        if flag == "-o":
            outfile = val
        elif flag == "-w":
            window = int(val)
        elif flag in ("-r", "-s"):
            pass
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if not files:
        _usage()
        return 1
    for i, path in enumerate(files, 1):
        process_bam(path, i, outfile, window, timer, device)
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] bam2wig [-o OUTFILE] [-w WINDOW_SIZE] [-h] bam1 bam2 ...\n")
