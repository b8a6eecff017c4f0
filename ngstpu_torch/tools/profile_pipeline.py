"""Profile the port's pipeline on both routes with torch.profiler.

    python -m ngstpu_torch.tools.profile_pipeline [--reads N] [--device DEV]
        [--work DIR] [--out DIR]

Makes the composite's input, random_fastq_fast(N, 100, seed=123,
dup_frac=0.3), and its twin with one N in 1% of the reads (the generic
route). After a small warm-up run, each route runs once unprofiled and once
under torch.profiler, with the placement forced to the device
(NGSTPU_LINK=device, NGSTPU_QC=device) and trimmed with -s 0 -e 50. For
each route it prints the wall time and StageTimer stages of both runs, the
device's busy time (the union of all device kernel and copy intervals) and
its share of the profiled wall, and the device ops that take the most time.
With --out, each route's full key_averages table is written there.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import sys
import time

import torch

READ_LEN, TRIM = 100, (0, 50)
TOP = 8  # device ops listed per route


def fmt_stages(stages: dict) -> str:
    prev, parts = 0.0, []
    for name, t in stages.items():
        parts.append(f"{name}={t - prev:.3f}s")
        prev = t
    return " ".join(parts)


def device_ops(prof) -> tuple[float, dict]:
    """(busy ms, {op name: [ms, count]}) over the device events of a
    finished torch.profiler run; busy time merges overlapping intervals."""
    spans, ops = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        rec = ops.setdefault(e.name, [0.0, 0])
        rec[0] += (t1 - t0) / 1e3
        rec[1] += 1
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e3, ops


def _run(path, prefix, device):
    from .pipeline import run

    t0 = time.monotonic()
    info = run(str(path), str(prefix), TRIM[0], TRIM[1], device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    info["wall"] = time.monotonic() - t0
    return info


def main(argv: list[str] | None = None) -> int:
    from torch.profiler import ProfilerActivity, profile

    from ..testing.fixtures import random_fastq_fast, with_n_calls
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(prog="profile_pipeline")
    ap.add_argument("--reads", type=int, default=1 << 21)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=".cache/profile_pipeline")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.environ.update(NGSTPU_LINK="device", NGSTPU_QC="device")
    work = pathlib.Path(args.work)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = pathlib.Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    fq = random_fastq_fast(args.reads, READ_LEN, seed=123, dup_frac=0.3)
    inputs = {"fast": work / "comp.fq", "generic": work / "comp_n.fq"}
    inputs["fast"].write_bytes(fq)
    inputs["generic"].write_bytes(with_n_calls(fq, 0.01, seed=123))
    del fq
    small = work / "small.fq"
    small.write_bytes(random_fastq_fast(min(1 << 14, args.reads), READ_LEN,
                                        seed=7))
    _run(small, work / "small", device)
    try:
        for route, path in inputs.items():
            warm = _run(path, work / route, device)
            with profile(activities=activities) as prof:
                info = _run(path, work / route, device)
            busy, ops = device_ops(prof)
            print(f"profile {route} route, {info['n']} reads on {device}: "
                  f"unprofiled wall {warm['wall']:.3f}s "
                  f"({fmt_stages(warm['stages'])}); profiled wall "
                  f"{info['wall']:.3f}s ({fmt_stages(info['stages'])})")
            if device.type == "cuda":
                print(f"  device busy {busy:.3f} ms, "
                      f"{100 * busy / 1e3 / info['wall']:.2f}% of the "
                      f"profiled wall; {sum(c for _, c in ops.values())} "
                      f"device ops")
                top = sorted(ops.items(), key=lambda kv: -kv[1][0])
                for name, (ms, count) in top[:TOP]:
                    print(f"  {ms:10.3f} ms  x{count:<5d} {name[:90]}")
            else:
                print("  device busy: not measured (no CUDA device)")
            if out is not None:
                (out / f"profile_{route}.txt").write_text(
                    prof.key_averages().table(row_limit=60))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
