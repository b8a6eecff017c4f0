"""Scaling harness of the sharded QC step and sorts
(ngstpu/parallel/scalebench.py; BASELINE.md: >= 80% efficiency 1 -> N).

Times, over 'dp' meshes of 1..N shards, the sharded QC step (psum-merged
histograms, the reduceStats map-reduce of fastq_count_kthread.c:180-210),
the single-device dedup sort (dedup_sorted) and key-only sort
(sort_partition) on the step's packed reads, and the distributed sample
sort, and prints one JSON row per mesh size with the weak-scaling
efficiency of the QC step and the device it ran on:

    python -m ngstpu_torch.parallel.scalebench [--reads-per-chip 262144]
        [--len 128] [--skip-dsort] [--sizes 1,2,4] [--base-qc R/S]
        [--device cuda|cpu]

Inputs are made on each shard's device from a seed, so the times leave
out host I/O. The default sizes are 1, 2, 4 and every card there is, as
far as there are cards; an explicit size beyond that puts several shards
on a card (or, with --device cpu, on the CPU), which shows the mechanics
but not the scaling. One card measures structure, not scaling.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops.sortengine import bytes_to_words, dedup_sorted, sort_partition
from ..utils.device import resolve_device
from .dist import sharded_qc_step
from .dsort import distributed_sort
from .mesh import make_mesh, spread_devices


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or cpu."""
    if dev.type == "cpu":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader", "-i", str(dev.index or 0)],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        return f"{torch.cuda.get_device_name(dev)} (power limit not read)"
    return r.stdout.strip()


def _best(fn, iters: int) -> float:
    """The least wall of `iters` calls of fn, which ends in a host read."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.monotonic()
        fn()
        best = min(best, time.monotonic() - t0)
    return best


def _bench_mesh(n_dev: int, reads_per_chip: int, read_len: int,
                device: torch.device, iters: int = 5,
                skip_dsort: bool = False) -> dict:
    mesh = make_mesh(n_dev, devices=spread_devices(n_dev, device))
    B = reads_per_chip * n_dev
    seq, qual, lens = [], [], []
    for i, dev in zip(mesh.shards, mesh.devices):
        g = torch.Generator(device=dev).manual_seed(i)
        shape = (reads_per_chip, read_len)
        seq.append(torch.randint(65, 85, shape, dtype=torch.uint8,
                                 device=dev, generator=g))
        qual.append(torch.randint(33, 75, shape, dtype=torch.uint8,
                                  device=dev, generator=g))
        lens.append(torch.full((reads_per_chip,), read_len - 10,
                               dtype=torch.int32, device=dev))
    n_valid = [reads_per_chip] * n_dev
    step = sharded_qc_step(mesh)
    out = {}

    def qc():
        merged, gc, packed = step(seq, qual, lens, n_valid)
        int(merged["len_hist"].sum())  # the host read waits for the card
        out["packed"] = packed

    qc()  # warm
    t_qc = _best(qc, iters)

    # the sorts on the step's packed reads, 4 bytes a word as production
    # packs them (bytes_to_words), on the first shard's device
    dev0 = mesh.devices[0]
    pk = torch.cat([p.to(dev0) for p in out.pop("packed")])
    pk = torch.nn.functional.pad(pk, (0, (-pk.shape[1]) % 4))
    wd = bytes_to_words(pk)
    ld = torch.cat([ln.to(dev0) for ln in lens])
    g = torch.Generator(device=dev0).manual_seed(n_dev)
    qd = torch.randint(0, 4000, (B,), dtype=torch.int32, device=dev0,
                       generator=g)

    def dedup():
        int(dedup_sorted(wd, ld, qd, B, maybe_padding=False)["n_groups"])

    def key_only():
        _, heads = sort_partition(wd, ld, B, length_key=False,
                                  maybe_padding=False)
        int(heads.sum())

    dedup()  # warm
    t_sort = _best(dedup, max(iters - 2, 1))
    key_only()
    t_prod = _best(key_only, max(iters - 2, 1))
    row = dict(n_dev=n_dev, reads=B, qc_reads_per_s=B / t_qc,
               dedup_reads_per_s=B / t_sort,
               dedup_prod_reads_per_s=B / t_prod)
    if not skip_dsort:
        # the whole sample sort, shard puts and host pulls included
        words_np = wd.cpu().numpy().astype(np.uint32)
        lens_np = ld.cpu().numpy()
        distributed_sort(mesh, words_np, lens_np)  # warm
        row["dsort_reads_per_s"] = B / _best(
            lambda: distributed_sort(mesh, words_np, lens_np),
            max(iters - 2, 1))
    return row


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reads_per_chip, read_len = 262144, 128
    skip_dsort = False
    sizes_arg = None
    base_qc = None
    device = "cuda"
    it = iter(argv)
    for a in it:
        if a == "--reads-per-chip":
            reads_per_chip = int(next(it))
        elif a == "--len":
            read_len = int(next(it))
        elif a == "--skip-dsort":
            skip_dsort = True
        elif a == "--sizes":
            # explicit mesh sizes, e.g. one size per process
            sizes_arg = [int(x) for x in next(it).split(",") if x]
        elif a == "--base-qc":
            # single-device qc reads/s of an earlier run, for the
            # efficiency when sizes run in separate processes
            base_qc = float(next(it))
        elif a == "--device":
            device = next(it)
    dev = resolve_device(device)
    n_all = torch.cuda.device_count() if dev.type == "cuda" else 1
    sizes = (sizes_arg if sizes_arg is not None
             else sorted({1, 2, 4, n_all} & set(range(1, n_all + 1))))
    where = device_line(dev)
    rows = [_bench_mesh(n, reads_per_chip, read_len, dev,
                        skip_dsort=skip_dsort) for n in sizes]
    base = base_qc if base_qc is not None else rows[0]["qc_reads_per_s"]
    for r in rows:
        r["qc_scaling_eff"] = r["qc_reads_per_s"] / (base * r["n_dev"])
        r["shards_per_device"] = -(-r["n_dev"] // n_all)
        r["device"] = where
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
