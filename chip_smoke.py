#!/usr/bin/env python3
"""Smoke test of the ngstpu_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ngstpu_torch/csrc, holds it against its
plain PyTorch version on the card, holds the device sorts against the same
functions on CPU tensors, then drives the count+trim+uniq pipeline at the
composite's real size (2,097,152 reads x 100 bp) on both device routes,
with the placement forced to the card and with the default placement that
the link probe picks, and byte-compares every output file with a
host-placement run on the CPU.
Any failed check exits non-zero. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import filecmp
import itertools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".cache" / "chip_smoke"
HIST_SHAPES = ((262144, 128), (262144, 640))  # (rows, cycles)
SORT_ROWS, SORT_WORDS = 1 << 21, 7
N_READS, READ_LEN, TRIM = 1 << 21, 100, (0, 50)
OUTPUTS = (".count.tsv", ".trim.fastq", "_uniq.fq", "_sortKeyUniq.fq")


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: FAIL: {msg}\n")
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_kernel(rng, card: str) -> dict:
    """The histogram kernel against its plain version at the generic
    path's shapes; exact equality (integer counts)."""
    import torch

    from ngstpu_torch.kernels import hist_cuda

    out = {}
    for B, L in HIST_SHAPES:
        n_valid = B - 1237
        qual = rng.integers(33, 75, (B, L), dtype=np.uint8)
        # a few wild bytes, some >= 128, which must never be counted
        wild = rng.random((B, L), dtype=np.float32) < 0.02
        qual[wild] = rng.integers(0, 256, int(wild.sum()), dtype=np.uint8)
        lens = rng.integers(0, L + 1, B, dtype=np.int32)
        q = torch.from_numpy(qual).cuda()
        ln = torch.from_numpy(lens).cuda()
        tq = torch.zeros((512, 128), dtype=torch.int32, device="cuda")
        tl = torch.zeros(512, dtype=torch.int32, device="cuda")
        hist_cuda.qc_hist_accumulate_(tq, tl, q, ln, n_valid)
        torch.cuda.synchronize()
        pq, pl = hist_cuda.qc_hist_plain(q, ln, n_valid)
        err = max(int((tq - pq).abs().max()), int((tl - pl).abs().max()))
        check(err == 0, f"qc_hist kernel != plain at B={B} L={L}: "
                        f"max abs err {err}")
        check(int(tl.sum()) == n_valid, "length histogram lost rows")
        # time over 3 copies of the batch in turn (>= 100 MB), so the
        # 50 MB L2 does not hold the batch from one launch to the next
        qs = [q, q.clone(), q.clone()]
        turn = itertools.count()
        ms = cuda_ms(lambda: hist_cuda.qc_hist_accumulate_(
            tq, tl, qs[next(turn) % 3], ln, n_valid), 60)
        plain_ms = cuda_ms(lambda: hist_cuda.qc_hist_plain(
            qs[next(turn) % 3], ln, n_valid), 12)
        gbs = B * L / (ms * 1e-3) / 1e9
        print(f"qc_hist B={B} L={L} n_valid={n_valid}: kernel == plain "
              f"(max_abs_err 0); kernel {ms:.4f} ms ({gbs:.1f} GB/s of "
              f"qual), plain {plain_ms:.4f} ms [{card}]")
        out[L] = dict(ms=ms, plain_ms=plain_ms, err=err)
        del q, qs, ln, pq, pl
    return out


def phase_sorts(rng) -> None:
    """Device sorts against the same functions on CPU tensors."""
    import torch

    from ngstpu_torch.ops import sortengine as se

    B, W = SORT_ROWS, SORT_WORDS
    n_valid = B - 12345
    base = rng.integers(0, 1 << 32, (B // 2, W), dtype=np.uint32)
    words_np = base[rng.integers(0, B // 2, B)]  # duplicates, top bit set
    check(bool((words_np >= 1 << 31).any()), "no words >= 2**31")
    lens_np = rng.integers(30, 101, B, dtype=np.int32)
    sumq_np = rng.integers(0, 4000, B, dtype=np.uint32).view(np.int32)
    cpu = torch.device("cpu")
    gpu = torch.device("cuda")
    args = {d: (se.words_tensor(words_np, d), torch.from_numpy(lens_np).to(d),
                torch.from_numpy(sumq_np).to(d)) for d in (cpu, gpu)}
    for length_key in (True, False):
        res = {d: se.sort_partition(args[d][0], args[d][1], n_valid,
                                    length_key=length_key)
               for d in (cpu, gpu)}
        torch.cuda.synchronize()
        for name, i in (("perm", 0), ("is_head", 1)):
            check(torch.equal(res[cpu][i], res[gpu][i].cpu()),
                  f"sort_partition {name} differs (length_key={length_key})")
    res = {d: se.dedup_sorted(*args[d], n_valid) for d in (cpu, gpu)}
    for name in ("perm", "is_head"):
        check(torch.equal(res[cpu][name], res[gpu][name].cpu()),
              f"dedup_sorted {name} differs")
    print(f"sorts B={B} W={W} n_valid={n_valid}: sort_partition "
          f"(length_key both ways) and dedup_sorted perm/is_head equal on "
          f"cuda and cpu; groups {int(res[gpu]['n_groups'])}")


def run_pipeline(path: pathlib.Path, prefix: pathlib.Path, device: str,
                 env: dict) -> dict:
    import torch

    from ngstpu_torch.tools import pipeline

    for name, value in env.items():  # None unsets
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    t0 = time.monotonic()
    info = pipeline.run(str(path), str(prefix), TRIM[0], TRIM[1],
                        device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    info["wall"] = time.monotonic() - t0
    return info


def phase_pipeline(card: str) -> int:
    """Both device routes at the composite's size, forced to the card and
    in the default placement (which must measure the link and pick the
    card), byte-compared with a host-placement run on the CPU, then timed
    in turns (device, host, host, device per route). Returns the kernel
    launches of the main-path runs."""
    from ngstpu_torch.kernels import hist_cuda
    from ngstpu_torch.ops import sortengine
    from ngstpu_torch.testing.fixtures import (random_fastq_fast,
                                              with_n_calls)
    from ngstpu_torch.tools.profile_pipeline import fmt_stages
    from ngstpu_torch.utils import linkprobe

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    # bench.py's composite input
    fq = random_fastq_fast(N_READS, READ_LEN, seed=123, dup_frac=0.3)
    inputs = {"fast": WORK / "comp.fq", "generic": WORK / "comp_n.fq"}
    inputs["fast"].write_bytes(fq)
    inputs["generic"].write_bytes(with_n_calls(fq, 0.01, seed=123))
    del fq
    env = {"cuda": {"fast": {"NGSTPU_LINK": "device", "NGSTPU_QC": "auto"},
                    "generic": {"NGSTPU_LINK": "device",
                                "NGSTPU_QC": "device"}},
           "cpu": {r: {"NGSTPU_LINK": "host", "NGSTPU_QC": "host"}
                   for r in inputs}}
    # the CLI's default: no placement set, so the link probe decides; a
    # HOME of its own makes the probe measure instead of reading a cache
    default_env = {"NGSTPU_LINK": None, "NGSTPU_QC": None,
                   "HOME": str(WORK / "home")}

    def run(route: str, device: str, tag: str) -> dict:
        return run_pipeline(inputs[route], WORK / f"{route}_{tag}", device,
                            env[device][route])

    # warm-up at a small size: builds the native host library and loads
    # the device sort's kernels, so the timed runs below start warm
    small = WORK / "small.fq"
    small.write_bytes(random_fastq_fast(1 << 14, READ_LEN, seed=7))
    t0 = time.monotonic()
    run_pipeline(small, WORK / "small", "cuda", env["cuda"]["fast"])
    print(f"warm-up pipeline run (native host library build included): "
          f"{time.monotonic() - t0:.2f}s")
    for p in WORK.glob("small*"):
        p.unlink()

    # the main path: both routes on the card, counted
    hist_cuda.LAUNCHES = 0
    sortengine.SORTS.clear()
    linkprobe._VERDICT.clear()
    linkprobe.LAST_PROBE.clear()
    home = os.environ.get("HOME")
    runs, counts = {}, {}
    # placement forced to the card, then the default placement (generic
    # first, so its QC batch is what the link probe times)
    for route, tag, renv in [(r, "cuda", env["cuda"][r]) for r in inputs] \
            + [(r, "default", default_env) for r in ("generic", "fast")]:
        before = (sortengine.SORTS["cuda"], hist_cuda.LAUNCHES)
        info = run_pipeline(inputs[route], WORK / f"{route}_{tag}", "cuda",
                            renv)
        runs.setdefault(route, []).append(info)
        counts[route, tag] = (sortengine.SORTS["cuda"] - before[0],
                              hist_cuda.LAUNCHES - before[1])
    launches = hist_cuda.LAUNCHES
    if home is None:
        os.environ.pop("HOME", None)
    else:
        os.environ["HOME"] = home

    probe = dict(linkprobe.LAST_PROBE)
    check(probe.get("cached") is False,
          f"default placement: the link probe did not measure ({probe})")
    gbs = probe["nbytes"] / probe["seconds"] / 1e9
    print(f"default placement: link probe verdict {probe['verdict']!r} from "
          f"a {probe['nbytes']}-byte copy in {probe['seconds'] * 1e3:.3f} ms "
          f"({gbs:.2f} GB/s; threshold {linkprobe.bw_min() / 1e9:.2f} GB/s); "
          f"the probe took {probe['wall']:.3f}s [{card}]")
    check(probe["verdict"] == "device",
          "default placement: the link probe sent the work to the host")
    for route in inputs:
        check("trim_write" in runs[route][0]["stages"]
              if route == "generic" else
              "trim_write" not in runs[route][0]["stages"],
              f"{route} input did not take the {route} route")
        for tag in ("cuda", "default"):
            check(counts[route, tag][0] > 0,
                  f"{route} route ({tag}): no sort ran on the card")
    for tag in ("cuda", "default"):
        check(counts["generic", tag][1] > 0,
              f"generic route ({tag}): qc_hist kernel never launched")

    for route in inputs:
        ref = run(route, "cpu", "host")
        for info, tag in zip(runs[route], ("cuda", "default")):
            check((info["n"], info["n_groups"])
                  == (ref["n"], ref["n_groups"]),
                  f"{route} ({tag}): reads/unique differ from the host run")
            check(info["n"] == N_READS, f"{route}: read {info['n']} reads")
            for suffix in OUTPUTS:
                a = WORK / f"{route}_{tag}{suffix}"
                b = WORK / f"{route}_host{suffix}"
                check(filecmp.cmp(a, b, shallow=False),
                      f"{route}: {a.name} differs from the host-placement "
                      f"run")
            sorts, hists = counts[route, tag]
            print(f"pipeline {route} route ({tag} placement), {N_READS} x "
                  f"{READ_LEN} bp: 4 outputs byte-identical to the "
                  f"host-placement run; reads {info['n']} unique "
                  f"{info['n_groups']}; device sorts {sorts}, qc_hist "
                  f"launches {hists}; wall {info['wall']:.3f}s "
                  f"({fmt_stages(info['stages'])}) [{card}]")
        runs[route] = runs[route][:1]
        # timing turns: device (above), host (above), host, device
        runs[route] += [ref, run(route, "cpu", "host"),
                        run(route, "cuda", "cuda")]
        for p in WORK.glob(f"{route}_*"):
            p.unlink()
        for info, dev in zip(runs[route], ("cuda", "cpu", "cpu", "cuda")):
            print(f"  {route} {'device' if dev == 'cuda' else 'host  '} "
                  f"{info['n'] / info['wall']:.0f} reads/s wall "
                  f"{info['wall']:.3f}s ({fmt_stages(info['stages'])}) "
                  f"[{card}]")
    print(f"qc_hist launches on the main path: {launches}")
    shutil.rmtree(WORK, ignore_errors=True)
    return launches


def main() -> int:
    if not (REPO / "ngstpu_torch").is_dir() or not (REPO / "ngstpu").is_dir():
        fail("run from a checkout of the repository: ngstpu_torch/ and "
             "ngstpu/ must sit beside chip_smoke.py")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    os.environ.setdefault("NGSTPU_SHM_POOL", "0")

    card = card_line()
    print(f"card: {card}")
    from ngstpu_torch.kernels import build

    t0 = time.monotonic()
    build.load("qc_hist")
    log = build.BUILD_LOG["qc_hist"]
    print(f"kernel build: qc_hist {log['seconds']:.2f}s "
          f"(load {time.monotonic() - t0:.2f}s)")
    for line in log["log"].splitlines():
        if "ptxas info" in line:
            print(f"  {line.strip()}")

    rng = np.random.default_rng(2024)
    hist = phase_kernel(rng, card)
    phase_sorts(rng)
    launches = phase_pipeline(card)

    kernels = [{"name": "qc_hist", "route": "cuda",
                "source": "ngstpu_torch/csrc/qc_hist.cu",
                "replaces": "ngstpu/kernels/hist_pallas.py:27",
                "launches": launches,
                "max_abs_err": max(h["err"] for h in hist.values()),
                "ms": hist[128]["ms"], "plain_ms": hist[128]["plain_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
