#!/usr/bin/env python3
"""Smoke test of the ngstpu_torch port on one CUDA card.

    python3 chip_smoke.py

Needs only ngstpu_torch/ beside it. Builds the port's native host library
(g++) and its CUDA kernel (nvcc) from the checkout, holds the kernel
against its plain PyTorch version on the card at seven shapes (the
generic path's 262,144-row launches at 128 and 640 cycles and with 100 bp
reads, fastqc's 10M-read lane launch with uniform and NovaSeq-binned
qualities, and fastqc_stats' full-width launch at 600 cycles with 302 and
602 length bins), each with its time, bound and share of the bound; holds the device sorts against the same
functions on CPU tensors, then drives the count+trim+uniq pipeline at the
composite's real size (2,097,152 reads x 100 bp) on both device routes,
with the placement forced to the card and with the default placement that
the link probe picks, and byte-compares every output file with a
host-placement run on the CPU. Then it drives the sort-engine tools at the
10M-read dedup/sort benchmark's size (gzfastq_uniq, gzfastq_sort -s/-n;
fast and generic routes and the default placement), gzfastq_uniq PE,
gzfastq_uniqQ, gzfastq_uniq_sort, ordered_uniq and the 2-bit codec, each
byte-compared with a run of the port on the CPU. Then fastqc SE on one
lane file (10M x 100 bp, Illumina tile names) and PE on 1,048,576 pairs,
forced to the card and in the default placement (every TSV and PNG; PE
against a host-placement run on the CPU, SE's two runs against each
other and the lane's first 2,097,152 reads against a host-placement run);
fastq_count_kthread -H -L -t 2 on the
generic route, cuda against cpu; and each host-only tool once. Then the
BAM pileup tools on bench_pileup.py's WGS-shaped BAM (2^23 reads over 24 x
100 Mbp) and its small genome (2^20 reads over 4 x 5 Mbp), made and
indexed by the port: bam2depth and bam2wig with the sparse sweep forced
onto the card and in the default placement or every pileup mode, the
dense engine's negative-start fallback onto the card, bam_sliding_count,
bamSplitChr and index, each against a host-placement run on the CPU;
then one profiled sparse run and the sweep alone on one chromosome.
Then the warm server: `serve` in a thread on the card, with real CLI
processes routed to it through NGSTPU_SERVER (fastq_count on the generic
route, both pipeline routes, fastqc SE and bam2depth -W), each warm run
byte-compared with and timed against fresh CLI processes; a request that
runs out of device memory; `serve` as a process; one NGSTPU_TRACE run.
Then ops/align.py's batched Smith-Waterman on one bwa-mem-sized batch
(65,536 pairs of 150 bp), timed, held against a CPU run and the scalar
oracles. Last, the parallel layer on four shards of the card: the sharded
QC step (4 x 262,144 x 128 reads, one qc_hist launch a shard) against
qc_step on the whole batch on the card and the CPU; the sharded pileup on
the WGS BAM's first chromosome against one shard and a host bincount; the
distributed dedup and sort on the 10M-read input against the single-card
dedup_groups and lex_argsort; the process-group backend on a one-rank
NCCL group; the dry run; scalebench's one-card row.

Any failed check exits non-zero. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".cache" / "chip_smoke"
SORT_ROWS, SORT_WORDS = 1 << 21, 7
N_READS, READ_LEN, TRIM = 1 << 21, 100, (0, 50)
OUTPUTS = (".count.tsv", ".trim.fastq", "_uniq.fq", "_sortKeyUniq.fq")
BIG_READS = 10_000_000  # bench.py's gzfastq_uniq + gzfastq_sort input
UNIQQ_READS = 1 << 18
LANE_READS = 10_000_000  # one lane file of BASELINE config 3's size
FASTQC_PAIRS = 1 << 20


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


def same_file(a: pathlib.Path, b: pathlib.Path) -> bool:
    """Byte equality; gzip files and BAMs compare decompressed."""
    import gzip

    opener = gzip.open if a.name.endswith((".gz", ".bam")) else open
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        while True:
            x, y = fa.read(64 << 20), fb.read(64 << 20)
            if x != y:
                return False
            if not x:
                return True


# NovaSeq's binned quality scores ('#' Q2, '-' Q12, '8' Q23, 'F' Q37) and
# their shares in a typical lane
BINNED = (b"#-8F", (0.02, 0.05, 0.08, 0.85))


def hist_input(kind: str, B: int, L: int, seed: int):
    """One kernel-phase batch, made on the card from a seed: (qual uint8
    [B, L], lens int32 [B]). "uniform": qualities 33..74 with 2% wild bytes
    (some >= 128, never counted) and lengths 0..L; "lane": the same with
    lengths 0..READ_LEN; "100bp": qualities 33..74, every read READ_LEN
    long; "binned": NovaSeq's four binned values, every read READ_LEN."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "binned":
        vals = torch.tensor(list(BINNED[0]), dtype=torch.uint8, device="cuda")
        cum = torch.tensor(BINNED[1], device="cuda").cumsum(0)[:-1]
        q = torch.empty((B, L), dtype=torch.uint8, device="cuda")
        for lo in range(0, B, 1 << 20):
            hi = min(B, lo + (1 << 20))
            u = torch.rand((hi - lo, L), device="cuda", generator=g)
            q[lo:hi] = vals[torch.bucketize(u, cum, right=True)]
    else:
        q = torch.randint(33, 75, (B, L), dtype=torch.uint8, device="cuda",
                          generator=g)
    if kind in ("uniform", "lane"):
        wild = torch.rand(q.shape, device="cuda", generator=g) < 0.02
        q[wild] = torch.randint(0, 256, (int(wild.sum()),), dtype=torch.uint8,
                                device="cuda", generator=g)
        del wild
        top = L if kind == "uniform" else READ_LEN
        ln = torch.randint(0, top + 1, (B,), dtype=torch.int32, device="cuda",
                           generator=g)
    else:
        ln = torch.full((B,), READ_LEN, dtype=torch.int32, device="cuda")
    return q, ln


# (name, rows, cycles, input kind, n_cycle, n_len, rows not counted): the
# generic path's QCAccumulator launches (512 cycles, 512 length bins), the
# composite's 100 bp reads, fastqc's lane launch with uniform and binned
# qualities, and fastqc_stats' full-width launch at L = 600 with max_len 300
# and 600 (602 bins: those past the kernel's 512 shared ones go to global
# atomics)
HIST_SHAPES = (
    ("262144x128", 262144, 128, "uniform", 512, 512, 1237),
    ("262144x640", 262144, 640, "uniform", 512, 512, 1237),
    ("262144x128 100bp", 262144, 128, "100bp", 512, 512, 0),
    ("lane 10Mx128", LANE_READS, 128, "lane", 512, 512, 0),
    ("lane 10Mx128 binned", LANE_READS, 128, "binned", 512, 512, 0),
    ("fastqc 262144x600", 262144, 600, "uniform", 600, 302, 0),
    ("fastqc 262144x600 602 bins", 262144, 600, "uniform", 600, 602, 0),
)
MAIN_SHAPE = "262144x128 100bp"  # what the pipeline's generic route launches
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def phase_kernel(card: str) -> dict:
    """The histogram kernel against its plain version at every shape of
    HIST_SHAPES: exact equality (integer counts). Each line gives the
    kernel's time (L2 cold), its bound (bound_bytes over the card's memory
    rate), the share of the bound and the plain version's time."""
    import torch

    from ngstpu_torch.kernels import hist_cuda

    out = {}
    for name, B, L, kind, n_cycle, n_len, short in HIST_SHAPES:
        n = B - short
        q, ln = hist_input(kind, B, L, seed=len(out) + 2025)
        tq = torch.zeros((n_cycle, 128), dtype=torch.int32, device="cuda")
        tl = torch.zeros(n_len, dtype=torch.int32, device="cuda")
        hist_cuda.qc_hist_accumulate_(tq, tl, q, ln, n)
        torch.cuda.synchronize()
        pq, pl = hist_cuda.qc_hist_plain(q, ln, n, n_cycle, n_len)
        err = max(int((tq - pq).abs().max()), int((tl - pl).abs().max()))
        check(err == 0, f"qc_hist kernel != plain at {name}: max abs err "
                        f"{err}")
        check(int(tl.sum()) == n, f"{name}: the length histogram lost rows")
        del pq, pl
        torch.cuda.empty_cache()
        bound = hist_cuda.bound_bytes(ln, n, L, n_cycle) \
            / HBM_BYTES_PER_S * 1e3
        # rotate over copies of the batch (>= 100 MB in all) so the 50 MB
        # L2 does not hold it from one launch to the next
        copies = -(-(100 << 20) // q.numel())
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        turn = itertools.count()
        big = B * L > (1 << 30)

        def kernel():
            hist_cuda.qc_hist_accumulate_(tq, tl, qs[next(turn) % len(qs)],
                                          ln, n)

        ms = cuda_ms(kernel, 10 if big else 60)
        plain_ms = cuda_ms(lambda: hist_cuda.qc_hist_plain(
            qs[next(turn) % len(qs)], ln, n, n_cycle, n_len), 2 if big else 12)
        res = dict(B=B, L=L, n_cycle=n_cycle, n_len=n_len, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, share=bound / ms,
                   err=err)
        line = (f"qc_hist {name} (B={B} L={L} n_valid={n} n_cycle={n_cycle} "
                f"n_len={n_len}): kernel == plain (max_abs_err 0); kernel "
                f"{ms:.4f} ms, bound {bound:.4f} ms, share of bound "
                f"{bound / ms:.3f}, plain {plain_ms:.4f} ms")
        print(f"{line} [{card}]")
        out[name] = res
        del q, qs, ln, tq, tl
        torch.cuda.empty_cache()
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
    del args, res
    # dedup_groups' device bytes per row against the model behind
    # DEVICE_DEDUP_LIMIT (ops/sortengine.py): max(8W + 78, 17W + 30)
    for b in (B, BIG_READS):
        words_np = rng.integers(0, 1 << 32, (b, W), dtype=np.uint32)
        lens_np = rng.integers(30, 101, b, dtype=np.int32)
        sumq_np = rng.integers(0, 4000, b, dtype=np.uint32)
        for w in (1, W):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            g = se.dedup_groups(words_np[:, :w], lens_np, sumq_np, b, gpu)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            print(f"dedup_groups B={b} W={w}: peak device memory {peak} "
                  f"bytes, {peak / b:.1f} per row (model "
                  f"{max(8 * w + 78, 17 * w + 30)}), "
                  f"{peak / (b * w * 4):.2f} per uint32 key byte; groups "
                  f"{g['n_groups']}")


def set_env(env: dict) -> None:
    for name, value in env.items():  # None unsets
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def run_pipeline(path: pathlib.Path, prefix: pathlib.Path, device: str,
                 env: dict) -> dict:
    import torch

    from ngstpu_torch.tools import pipeline

    set_env(env)
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

    # warm-up at a small size: loads the device sort's kernels, so the
    # timed runs below start warm
    small = WORK / "small.fq"
    small.write_bytes(random_fastq_fast(1 << 14, READ_LEN, seed=7))
    t0 = time.monotonic()
    run_pipeline(small, WORK / "small", "cuda", env["cuda"]["fast"])
    print(f"warm-up pipeline run: {time.monotonic() - t0:.2f}s")
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
                check(same_file(a, b),
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
    inputs["generic"].unlink()  # the tools phase reads comp.fq
    return launches


TIMING_LINE = re.compile(r" at \d+\.\d{3} s$")
HOST = {"NGSTPU_LINK": "host", "NGSTPU_NO_FASTPATH": None}
FAST = {"NGSTPU_LINK": "device", "NGSTPU_NO_FASTPATH": None}
GENERIC = {"NGSTPU_LINK": "device", "NGSTPU_NO_FASTPATH": "1"}
DEFAULT = {"NGSTPU_LINK": None, "NGSTPU_NO_FASTPATH": None}


def run_tool(tool: str, argv: list[str], device: str, env: dict) -> dict:
    """One tool run through its main(), as the CLI calls it, with the
    device counters cleared just before and read just after. Returns wall,
    the stderr lines without timings, the cuda counts and the device's
    peak memory above what was allocated before."""
    import importlib

    import torch

    from ngstpu_torch.kernels import hist_cuda
    from ngstpu_torch.ops import fastqc, sortengine, twobit
    from ngstpu_torch.tools.cli import TOOLS

    mod = importlib.import_module(TOOLS[tool])
    set_env(env)
    # the fast routes append their stage walls here (utils/timing.py)
    stages = WORK / "stages.jsonl"
    stages.unlink(missing_ok=True)
    os.environ["NGSTPU_STAGE_JSON"] = str(stages)
    sortengine.SORTS.clear()
    sortengine.PACKS.clear()
    twobit.CODEC.clear()
    fastqc.FASTQC.clear()
    hist_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    err = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(err):
        rc = mod.main(argv, device=device)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check(rc == 0, f"{tool} {argv} on {device}: exit code {rc}")
    counts = {"sorts": sortengine.SORTS["cuda"], "qc_hist": hist_cuda.LAUNCHES}
    for ctr in (sortengine.PACKS, twobit.CODEC, fastqc.FASTQC):
        counts.update({op: n for (op, d), n in ctr.items() if d == "cuda"})
    lines = err.getvalue().splitlines()
    # the tool's own checkpoints ("... at 1.234 s") and stage walls
    timing = [ln.strip() for ln in lines if TIMING_LINE.search(ln)]
    if stages.exists():
        for rec in map(json.loads, stages.read_text().splitlines()):
            timing += [f"{k} {v['wall_s']}s" for k, v in rec.items()
                       if isinstance(v, dict)]
        stages.unlink()
    return dict(wall=wall, counts=counts, timing=timing,
                peak=torch.cuda.max_memory_allocated() - base,
                err=[ln for ln in lines if not TIMING_LINE.search(ln)])


def compare_runs(label: str, tool: str, argv: list[str], outputs: tuple,
                 runs: list, reads: int, card: str) -> dict:
    """Run `tool` once per (tag, device, env) in `runs`, the first being
    the reference. Every later run's output files and stderr lines must
    equal the reference's; each run's outputs are removed once compared.
    Returns {tag: run info}."""
    slug = label.replace(" ", "_").replace("-", "")
    res = {}
    for tag, device, env in runs:
        prefix = WORK / f"{slug}_{tag}"
        info = run_tool(tool, [*argv, "-o", str(prefix)], device, env)
        files = [pathlib.Path(f"{prefix}{suf}") for suf in outputs]
        if res:
            ref_tag = runs[0][0]
            check(info["err"] == res[ref_tag]["err"],
                  f"{label} ({tag}): stderr {info['err']} differs from the "
                  f"{ref_tag} run's {res[ref_tag]['err']}")
            for f, suf in zip(files, outputs):
                check(same_file(f, WORK / f"{slug}_{ref_tag}{suf}"),
                      f"{label} ({tag}): {f.name} differs from the "
                      f"{ref_tag} run")
                f.unlink()
        info["files"] = files
        res[tag] = info
        counts = ", ".join(f"{k} {v}" for k, v in info["counts"].items())
        uniq = [ln for ln in info["err"] if ln.startswith("unique")]
        print(f"{label} {tag} ({'device' if device == 'cuda' else 'host'} "
              f"placement, {device}): wall {info['wall']:.3f}s, "
              f"{reads / info['wall']:.0f} reads/s; cuda counts: "
              f"{counts or 'none'}; peak device memory {info['peak']}"
              f"{'; ' + uniq[0] if uniq else ''} [{card}]")
        print(f"    stages: {'; '.join(info['timing'])}")
    for f in res[runs[0][0]]["files"]:
        f.unlink(missing_ok=True)
    if len(runs) > 1:
        print(f"  {label}: {', '.join(outputs) or 'output'} and stderr of "
              f"{', '.join(t for t, _, _ in runs[1:])} byte-identical to "
              f"the {runs[0][0]} run")
    return res


def phase_tools(card: str) -> None:
    """The sort-engine tools and the 2-bit codec, each held against a run
    of the port on the CPU (every route of ngstpu gives that run's bytes).
    At 10M reads: gzfastq_uniq and gzfastq_sort -s/-n on the fast route
    and the generic route with the work on the card, and in the default
    placement. At 2,097,152 reads (pairs): gzfastq_uniq PE, uniq_sort and
    ordered_uniq; uniqQ at 262,144. The codec on the 10M input, which
    stays on disk for the parallel phase."""
    from ngstpu_torch.ops import sortengine
    from ngstpu_torch.testing.fixtures import (random_fastq_fast,
                                              random_fastq_pair_fast)
    from ngstpu_torch.utils import linkprobe

    lim = sortengine.DEVICE_DEDUP_LIMIT
    print(f"DEVICE_DEDUP_LIMIT = {lim} bytes of uint32 key words "
          f"({lim / 2 ** 30:.3f} GiB; spills past {lim // 28} rows of 7 "
          f"words)")
    t0 = time.monotonic()
    big = WORK / "big.fq"
    big.write_bytes(random_fastq_fast(BIG_READS, READ_LEN, seed=77,
                                      dup_frac=0.3))
    print(f"input: {BIG_READS} x {READ_LEN} bp, {big.stat().st_size} bytes,"
          f" made in {time.monotonic() - t0:.2f}s")
    # the default placement reads the verdict the pipeline phase's probe
    # measured in this process
    set_env(DEFAULT)
    print(f"default placement: link verdict {linkprobe.link_verdict()!r}")
    check(linkprobe.link_verdict() == "device",
          "default placement would not use the card")

    big_runs = [("host", "cpu", HOST), ("fast", "cuda", FAST),
                ("generic", "cuda", GENERIC), ("default", "cuda", DEFAULT)]
    for tool, argv, outputs in (
            ("gzfastq_uniq", ["-1", str(big)],
             ("_uniq.fq", "_sortKeyUniq.fq")),
            ("gzfastq_sort", ["-i", str(big), "-s"], ("_sort_by_seq.fq",)),
            ("gzfastq_sort", ["-i", str(big), "-n"], ("_sort_by_name.fq",))):
        label = tool if tool == "gzfastq_uniq" else f"{tool} {argv[-1]}"
        res = compare_runs(label, tool, argv, outputs, big_runs, BIG_READS,
                           card)
        for tag in ("fast", "generic", "default"):
            check(res[tag]["counts"]["sorts"] > 0,
                  f"{label} ({tag}): no sort ran on the card")
        if argv[-1] == "-n":
            check(res["generic"]["counts"].get("bytes_to_words", 0) > 0,
                  f"{label} (generic): bytes_to_words did not run on the "
                  f"card")
        if tool == "gzfastq_uniq":
            peak = res["generic"]["peak"]
            print(f"  gzfastq_uniq generic: peak device memory {peak} bytes,"
                  f" {peak / BIG_READS:.1f} per row (dedup model at W=7: "
                  f"{17 * 7 + 30})")

    # the 2-bit codec on the card against the numpy codec
    tb = {}
    for tag, device, env in (("host", "cpu", {**GENERIC,
                                              "NGSTPU_LINK": "host"}),
                             ("cuda", "cuda", GENERIC)):
        pack = run_tool("fastq2twobit", ["-i", str(big), "-s", "-o",
                                         str(WORK / f"tb_{tag}")],
                        device, env)
        packed = WORK / f"tb_{tag}_sort_by_seq.fq"
        unpack = run_tool("twoBit2seq", ["-i", str(packed), "-o",
                                         str(WORK / f"tb_{tag}")],
                          device, env)
        tb[tag] = (packed, WORK / f"tb_{tag}.decompress")
        for what, info in (("fastq2twobit -s", pack),
                           ("twoBit2seq", unpack)):
            counts = ", ".join(f"{k} {v}" for k, v in info["counts"].items())
            print(f"{what} {tag} ({device}): wall {info['wall']:.3f}s, "
                  f"{BIG_READS / info['wall']:.0f} reads/s; cuda counts: "
                  f"{counts or 'none'} [{card}]")
            print(f"    stages: {'; '.join(info['timing'])}")
        if tag == "cuda":
            check(pack["counts"].get("pack2bit", 0) == 1,
                  "fastq2twobit: the device pack did not run")
            check(unpack["counts"].get("unpack2bit", 0) == 1,
                  "twoBit2seq: the device unpack did not run")
    for a, b in zip(*tb.values()):
        check(same_file(a, b), f"{b.name} differs from the host codec's")
        a.unlink()
        b.unlink()
    print("  2-bit codec: container and decompressed text byte-identical "
          "to the host codec's")
    # big.fq stays for the parallel phase's distributed dedup and sort

    # smaller inputs: PE pairs, and the generic-route tools at the
    # pipeline's size
    t0 = time.monotonic()
    pe = [WORK / "pe_1.fq", WORK / "pe_2.fq"]
    for path, data in zip(pe, random_fastq_pair_fast(N_READS, READ_LEN,
                                                     seed=78, dup_frac=0.3)):
        path.write_bytes(data)
    print(f"input: {N_READS} pairs x {READ_LEN} bp, made in "
          f"{time.monotonic() - t0:.2f}s")
    res = compare_runs("gzfastq_uniq PE", "gzfastq_uniq",
                       ["-1", str(pe[0]), "-2", str(pe[1])],
                       ("_1_uniq.fq", "_2_uniq.fq"), big_runs[:3], N_READS,
                       card)
    for tag in ("fast", "generic"):
        check(res[tag]["counts"]["sorts"] > 0,
              f"gzfastq_uniq PE ({tag}): no sort ran on the card")
    comp = str(WORK / "comp.fq")
    # gzfastq_uniqQ runs at about 0.12 M reads/s on either side: a quarter
    # of the pipeline's input keeps its check inside the call's time
    uq = WORK / "uq.fq"
    uq.write_bytes(random_fastq_fast(UNIQQ_READS, READ_LEN, seed=123,
                                     dup_frac=0.3))
    small_runs = [("host", "cpu", HOST), ("cuda", "cuda", FAST)]
    for label, tool, argv, outputs, reads in (
            ("gzfastq_uniqQ -S", "gzfastq_uniqQ", ["-1", str(uq), "-S"],
             ("_sortKeyUniq.fq",), UNIQQ_READS),
            ("gzfastq_uniqQ -C", "gzfastq_uniqQ", ["-1", str(uq), "-C"],
             ("_sortKeyUniq.fq",), UNIQQ_READS),
            ("gzfastq_uniq_sort SE", "gzfastq_uniq_sort", ["-1", comp],
             ("_1_uniq.fq.gz",), N_READS),
            ("gzfastq_uniq_sort PE", "gzfastq_uniq_sort",
             ["-1", str(pe[0]), "-2", str(pe[1])],
             ("_1_uniq.fq.gz", "_2_uniq.fq.gz"), N_READS),
            ("ordered_uniq", "ordered_uniq", ["-i", comp], ("",), N_READS),
            ("ordered_uniq -r 20", "ordered_uniq", ["-i", comp, "-r", "20"],
             ("",), N_READS)):
        res = compare_runs(label, tool, argv, outputs, small_runs, reads,
                           card)
        check(res["cuda"]["counts"]["sorts"] > 0,
              f"{label}: no sort ran on the card")
    for path in (*pe, uq):
        path.unlink()

FASTQC_OPS = ("fastqc_stats", "adapter_content", "per_tile_quality",
              "kmer_position_counts")


def compare_dirs(label: str, runs: list, card: str, reads: int, call,
                 expect: int) -> dict:
    """Run `call(tag, device, env, d)` for each (tag, device, env) of
    `runs` with a working directory d of its own; the first run is the
    reference, and every later run must write the same `expect` files
    with the same bytes. Prints each run's wall, reads/s, peak device
    memory, cuda counts and stages. Returns {tag: run info}."""
    res = {}
    ref = None
    for tag, device, env in runs:
        d = WORK / f"{label.replace(' ', '_')}_{tag}"
        d.mkdir()
        info = call(tag, device, env, d)
        names = sorted(f.name for f in d.iterdir())
        check(len(names) == expect and all((d / n).stat().st_size
                                           for n in names),
              f"{label} ({tag}): {len(names)} files, expected {expect} "
              f"non-empty ones: {names}")
        if ref is None:
            ref = d
        else:
            check(names == sorted(f.name for f in ref.iterdir()),
                  f"{label} ({tag}): other files than the {runs[0][0]} run")
            for n in names:
                check(same_file(d / n, ref / n),
                      f"{label} ({tag}): {n} differs from the "
                      f"{runs[0][0]} run")
            shutil.rmtree(d)
        res[tag] = info
        counts = ", ".join(f"{k} {v}" for k, v in info["counts"].items())
        print(f"{label} {tag} ({'device' if device == 'cuda' else 'host'} "
              f"placement, {device}): wall {info['wall']:.3f}s, "
              f"{reads / info['wall']:.0f} reads/s; cuda counts: {counts}; "
              f"peak device memory {info['peak']} [{card}]")
        print(f"    stages: {'; '.join(info['timing'])}")
    shutil.rmtree(ref)
    print(f"  {label}: {expect} files of "
          f"{', '.join(t for t, _, _ in runs[1:])} byte-identical to the "
          f"{runs[0][0]} run")
    return res


def phase_fastqc(card: str) -> int:
    """fastqc SE on one lane file (10M x 100 bp, Illumina names over 96
    tiles, dup_frac 0.3, 8 hot sequences, 1% N calls, adapters in 0.5% of
    reads) and PE on 1,048,576 pairs of the tools phase's kind named the same
    way (with N calls and adapters planted), each forced to the card and
    in the default placement; PE also against the host placement on the
    CPU, SE's default run against its forced one, and the lane's first
    2,097,152 reads forced to the card against the host placement on the
    CPU. Returns the kernel launches of the card runs."""
    from ngstpu_torch.testing.fixtures import (illumina_fastq_fast,
                                              illumina_fastq_pair_fast)

    t0 = time.monotonic()
    lane = WORK / "lane.fq"
    lane.write_bytes(illumina_fastq_fast(
        LANE_READS, READ_LEN, seed=79, n_tiles=96, dup_frac=0.3, hot=8,
        n_frac=0.01, adapter_frac=0.005))
    pe = [WORK / "lane_1.fq", WORK / "lane_2.fq"]
    for path, data in zip(pe, illumina_fastq_pair_fast(
            FASTQC_PAIRS, READ_LEN, seed=78, n_tiles=96, dup_frac=0.3,
            n_frac=0.01, adapter_frac=0.005)):
        path.write_bytes(data)
    head = WORK / "lane_head.fq"
    with open(lane, "rb") as src, open(head, "wb") as dst:
        dst.writelines(itertools.islice(src, 4 * N_READS))
    print(f"input: {LANE_READS} x {READ_LEN} bp ({lane.stat().st_size} "
          f"bytes), its first {N_READS} reads and {FASTQC_PAIRS} pairs, "
          f"Illumina names over 96 tiles, made in "
          f"{time.monotonic() - t0:.2f}s")
    host, cuda, default = (("host", "cpu", HOST), ("cuda", "cuda", FAST),
                           ("default", "cuda", DEFAULT))
    launches = 0
    # the whole lane's host run (53-66 s) is left out: the lane's card runs
    # are held against each other, and its first N_READS reads and PE
    # against the host
    for label, inputs, reads, expect, runs in (
            ("fastqc SE", [lane], LANE_READS, 18, [cuda, default]),
            ("fastqc SE head", [head], N_READS, 18, [host, cuda]),
            ("fastqc PE", pe, FASTQC_PAIRS, 33, [host, cuda, default])):
        res = compare_dirs(
            label, runs, card, reads,
            lambda tag, device, env, d: run_tool(
                "fastqc", [str(d / "qc"), *map(str, inputs)], device, env),
            expect)
        for tag in (t for t in res if t != "host"):
            c = res[tag]["counts"]
            for op in FASTQC_OPS:
                check(c.get(op, 0) == len(inputs),
                      f"{label} ({tag}): {op} ran {c.get(op, 0)} times on "
                      f"the card")
            check(c["qc_hist"] == len(inputs),
                  f"{label} ({tag}): qc_hist launched {c['qc_hist']} times")
            check(c["sorts"] > 0, f"{label} ({tag}): the duplication dedup "
                                  f"did not sort on the card")
            launches += c["qc_hist"]
    for path in (lane, head, *pe):
        path.unlink()
    return launches


def phase_kthread(card: str) -> int:
    """fastq_count_kthread -H -L -t 2 over two 2,097,152-read files on the
    generic route (the chunked reader and QCAccumulator), cuda against
    cpu. Returns the kernel launches of the card run."""
    from ngstpu_torch.testing.fixtures import random_fastq_fast, with_n_calls

    files = [WORK / "comp.fq", WORK / "kt_n.fq"]
    files[1].write_bytes(with_n_calls(
        random_fastq_fast(N_READS, READ_LEN, seed=80), 0.01, seed=80))
    env = {"NGSTPU_NO_FASTPATH": "1", "NGSTPU_QC": None}
    runs = [("host", "cpu", {**env, "NGSTPU_LINK": "host"}),
            ("cuda", "cuda", {**env, "NGSTPU_LINK": "device"})]
    home = os.getcwd()

    def call(tag, device, env, d):
        os.chdir(d)  # the per-file TSVs go to the working directory
        try:
            return run_tool("fastq_count_kthread",
                            ["-H", "-L", "-t", "2", "-o", "merged.tsv",
                             *map(str, files)], device, env)
        finally:
            os.chdir(home)

    res = compare_dirs("fastq_count_kthread", runs, card, 2 * N_READS, call,
                       3)
    n = res["cuda"]["counts"]["qc_hist"]
    check(n > 0, "fastq_count_kthread: qc_hist never launched")
    files[1].unlink()
    return n


def phase_host_tools() -> None:
    """Each host-only tool once through the CLI: exit code 0 and
    non-empty outputs; the inputs come from the port's own fixtures."""
    from ngstpu_torch.testing.fixtures import numbered_fastq
    from ngstpu_torch.tools import cli

    d = WORK / "host_tools"
    d.mkdir()
    comp = str(WORK / "comp.fq")
    for mate, ids in ((1, range(0, 3000, 2)), (2, range(0, 3000, 3))):
        (d / f"p{mate}.fq").write_bytes(numbered_fastq(b"@pp_", ids, 50,
                                                       seed=80 + mate))
    (d / "q6.fq").write_bytes(numbered_fastq(b"@q6_", range(2000), 80,
                                             seed=83,
                                             qual_alphabet=b"#/7<BF"))
    home = os.getcwd()
    for argv, outputs in (
            (["fastq_trim", "-i", comp, "-e", "50", "-o", str(d / "tr")],
             ["tr.trim.fastq"]),
            (["gzfastq_sample", "-1", comp, "-n", "1000"],
             ["comp.fq.*.gz"]),
            (["pick_pair", "-1", str(d / "p1.fq"), "-2", str(d / "p2.fq"),
              "-o", str(d / "pp")], ["pp_1_PE.fq.gz", "pp_2_SE.fq.gz"]),
            (["gzfastq_mrle", "-i", str(d / "q6.fq"), "-o", str(d / "rle")],
             ["rle_sort_by_seq.fq"])):
        out = io.TextIOWrapper(io.BytesIO())  # gzfastq_mrle's self-check
        os.chdir(d)
        try:
            t0 = time.monotonic()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(["--device", "cuda", *argv])
        finally:
            os.chdir(home)
        check(rc == 0, f"{argv[0]}: exit code {rc}")
        for pattern in outputs:
            check(any(f.stat().st_size for f in d.glob(pattern)),
                  f"{argv[0]}: no output {pattern}")
        print(f"{argv[0]}: exit code 0, {', '.join(outputs)} written in "
              f"{time.monotonic() - t0:.3f}s")
    shutil.rmtree(d)


# bench_pileup.py's config-5 input (24 x 100 Mbp, 2^23 reads x 100 bp, seed
# 7) and its small-genome regime (4 x 5 Mbp, 2^20 reads)
WGS_REFS = [(f"chr{i + 1}", 100_000_000) for i in range(24)]
WGS_READS = 1 << 23
SMALL_REFS = [(f"chr{i + 1}", 5_000_000) for i in range(4)]
SMALL_READS = 1 << 20
# the reference of every BAM run: the host placement on the CPU in the
# default pileup mode; the sparse route forced onto the card; the card in
# a pileup mode of choice; the default placement
BAM_HOST = {"NGSTPU_PILEUP_MODE": None, "NGSTPU_LINK": "host"}
SPARSE = {"NGSTPU_PILEUP_MODE": "sparse", "NGSTPU_LINK": "device"}
BAM_DEFAULT = {"NGSTPU_PILEUP_MODE": None, "NGSTPU_LINK": None}


def bam_mode(mode: str) -> dict:
    return {"NGSTPU_PILEUP_MODE": mode, "NGSTPU_LINK": "device"}


def bam_runs(label: str, tool: str, argv: list[str], runs: list, card: str,
             reads: int, genome: int, after=None) -> dict:
    """`tool` through the port's CLI once per (tag, device, env) of `runs`,
    each in a working directory of its own (the bedGraph lands there; OUT
    in argv names the output prefix there). The first run is the
    reference: every later one must write the same files with the same
    bytes (BAMs decompressed), the same standard output and the same
    stderr apart from timings. `after(d)`, when given, runs after each run
    (to move files written beside the input into d). The sweep counter is
    cleared just before each run and read just after. Prints each run's
    wall, reads/s, bp/s (the genome's bp over the wall) and sweeps."""
    from ngstpu_torch.ops.bamops import PILEUP
    from ngstpu_torch.tools import cli

    slug = label.replace(" ", "_").replace("-", "").replace(":", "")
    res, ref = {}, None
    home = os.getcwd()
    for tag, device, env in runs:
        d = WORK / f"{slug}_{tag}"
        d.mkdir()
        args = [str(d / "o") if a == "OUT" else a for a in argv]
        set_env(env)
        PILEUP.clear()
        out, err = io.StringIO(), io.StringIO()
        os.chdir(d)
        try:
            t0 = time.monotonic()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["--device", device, tool, *args])
            if device == "cuda":
                import torch

                torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            os.chdir(home)
        check(rc == 0, f"{label} ({tag}): exit code {rc}: "
                       f"{err.getvalue()[-2000:]}")
        if after is not None:
            after(d)
        sweeps = PILEUP["sparse_pileup_sweep", "cuda"]
        check(not PILEUP["sparse_pileup_sweep", "cpu"],
              f"{label} ({tag}): the sweep ran on the CPU")
        info = dict(wall=wall, sweeps=sweeps, out=out.getvalue(),
                    err=[ln.replace(str(d), "DIR")
                         for ln in err.getvalue().splitlines()
                         if not TIMING_LINE.search(ln)],
                    names=sorted(f.name for f in d.iterdir()))
        check(info["names"] and all((d / n).stat().st_size
                                    for n in info["names"]),
              f"{label} ({tag}): empty or missing outputs {info['names']}")
        if ref is None:
            ref = d
        else:
            first = res[runs[0][0]]
            for key in ("names", "out", "err"):
                check(info[key] == first[key],
                      f"{label} ({tag}): {key} {info[key]} differs from the "
                      f"{runs[0][0]} run's {first[key]}")
            for n in info["names"]:
                check(same_file(d / n, ref / n),
                      f"{label} ({tag}): {n} differs from the {runs[0][0]} "
                      f"run")
            shutil.rmtree(d)
        res[tag] = info
        print(f"{label} {tag} ({device}): wall {wall:.3f}s, "
              f"{reads / wall:.0f} reads/s, {genome / wall:.0f} bp/s; cuda "
              f"sweeps {sweeps} [{card}]")
    shutil.rmtree(ref)
    if len(runs) > 1:
        print(f"  {label}: {len(res[runs[0][0]]['names'])} files, stdout and "
              f"stderr of {', '.join(t for t, _, _ in runs[1:])} "
              f"byte-identical to the {runs[0][0]} run")
    return res


def phase_bam(card: str) -> dict:
    """The BAM pileup tools on bench_pileup.py's WGS-shaped input and its
    small genome, each run held against a host-placement run of the port
    on the CPU in the default pileup mode. bam2depth -W and bam2wig on the
    WGS BAM with the sparse route forced onto the card (one sweep per
    chromosome with events) and bam2depth in the default placement; on the
    small genome both tools in dense, events and sparse-on-card; the dense
    engine's negative-start fallback into the sparse route on the card;
    bam_sliding_count with and without -r, bamSplitChr and index. Then one
    more sparse bam2depth on the WGS BAM under torch.profiler. Returns the
    first chromosome's pileup events (pos, delta) for the parallel
    phase."""
    from ngstpu_torch.io.bam import choose_pileup_mode
    from ngstpu_torch.testing.bamfixtures import (encode_record, make_bam,
                                                  random_bam_fast)
    from ngstpu_torch.utils import linkprobe

    sweeps = {}
    bams = {}
    for name, refs, reads in (("wgs", WGS_REFS, WGS_READS),
                              ("small", SMALL_REFS, SMALL_READS)):
        t0 = time.monotonic()
        bams[name] = WORK / f"{name}.bam"
        random_bam_fast(str(bams[name]), refs, reads, seed=7)
        print(f"input: {name} BAM, {reads} reads x 100 bp over "
              f"{len(refs)} x {refs[0][1]} bp, {bams[name].stat().st_size} "
              f"bytes, made in {time.monotonic() - t0:.2f}s")
    host = ("host", "cpu", BAM_HOST)
    for name, refs, reads in (("wgs", WGS_REFS, WGS_READS),
                              ("small", SMALL_REFS, SMALL_READS)):
        bai = f"{bams[name]}.bai"  # where bam_sliding_count -r looks
        bam_runs(f"index {name}", "index", [str(bams[name]), "OUT"],
                 [host, ("cuda", "cuda", BAM_HOST)], card, reads,
                 sum(n for _, n in refs),
                 after=lambda d, bai=bai: shutil.copy(d / "o", bai))

    # the WGS BAM: the sparse route on the card, then the default placement
    wgs, genome = str(bams["wgs"]), sum(n for _, n in WGS_REFS)
    for label, tool, argv in (
            ("bam2depth WGS", "bam2depth",
             ["-W", "-w", "20000", "-o", "OUT", wgs]),
            ("bam2wig WGS", "bam2wig", ["-o", "OUT", wgs])):
        runs = [host, ("sparse", "cuda", SPARSE)]
        if tool == "bam2depth":
            runs.append(("default", "cuda", BAM_DEFAULT))
        res = bam_runs(label, tool, argv, runs, card, WGS_READS, genome)
        check(res["sparse"]["sweeps"] == len(WGS_REFS),
              f"{label}: {res['sparse']['sweeps']} sweeps on the card, "
              f"expected one per chromosome with events ({len(WGS_REFS)})")
        sweeps[label] = res["sparse"]["sweeps"]
        if tool == "bam2depth":
            set_env(BAM_DEFAULT)
            print(f"  default placement: pileup mode "
                  f"{choose_pileup_mode(wgs)!r}, link verdict "
                  f"{linkprobe.link_verdict()!r}, cuda sweeps "
                  f"{res['default']['sweeps']}")

    # the small genome: every pileup mode, the sparse one on the card
    small, genome = str(bams["small"]), sum(n for _, n in SMALL_REFS)
    for label, tool, argv in (
            ("bam2depth small", "bam2depth", ["-W", "-o", "OUT", small]),
            ("bam2wig small", "bam2wig", ["-o", "OUT", small])):
        res = bam_runs(label, tool, argv,
                       [host, ("dense", "cuda", bam_mode("dense")),
                        ("events", "cuda", bam_mode("events")),
                        ("sparse", "cuda", SPARSE)],
                       card, SMALL_READS, genome)
        check(res["sparse"]["sweeps"] == len(SMALL_REFS)
              and not res["dense"]["sweeps"] and not res["events"]["sweeps"],
              f"{label}: cuda sweeps {[r['sweeps'] for r in res.values()]}")
        sweeps[label] = res["sparse"]["sweeps"]

    # a negative-start record on chromosome 2: the dense engine writes
    # chromosome 1, then raises DensePileupUnsupported (small chunks, as in
    # tests/test_bam_tools.py), and the tool reruns on the sparse route
    seq = "ACGT" * 25
    recs = [encode_record(f"a{i}", 0, 10 + i, 30, "100M", seq)
            for i in range(800)]
    recs += [encode_record(f"b{i}", 1, 5 + i, 30, "100M", seq)
             for i in range(800)]
    recs += [encode_record("bad", 1, -7, 30, "100M", seq)]
    mid = WORK / "mid.bam"
    make_bam(str(mid), [("c1", 5000), ("c2", 4000)], recs)
    from ngstpu_torch.io import bam as iobam

    dense = iobam.stream_depth_dense
    iobam.stream_depth_dense = lambda p, m, **kw: dense(p, m, chunk_bytes=2048,
                                                        **kw)
    try:
        res = bam_runs("bam2depth negative start", "bam2depth",
                       ["-W", "-w", "700", "-o", "OUT", str(mid)],
                       [host, ("dense", "cuda", bam_mode("dense"))], card,
                       len(recs), 9000)
    finally:
        iobam.stream_depth_dense = dense
    check(res["dense"]["sweeps"] == 2,
          f"negative start: {res['dense']['sweeps']} cuda sweeps, expected "
          f"2 (the dense engine's fallback did not reach the card)")
    sweeps["bam2depth negative start"] = res["dense"]["sweeps"]

    # the host-only tools on the small genome (the PNG lands beside the
    # input: moved into the run's directory to be compared too)
    png = pathlib.Path(small + "_hits.png")
    host_runs = [host, ("cuda", "cuda", BAM_HOST)]
    for label, argv in (("bam_sliding_count", []),
                        ("bam_sliding_count -r", ["-r", "chr1:1-1000000"])):
        bam_runs(label, "bam_sliding_count",
                 ["-w", "5000", *argv, "-o", "OUT", small], host_runs, card,
                 SMALL_READS, genome,
                 after=lambda d: shutil.move(png, d / png.name))
    bam_runs("bamSplitChr", "bamSplitChr", ["-o", "OUT", small], host_runs,
             card, SMALL_READS, genome)

    profile_bam(wgs, card)
    chr1 = time_sweep(wgs, card)
    print(f"PILEUP cuda sweeps by run: {sweeps}")
    return chr1


def sparse_bam2depth(wgs: str, profiler) -> float:
    """One sparse bam2depth -W on the WGS BAM on the card inside the
    context manager `profiler`; returns its wall."""
    import torch

    from ngstpu_torch.tools import bam2depth

    d = WORK / "bam_profile"
    d.mkdir()
    set_env(SPARSE)
    home = os.getcwd()
    os.chdir(d)
    try:
        with profiler:
            t0 = time.monotonic()
            with contextlib.redirect_stderr(io.StringIO()):
                rc = bam2depth.main(["-W", "-w", "20000", "-o", str(d / "o"),
                                     wgs], device="cuda")
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        os.chdir(home)
    shutil.rmtree(d)
    check(rc == 0, "profiled bam2depth failed")
    return wall


def profile_bam(wgs: str, card: str) -> None:
    """One more sparse bam2depth run on the WGS BAM under torch.profiler:
    the card's busy share of the wall and the sweep's device time per
    launch (kernels, then copies)."""
    from torch.profiler import ProfilerActivity, profile

    from ngstpu_torch.ops.bamops import PILEUP
    from ngstpu_torch.tools.profile_pipeline import TOP, device_ops

    PILEUP.clear()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall = sparse_bam2depth(wgs, prof)
    n = PILEUP["sparse_pileup_sweep", "cuda"]
    busy, ops = device_ops(prof)
    copy_ms = sum(ms for name, (ms, _) in ops.items()
                  if name.startswith(("Memcpy", "Memset")))
    kernel_ms = sum(ms for ms, _ in ops.values()) - copy_ms
    print(f"bam2depth WGS sparse profiled (cuda): wall {wall:.3f}s, device "
          f"busy {busy:.3f} ms ({100 * busy / 1e3 / wall:.3f}% of wall), "
          f"{n} sweeps: {kernel_ms / n:.3f} ms of kernels and "
          f"{copy_ms / n:.3f} ms of copies and memsets per launch [{card}]")
    for name, (ms, count) in sorted(ops.items(),
                                    key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {ms:10.3f} ms  x{count:<5d} {name[:90]}")


def time_sweep(wgs: str, card: str) -> tuple[np.ndarray, np.ndarray]:
    """sparse_pileup_sweep alone on the first WGS chromosome's events, on
    the card (CUDA events, warm), with the bound of its I/O: 8 bytes read
    and 9 written per event over the card's memory rate (the sort's own
    passes come on top); and merged_intervals on the same events with
    the device verdict (upload, sweep, pull, compaction) against the
    host verdict (the native radix sweep). The card's sweep is held
    against the same function on CPU tensors (compacted rows, exact).
    PILEUP is not read after these launches. Returns the events."""
    import torch

    from ngstpu_torch.io.bam import DEF_MASK
    from ngstpu_torch.ops import bamops

    _, events = bamops.stream_chrom_events(wgs, DEF_MASK)
    pos, delta = next(events)
    events.close()
    E = len(pos)
    tp = torch.from_numpy(pos).cuda()
    td = torch.from_numpy(delta).cuda()
    g_pos, g_cum, g_last = (x.cpu().numpy() for x in
                            bamops.sparse_pileup_sweep(tp, td, E))
    w_pos, w_cum, w_last = (x.numpy() for x in bamops.sparse_pileup_sweep(
        torch.from_numpy(pos), torch.from_numpy(delta), E))
    check(np.array_equal(g_pos[g_last], w_pos[w_last])
          and np.array_equal(g_cum[g_last], w_cum[w_last]),
          "sparse_pileup_sweep on the card differs from CPU tensors")
    ms = cuda_ms(lambda: bamops.sparse_pileup_sweep(tp, td, E), 20)
    walls = {}
    for verdict in ("device", "host", "device", "host"):
        t0 = time.monotonic()
        bamops.merged_intervals(pos, delta, verdict, device="cuda")
        walls.setdefault(verdict, []).append(time.monotonic() - t0)
    bound = E * 17 / HBM_BYTES_PER_S * 1e3
    print(f"sparse_pileup_sweep chr1 (E={E} events): card {ms:.4f} ms per "
          f"launch (equal to CPU tensors, compacted), I/O bound "
          f"{bound:.4f} ms (share {bound / ms:.3f}); merged_intervals "
          f"device verdict {min(walls['device']) * 1e3:.3f} ms, host "
          f"verdict (native sweep) {min(walls['host']) * 1e3:.3f} ms "
          f"[{card}]")
    return pos, delta


def cli_run(argv: list[str], cwd: pathlib.Path, env: dict,
            rc: int = 0) -> tuple[float, subprocess.CompletedProcess]:
    """One `python -m ngstpu_torch.tools.cli` process in cwd with env;
    returns its wall and result, and fails unless it exits with rc."""
    cwd.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "ngstpu_torch.tools.cli",
                        *argv], cwd=cwd, env=env, capture_output=True,
                       timeout=600)
    wall = time.monotonic() - t0
    check(r.returncode == rc, f"{' '.join(argv)} (in {cwd.name}): exit code "
                              f"{r.returncode}: {r.stderr.decode()[-2000:]}")
    return wall, r


def same_dir(a: pathlib.Path, b: pathlib.Path) -> bool:
    names = sorted(f.name for f in a.iterdir())
    return names == sorted(f.name for f in b.iterdir()) \
        and all(same_file(a / n, b / n) for n in names)


def sock_op(sock: str, op: str) -> dict:
    import socket

    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(60)
        s.connect(sock)
        s.sendall(json.dumps({"op": op}).encode() + b"\n")
        return json.loads(s.makefile("rb").readline())


def wait_for(path: str, alive, seconds: float) -> float:
    """Seconds until `path` exists; fails if alive() turns False first or
    the time runs out."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        check(alive(), f"the server died before it listened on {path}")
        check(time.monotonic() - t0 < seconds,
              f"no server listened on {path} within {seconds}s")
        time.sleep(0.02)
    return time.monotonic() - t0


# the server's environment: the protocol carries none, so these apply to
# every request; a case adds its own (set in this process between
# requests, and given to its cold runs)
SERVER_ENV = {"NGSTPU_LINK": "device", "NGSTPU_QC": None,
              "NGSTPU_NO_FASTPATH": None, "NGSTPU_PILEUP_MODE": None,
              "NGSTPU_SERVER": None, "NGSTPU_TRACE": None,
              "NGSTPU_STAGE_JSON": None}


def phase_server(card: str) -> int:
    """The warm server: serve() in a thread of this process on the card
    (NGSTPU_LINK=device), and real CLI processes routed to it through
    NGSTPU_SERVER, each case against fresh CLI processes of the same
    environment (the cold wall, median of 2): fastq_count -H on the
    2,097,152 x 100 bp input with N calls on the generic route (the
    qc_hist kernel), pipeline -s 0 -e 50 on both routes, fastqc SE on
    2,097,152 tile-named reads and bam2depth -W on the small genome.
    Every run's files and stdout must equal the first cold run's. Then a
    request that runs out of device memory (rc 1, the server answers on),
    `serve` as a process of its own (start, one request, shutdown, exit
    0) and one NGSTPU_TRACE run, whose trace must name the kernel. Returns
    the qc_hist launches made through the server."""
    import statistics
    import tempfile
    import threading

    import torch

    from ngstpu_torch.kernels import hist_cuda
    from ngstpu_torch.testing.fixtures import illumina_fastq_fast, with_n_calls
    from ngstpu_torch.tools import server

    d = WORK / "server"
    d.mkdir()
    t0 = time.monotonic()
    gen = d / "gen.fq"
    gen.write_bytes(with_n_calls((WORK / "comp.fq").read_bytes(), 0.01,
                                 seed=123))
    tiles = d / "tiles.fq"
    tiles.write_bytes(illumina_fastq_fast(
        N_READS, READ_LEN, seed=81, n_tiles=96, dup_frac=0.3, n_frac=0.01,
        adapter_frac=0.005))
    print(f"input: {N_READS} x {READ_LEN} bp with N calls and {N_READS} "
          f"tile-named reads, made in {time.monotonic() - t0:.2f}s")
    trim = ["-s", str(TRIM[0]), "-e", str(TRIM[1])]
    # (label, argv, the server's environment, whether it runs qc_hist)
    cases = [
        ("fastq_count generic", ["fastq_count", "-H", str(gen)],
         {"NGSTPU_NO_FASTPATH": "1"}, True),
        ("pipeline fast", ["pipeline", "-i", str(WORK / "comp.fq"), "-o", "o",
                           *trim], {}, False),
        ("pipeline generic", ["pipeline", "-i", str(gen), "-o", "o", *trim],
         {}, True),
        ("fastqc SE", ["fastqc", "qc", str(tiles)], {}, True),
        ("bam2depth -W small", ["bam2depth", "-W", "-o", "o",
                                str(WORK / "small.bam")], {}, False)]

    def cli_env(extra: dict) -> dict:
        set_env({**SERVER_ENV, **extra})
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), env.get("PYTHONPATH")) if p)
        return env

    sock_dir = tempfile.mkdtemp(prefix="ngt")
    sock = os.path.join(sock_dir, "s")
    check(len(sock) < 100, f"socket path too long for AF_UNIX: {sock}")
    cli_env({})
    thread = threading.Thread(target=server.serve, args=(sock, "cuda"),
                              daemon=True)
    thread.start()
    launches, refs = 0, {}
    try:
        print(f"serve() in a thread: listening after "
              f"{wait_for(sock, thread.is_alive, 120):.3f}s")
        hist_cuda.LAUNCHES = 0  # the server's path: counted from here
        for label, argv, extra, kernel in cases:
            env = cli_env(extra)
            slug = label.replace(" ", "_").replace("-", "")
            runs = [("cold", env)] * 2 \
                + [("warm", {**env, "NGSTPU_SERVER": sock})] * 3
            walls, deltas, reserved = {"cold": [], "warm": []}, [], []
            for k, (kind, run_env) in enumerate(runs):
                out = d / f"{slug}_{k}"
                before = hist_cuda.LAUNCHES
                wall, r = cli_run(argv, out, run_env)
                walls[kind].append(wall)
                if kind == "warm":
                    deltas.append(hist_cuda.LAUNCHES - before)
                    reserved.append(torch.cuda.memory_reserved())
                if k == 0:
                    refs[label] = (out, r.stdout)
                    check(bool(r.stdout) or any(out.iterdir()),
                          f"{label}: no output")
                    continue
                check(same_dir(out, refs[label][0])
                      and r.stdout == refs[label][1],
                      f"{label}: {kind} run {k} differs from the first cold "
                      f"run")
                shutil.rmtree(out)
            check(all(deltas) if kernel else not any(deltas),
                  f"{label}: qc_hist launches through the server {deltas}")
            launches += sum(deltas)
            cold, warm = walls["cold"], walls["warm"]
            print(f"served {label}: cold "
                  f"{' / '.join(f'{w:.3f}' for w in cold)} s (median {statistics.median(cold):.3f} s); warm first "
                  f"{warm[0]:.3f} s, then "
                  f"{' / '.join(f'{w:.3f}' for w in warm[1:])} s (median "
                  f"{statistics.median(warm[1:]):.3f} s); qc_hist launches "
                  f"through the server {deltas}; memory reserved after each "
                  f"request {reserved} bytes; files and stdout of 1 cold "
                  f"and 3 warm runs byte-identical to the first cold run "
                  f"[{card}]")

        # a request that runs out of device memory: rc 1, and the server
        # answers the next one
        label, argv, extra, _ = cases[0]
        env = {**cli_env(extra), "NGSTPU_SERVER": sock}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(0).total_memory
        torch.cuda.set_per_process_memory_fraction((16 << 20) / total)
        try:
            _, r = cli_run(argv, d / "oom", env, rc=1)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        oom = [ln for ln in r.stderr.decode().splitlines()
               if "OutOfMemoryError" in ln]
        check(bool(oom), f"the out-of-memory request: "
                         f"{r.stderr.decode()[-2000:]}")
        check(sock_op(sock, "ping") == {"rc": 0}, "no answer after the OOM")
        wall, r = cli_run(argv, d / "after_oom", env)
        check(r.stdout == refs[label][1], "the request after the OOM differs")
        print(f"served {label} with the card's memory capped at 16 MB: rc 1 "
              f"({oom[0][:160]}); the next request rc 0 in {wall:.3f}s, "
              f"stdout equal [{card}]")

        # serve as a process of its own: start, one request, shutdown
        sock2 = os.path.join(sock_dir, "p")
        env = cli_env(extra)
        log = d / "serve.log"
        with open(log, "wb") as f:
            t0 = time.monotonic()
            proc = subprocess.Popen(
                [sys.executable, "-m", "ngstpu_torch.tools.cli", "serve",
                 "--socket", sock2], cwd=d, env=env,
                stdout=subprocess.DEVNULL, stderr=f)
        try:
            up = wait_for(sock2, lambda: proc.poll() is None, 300)
            wall, r = cli_run(argv, d / "proc",
                              {**env, "NGSTPU_SERVER": sock2})
            check(r.stdout == refs[label][1],
                  "serve as a process: stdout differs from the cold run")
            check(sock_op(sock2, "shutdown") == {"rc": 0},
                  "serve as a process: no answer to shutdown")
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(rc == 0, f"serve as a process exited {rc}: {log.read_text()}")
        warm_line = [ln for ln in log.read_text().splitlines()
                     if "warm-up" in ln]
        print(f"serve as a process: listening after {up:.3f}s "
              f"({warm_line[0] if warm_line else 'no warm-up line'}); "
              f"{label} through it {wall:.3f}s, stdout equal; shutdown, exit "
              f"code 0 [{card}]")
    finally:
        if thread.is_alive():
            sock_op(sock, "shutdown")
            thread.join(timeout=120)
        shutil.rmtree(sock_dir, ignore_errors=True)
    check(not thread.is_alive(), "the server thread did not stop")

    # one traced local run: the trace must name the kernel
    label, argv, extra, _ = cases[2]
    trace = d / "trace"
    env = {**cli_env(extra), "NGSTPU_TRACE": str(trace)}
    wall, r = cli_run(argv, d / "traced", env)
    check(same_dir(d / "traced", refs[label][0]),
          "the traced pipeline's outputs differ")
    files = list(trace.glob("pipeline.*.pt.trace.json"))
    check(len(files) == 1, f"NGSTPU_TRACE wrote {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    hist = [e for e in events if "qc_hist_kernel" in e.get("name", "")]
    check(bool(hist), "the trace names no qc_hist kernel")
    print(f"NGSTPU_TRACE {label}: wall {wall:.3f}s, outputs equal to the "
          f"cold run, trace {files[0].stat().st_size} bytes with "
          f"{len(events)} events, qc_hist_kernel x{len(hist)} "
          f"({sum(e.get('dur', 0) for e in hist):.1f} us) [{card}]")
    set_env(SERVER_ENV)
    shutil.rmtree(d)
    return launches


# one bwa-mem-sized batch (bwa mem's -K chunk of about 10 Mbp, as 150 bp
# reads); sw_score_batch and sw_align_batch over a mate-rescue window,
# sw_extend_batch over qlen + w
ALIGN_PAIRS, ALIGN_QLEN, ALIGN_WINDOW, ALIGN_W = 65536, 150, 512, 100
ALIGN_CPU_PAIRS, ALIGN_ORACLE_PAIRS, ALIGN_MINSC = 4096, 32, 20
# an H100 SXM's INT32 rate: NVIDIA's 67 TFLOP/s FP32 (non-tensor) peak
# over 2 for the fused multiply-add and over 2 again for the SM's 64 INT32
# lanes against its 128 FP32 lanes (NVIDIA's Hopper white paper)
INT32_OPS_PER_S = 16.75e12
# integer operations of one scalar Gotoh cell: the substitution score
# (compare, select, add), H as the max of four terms (3), max(H - q - r,
# 0) (2), the E and F updates (2 each) and the running max (1)
CELL_OPS = 13


def align_targets(rng, q: np.ndarray, Lt: int, offset: bool) -> np.ndarray:
    """Targets [B, Lt] for base codes q [B, Lq] (0..3): random bases,
    where the first half hold their query (2% substitutions; 1-3 bp
    indels in 5% of them) at a random offset, or at offset 0 when not
    `offset` (an extension starts at the seed)."""
    B, Lq = q.shape
    t = rng.integers(0, 4, (B, Lt), dtype=np.uint8)
    R = B // 2
    m = q[:R].copy()
    sub = rng.random((R, Lq)) < 0.02
    m[sub] = (m[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
    off = (rng.integers(0, Lt - Lq + 1, R) if offset
           else np.zeros(R, np.int64))
    t[np.arange(R)[:, None], off[:, None] + np.arange(Lq)] = m
    for i in np.nonzero(rng.random(R) < 0.05)[0]:
        pos, n = int(rng.integers(10, Lq - 10)), int(rng.integers(1, 4))
        if rng.random() < 0.5:
            row = np.concatenate([m[i, :pos], rng.integers(0, 4, n, np.uint8),
                                  m[i, pos:]])
        else:
            row = np.concatenate([m[i, :pos], m[i, pos + n:],
                                  rng.integers(0, 4, n, np.uint8)])
        seg = row[:Lt - off[i]]
        t[i, off[i]:off[i] + len(seg)] = seg
    return t


def phase_align(card: str) -> dict:
    """ops/align.py on one bwa-mem-sized batch on the card: each function
    timed by CUDA events (warm), its kernel launches per call from the
    profiler, GCUPS (B * Lq * Lt over the time) and its bound; the first
    4,096 pairs held exactly against a CPU run of the same function, and
    32 pairs against the scalar oracles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ngstpu_torch.ops import align
    from ngstpu_torch.tools.profile_pipeline import device_ops

    B, Lq = ALIGN_PAIRS, ALIGN_QLEN
    R = B // 2
    rng = np.random.default_rng(2026)
    t0 = time.monotonic()
    codes = rng.integers(0, 4, (B, Lq), dtype=np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    q = acgt[codes]
    t512 = acgt[align_targets(rng, codes, ALIGN_WINDOW, True)]
    t250 = acgt[align_targets(rng, codes, Lq + ALIGN_W, False)]
    h0 = rng.integers(20, 61, B).astype(np.int32)
    qlens = np.full(B, Lq, np.int32)
    print(f"align inputs: {B} pairs of {Lq} bp queries, targets of "
          f"{ALIGN_WINDOW} and {Lq + ALIGN_W} bp, made in "
          f"{time.monotonic() - t0:.2f}s")
    host = {"q": q, "qlens": qlens, "t512": t512,
            "tlens512": np.full(B, ALIGN_WINDOW, np.int32), "t250": t250,
            "tlens250": np.full(B, Lq + ALIGN_W, np.int32), "h0": h0}
    gpu = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    cpu = {k: torch.from_numpy(v[:ALIGN_CPU_PAIRS]) for k, v in host.items()}
    cells = torch.zeros(B, dtype=torch.int64, device="cuda")

    def score(a, cells=None):
        return {"score": align.sw_score_batch(a["q"], a["qlens"], a["t512"],
                                              a["tlens512"])}

    def local(a, cells=None):
        return align.sw_align_batch(a["q"], a["qlens"], a["t512"],
                                    a["tlens512"])

    def extend(a, cells=None):
        return dict(zip(("score", "qle", "tle"), align.sw_extend_batch(
            a["q"], a["qlens"], a["t250"], a["tlens250"], a["h0"], w=ALIGN_W,
            cells=cells)))

    # name: (target width, the call as a dict of outputs, what it reads)
    specs = {"sw_score_batch": (ALIGN_WINDOW, score, ("q", "qlens", "t512",
                                                      "tlens512")),
             "sw_align_batch": (ALIGN_WINDOW, local, ("q", "qlens", "t512",
                                                      "tlens512")),
             "sw_extend_batch": (Lq + ALIGN_W, extend,
                                 ("q", "qlens", "t250", "tlens250", "h0"))}
    res, outs = {}, {}
    for name, (Lt, fn, reads) in specs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn(gpu, cells)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_ms(lambda: fn(gpu), 3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(gpu)
            torch.cuda.synchronize()
        _, ops = device_ops(prof)
        copies = sum(c for n, (_, c) in ops.items()
                     if n.startswith(("Memcpy", "Memset")))
        launches = sum(c for _, c in ops.values()) - copies
        cpu_cells = torch.zeros(ALIGN_CPU_PAIRS, dtype=torch.int64)
        t0 = time.monotonic()
        ref = fn(cpu, cpu_cells)
        cpu_s = time.monotonic() - t0
        for key, want in ref.items():
            got = out[key][:ALIGN_CPU_PAIRS].cpu()
            check(got.dtype == want.dtype == torch.int32
                  and torch.equal(got, want),
                  f"{name} {key}: the card differs from the CPU on the first "
                  f"{ALIGN_CPU_PAIRS} pairs")
        if name == "sw_extend_batch":  # the band's cells, data-dependent
            check(torch.equal(cells[:ALIGN_CPU_PAIRS].cpu(), cpu_cells),
                  f"{name}: the card's band cells differ from the CPU's")
            n_cells = int(cells.sum())
        else:
            n_cells = int((host["qlens"].astype(np.int64)
                           * host[reads[-1]]).sum())
        io_bytes = sum(host[k].nbytes for k in reads) \
            + sum(v.numel() * v.element_size() for v in out.values())
        by_ops = CELL_OPS * n_cells / INT32_OPS_PER_S * 1e3
        by_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
        bound = max(by_ops, by_bytes)
        gcups = B * Lq * Lt / (ms / 1e3) / 1e9
        res[name] = dict(ms=ms, gcups=gcups, launches=launches,
                         bound_ms=bound,
                         bound_by="operations" if by_ops >= by_bytes
                         else "bytes", share=bound / ms)
        outs[name] = {k: v.cpu().numpy() for k, v in out.items()}
        print(f"align {name} (B={B}, Lq={Lq}, Lt={Lt}): card {ms:.3f} ms per "
              f"call, {gcups:.3f} GCUPS (B*Lq*Lt over the time); {launches} "
              f"kernel launches and {copies} copies per call (profiler); "
              f"bound {bound:.4f} ms by {res[name]['bound_by']} ({n_cells} "
              f"cells x {CELL_OPS} int32 ops at {INT32_OPS_PER_S:.4g}/s: "
              f"{by_ops:.4f} ms; {io_bytes} bytes at {HBM_BYTES_PER_S:.3g} "
              f"B/s: {by_bytes:.4f} ms), share {bound / ms:.5f}; peak device "
              f"memory {peak} bytes; the first {ALIGN_CPU_PAIRS} pairs equal "
              f"to a CPU run ({cpu_s:.2f}s) [{card}]")
        del out, ref
        torch.cuda.empty_cache()

    # the scalar oracles on 16 related and 16 random pairs
    t0 = time.monotonic()
    pairs = list(range(ALIGN_ORACLE_PAIRS // 2)) + list(
        range(R, R + ALIGN_ORACLE_PAIRS // 2))
    s = outs["sw_align_batch"]
    score2, te2 = align.kswr_second_best(
        s["row_max"][pairs], s["score"][pairs], s["te"][pairs], ALIGN_MINSC, 1)
    for n, i in enumerate(pairs):
        qb, tb = bytes(q[i]), bytes(t512[i])
        check(align.sw_score_numpy(qb, tb)
              == outs["sw_score_batch"]["score"][i],
              f"sw_score_batch pair {i} != sw_score_numpy")
        ref = align.ksw_align_scalar(qb, tb, minsc=ALIGN_MINSC)
        check((ref["score"], ref["te"], ref["qe"], ref["score2"], ref["te2"])
              == (s["score"][i], s["te"][i], s["qe"][i], score2[n], te2[n])
              and np.array_equal(ref["row_max"], s["row_max"][i]),
              f"sw_align_batch pair {i} != ksw_align_scalar")
        e = outs["sw_extend_batch"]
        check(align.ksw_extend_scalar(qb, bytes(t250[i]), int(h0[i]),
                                      w=ALIGN_W)
              == (e["score"][i], e["qle"][i], e["tle"][i]),
              f"sw_extend_batch pair {i} != ksw_extend_scalar")
    related = outs["sw_align_batch"]["score"][:R]
    print(f"align: {len(pairs)} pairs equal to the scalar oracles "
          f"(sw_score_numpy, ksw_align_scalar with second best at minsc "
          f"{ALIGN_MINSC}, ksw_extend_scalar) in "
          f"{time.monotonic() - t0:.2f}s; related pairs' mean score "
          f"{related.mean():.1f}, random pairs' "
          f"{outs['sw_align_batch']['score'][R:].mean():.1f}")
    return res


# scalebench's default per chip (262,144 x 128, 118 bp live) on 4 shards of
# the card; the process-group check's share of the 10M input
PAR_SHARDS, PAR_READS, PAR_LEN, PAR_LIVE = 4, 262144, 128, 118
PG_READS = 1 << 19


def device_launches(fn) -> tuple[int, float]:
    """(device kernels, copies and memsets, busy ms) of one call of fn
    under torch.profiler; the call's qc_hist launches are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ngstpu_torch.kernels import hist_cuda
    from ngstpu_torch.tools.profile_pipeline import device_ops

    before = hist_cuda.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hist_cuda.LAUNCHES = before
    busy, ops = device_ops(prof)
    return sum(c for _, c in ops.values()), busy


def par_qc(card: str) -> int:
    """sharded_qc_step over PAR_SHARDS shards of the card, counted (the
    parallel path's qc_hist launches), held bit for bit against qc_step on
    the whole batch on the card and on the CPU; then timed with its bound
    and one shard's qc_hist launch. Returns the launches."""
    import torch

    from ngstpu_torch.kernels import hist_cuda
    from ngstpu_torch.ops.qcstep import qc_step
    from ngstpu_torch.parallel import dist, mesh

    n, b, L = PAR_SHARDS, PAR_READS, PAR_LEN
    B = n * b
    g = torch.Generator(device="cuda").manual_seed(31)
    seq = torch.randint(65, 85, (B, L), dtype=torch.uint8, device="cuda",
                        generator=g)
    qual = torch.randint(33, 75, (B, L), dtype=torch.uint8, device="cuda",
                         generator=g)
    lens = torch.full((B,), PAR_LIVE, dtype=torch.int32, device="cuda")
    m = mesh.make_mesh(n, devices=[torch.device("cuda", 0)] * n)
    args = dist.shard_batch_arrays(m, seq, qual, lens)
    n_valid = [b] * n
    step = dist.sharded_qc_step(m)

    hist_cuda.LAUNCHES = 0  # the parallel path: counted from here
    merged, gc, packed = step(*args, n_valid)
    torch.cuda.synchronize()
    launches = hist_cuda.LAUNCHES
    check(launches == n, f"sharded_qc_step launched qc_hist {launches} "
                         f"times, expected {n}")

    whole = qc_step(seq, qual, lens, B)
    host = qc_step(seq.cpu(), qual.cpu(), lens.cpu(), B)
    got = dict(merged, gc=torch.cat(gc), packed=torch.cat(packed))
    for k, v in whole.items():
        check(torch.equal(got[k], v) and torch.equal(v.cpu(), host[k]),
              f"sharded_qc_step {k} differs from qc_step on the whole batch "
              f"(card or CPU)")
    check(int(merged["len_hist"].sum()) == B
          and int(merged["cycle_hist"].sum()) == B * PAR_LIVE,
          "sharded_qc_step histogram totals")
    ms = cuda_ms(lambda: step(*args, n_valid), 10)
    whole_ms = cuda_ms(lambda: qc_step(seq, qual, lens, B), 10)
    # bytes: live quality bytes (the histograms), every sequence byte (the
    # pack reads whole rows), lens; written: packed and gc
    nbytes = B * PAR_LIVE + B * L + 4 * B + B * L // 4 + 4 * B
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    q0, l0 = args[1][0], args[2][0]
    tq = torch.zeros((L, 128), dtype=torch.int32, device="cuda")
    tl = torch.zeros(512, dtype=torch.int32, device="cuda")
    copies = [q0] + [q0.clone() for _ in range(3)]  # 134 MB: past the L2
    turn = itertools.count()
    launch_ms = cuda_ms(lambda: hist_cuda.qc_hist_accumulate_(
        tq, tl, copies[next(turn) % 4], l0, b), 40)
    launch_bound = hist_cuda.bound_bytes(l0, b, L, L) / HBM_BYTES_PER_S * 1e3
    n_step, _ = device_launches(lambda: step(*args, n_valid))
    n_whole, _ = device_launches(lambda: qc_step(seq, qual, lens, B))
    print(f"parallel QC: sharded_qc_step on {n} shards of the card, {b} x "
          f"{L} reads each ({PAR_LIVE} bp live, {B} in all): cycle_hist, "
          f"len_hist, composition, gc and packed equal qc_step on the whole "
          f"batch on the card and on the CPU; qc_hist launches {launches}; "
          f"{ms:.4f} ms per step ({B / ms * 1e3:.0f} reads/s, {n_step} "
          f"device launches), whole-batch qc_step {whole_ms:.4f} ms "
          f"({n_whole} launches); bound {bound:.4f} ms ({nbytes} bytes, "
          f"share {bound / ms:.3f}); one shard's qc_hist launch "
          f"{launch_ms:.4f} ms, bound {launch_bound:.4f} ms [{card}]")
    del seq, qual, lens, args, merged, gc, packed, whole, copies
    return launches


def par_pileup(card: str, chr1) -> None:
    """sharded_pileup over PAR_SHARDS shards of the card on the first WGS
    chromosome's events (each block's +1 start and -1 end), against
    depth_deltas + cumsum on one shard and a host bincount."""
    import torch

    from ngstpu_torch.ops.pileup import depth_deltas
    from ngstpu_torch.parallel import dist, mesh

    pos, delta = chr1
    check(bool((np.abs(delta) == 1).all()) and int(delta.sum()) == 0,
          "chr1 events are not one +1 start and one -1 end per block")
    starts, ends = pos[delta > 0], pos[delta < 0]
    n, n_pos = PAR_SHARDS, WGS_REFS[0][1]
    E = len(starts)
    pad = (-E) % n
    starts, ends = (np.pad(x, (0, pad)) for x in (starts, ends))
    valid = np.arange(E + pad) < E
    m = mesh.make_mesh(n, devices=[torch.device("cuda", 0)] * n)
    args = dist.shard_batch_arrays(m, starts, ends, valid)
    fn = dist.sharded_pileup(m, n_pos)
    depth = fn(*args)
    one = torch.cumsum(depth_deltas(*(torch.from_numpy(x).cuda() for x in (
        starts, ends, valid)), n_pos), 0, dtype=torch.int32)[:-1]
    host = np.cumsum(
        np.bincount(np.clip(starts[:E], 0, n_pos), minlength=n_pos + 1)
        - np.bincount(np.clip(ends[:E], 0, n_pos), minlength=n_pos + 1))[:-1]
    check(torch.equal(depth, one), "sharded_pileup != depth_deltas + cumsum")
    check(np.array_equal(depth.cpu().numpy(), host),
          "sharded_pileup != the host bincount")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: fn(*args), 5)
    peak = torch.cuda.max_memory_allocated()
    n_launch, _ = device_launches(lambda: fn(*args))
    nbytes = 9 * (E + pad) + 4 * n_pos  # events read once, depth written
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"parallel pileup: sharded_pileup on {n} shards of the card over "
          f"chr1's {E} blocks ({2 * E} events), n_pos {n_pos}: equal to "
          f"depth_deltas + cumsum on one shard and to a host bincount; "
          f"{ms:.4f} ms per call ({n_launch} device launches), bound "
          f"{bound:.4f} ms (share {bound / ms:.3f}), peak device memory "
          f"{peak} [{card}]")


def par_inputs():
    """config 3's 10M x 100 bp input (the tools phase's big.fq) as the
    -m path of gzfastq_uniq packs it: dna3 words, lengths, quality sums."""
    import torch

    from ngstpu_torch.io.fastq import read_fastq_file
    from ngstpu_torch.ops.hostsort import is_dna3_compatible, \
        sum_quality_host
    from ngstpu_torch.ops.sortengine import pack_words

    t0 = time.monotonic()
    big = WORK / "big.fq"
    batch = read_fastq_file(str(big))
    check(is_dna3_compatible(batch.seq, None), "big.fq is not plain DNA")
    words = pack_words(batch.seq, "dna3", torch.device("cuda"))
    lens = np.ascontiguousarray(batch.lens, np.int32)
    sumq = sum_quality_host(batch.qual)
    del batch
    big.unlink()
    print(f"parallel inputs: {len(lens)} reads of big.fq packed to "
          f"{words.shape[1]} dna3 words in {time.monotonic() - t0:.2f}s")
    return words, lens, sumq


def timed_call(fn):
    """(result, wall seconds, peak device memory reserved) of fn()."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0, torch.cuda.max_memory_reserved()


@contextlib.contextmanager
def dsort_stages(n_rows: int, n: int, pad_factor: float = 2.0):
    """The stages of one distributed_dedup or distributed_sort call of
    n_rows rows over n shards, made inside the block: dsort's
    shard_batch_arrays and _pull are wrapped for it. Yields a dict that
    gets `seconds` (wall of shard: host arrays to the shards; device: the
    exchange and sorts; pull: results to the host; host: the merge or
    cut), `cap` (rows one sender may put in one bucket) and `received`
    (valid rows per shard, from the last array pulled: the valid mask in
    both entry points)."""
    import torch

    from ngstpu_torch.parallel import dsort

    marks = [("", time.monotonic())]
    pulled, pulled_at = [], [0.0]
    shard0, pull0 = dsort.shard_batch_arrays, dsort._pull

    def shard(*a):
        out = shard0(*a)
        torch.cuda.synchronize()
        marks.append(("shard", time.monotonic()))
        return out

    def pull(comm, xs):
        if not pulled:
            torch.cuda.synchronize()
            marks.append(("device", time.monotonic()))
        pulled.append(pull0(comm, xs))
        pulled_at[0] = time.monotonic()
        return pulled[-1]

    rec: dict = {}
    dsort.shard_batch_arrays, dsort._pull = shard, pull
    try:
        yield rec
    finally:
        dsort.shard_batch_arrays, dsort._pull = shard0, pull0
    marks += [("pull", pulled_at[0]), ("host", time.monotonic())]
    rows = n_rows + (-n_rows) % n
    rec.update(cap=int(pad_factor * (rows // n) / n) + 8,
               received=[int(v.sum()) for v in np.split(pulled[-1], n)],
               seconds={name: t - t0 for (_, t0), (name, t)
                        in zip(marks, marks[1:])})


def stage_ms(ex: dict) -> str:
    return ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in ex["seconds"].items())


def par_dsort(card: str, words, lens, sumq) -> dict:
    """distributed_dedup and distributed_sort (length first) over
    PAR_SHARDS shards of the card at config 3's size, held equal to the
    single-card dedup_groups and lex_argsort. Returns the in-process dedup
    of the first PG_READS rows for the process-group check."""
    import torch

    from ngstpu_torch.ops import sortengine as se
    from ngstpu_torch.parallel import dist, dsort, mesh

    n = PAR_SHARDS
    B = len(lens)
    gpu = torch.device("cuda", 0)
    m = mesh.make_mesh(n, devices=[gpu] * n)
    g, one_s, one_peak = timed_call(
        lambda: se.dedup_groups(words, lens, sumq, B, gpu))
    with dsort_stages(B, n) as ex:
        res, s, peak = timed_call(
            lambda: dsort.distributed_dedup(m, words, lens, sumq))
    keys, klens, counts, rep = res
    order = np.lexsort(tuple([lens[g["rep"]]] + [
        words[g["rep"], w] for w in range(words.shape[1] - 1, -1, -1)]))
    check(np.array_equal(rep, g["rep"][order])
          and np.array_equal(counts, g["counts"][order])
          and np.array_equal(keys, words[rep])
          and np.array_equal(klens, lens[rep]),
          "distributed_dedup differs from the single-card dedup_groups")
    # the exchange and per-shard sorts alone (no host merge), profiled
    sharded = dist.shard_batch_arrays(m, words.view(np.int32), lens,
                                      sumq.view(np.int32),
                                      np.arange(B, dtype=np.int32),
                                      np.ones(B, dtype=bool))
    fused = dsort.exchange_dedup(m)
    n_ex, ex_busy = device_launches(lambda: fused(*sharded))
    del sharded
    # bound: words, lens and sums read once; keys, lens, counts and reps
    # of the groups written once
    W, G = words.shape[1], len(counts)
    nbytes = B * (4 * W + 8) + G * (4 * W + 20)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"parallel dedup: distributed_dedup on {n} shards of the card, "
          f"{B} reads: keys, klens, counts and rep equal the single-card "
          f"dedup_groups ({len(counts)} groups); {s * 1e3:.1f} ms "
          f"({B / s:.0f} reads/s), peak reserved {peak} bytes; single card "
          f"{one_s * 1e3:.1f} ms, peak reserved {one_peak}; rows received "
          f"per shard {ex['received']} of {n * ex['cap']} slots (cap "
          f"{ex['cap']} per sender); stages {stage_ms(ex)}; exchange_dedup "
          f"alone: {n_ex} device launches, device busy {ex_busy:.3f} ms; "
          f"bound {bound:.4f} ms ({nbytes} bytes) [{card}]")
    perm_one, one_s, one_peak = timed_call(lambda: se.lex_argsort(
        se.words_tensor(words, gpu), torch.from_numpy(lens).to(gpu),
        length_first=True).cpu().numpy())
    with dsort_stages(B, n) as ex:
        perm, s, peak = timed_call(
            lambda: dsort.distributed_sort(m, words, lens))
    check(np.array_equal(perm, perm_one),
          "distributed_sort differs from the single-card lex_argsort")
    n_sort, sort_busy = device_launches(
        lambda: dsort.distributed_sort(m, words, lens))
    nbytes = B * (4 * W + 4 + 8)  # words and lens read, the perm written
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"parallel sort: distributed_sort (length first) on {n} shards of "
          f"the card, {B} reads: equal to the single-card lex_argsort; "
          f"{s * 1e3:.1f} ms ({B / s:.0f} reads/s), peak reserved {peak} "
          f"bytes; single card {one_s * 1e3:.1f} ms, peak reserved "
          f"{one_peak}; rows received per shard {ex['received']} of "
          f"{n * ex['cap']} slots (cap {ex['cap']} per sender); stages "
          f"{stage_ms(ex)}; {n_sort} device launches, device busy "
          f"{sort_busy:.3f} ms; bound {bound:.4f} ms ({nbytes} bytes) "
          f"[{card}]")
    return dsort.distributed_dedup(m, words[:PG_READS], lens[:PG_READS],
                                   sumq[:PG_READS])


def par_group(card: str, words, lens, sumq, ref) -> None:
    """The process-group backend on a one-rank NCCL group: allreduce_stats
    (the identity with one process), sharded_qc_step (psum: all_reduce)
    and a PG_READS-read distributed_dedup (all_to_all_single, all_gather)
    through it, held equal to the in-process results."""
    import torch
    import torch.distributed as tdist

    from ngstpu_torch.ops.qcstep import qc_step
    from ngstpu_torch.parallel import dist, dsort, mesh, multihost

    torch.cuda.set_device(0)
    init = WORK / "nccl_init"  # the group's rendezvous file
    init.unlink(missing_ok=True)
    tdist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                             world_size=1)
    try:
        m = mesh.make_mesh()
        check(m.group is not None and m.shape == (1,)
              and m.devices[0].type == "cuda",
              f"a one-rank NCCL group made the mesh {m}")
        stats = {"q": np.arange(512, dtype=np.int64)}
        check(np.array_equal(multihost.allreduce_stats(stats)["q"],
                             stats["q"]), "allreduce_stats, one rank")
        g = torch.Generator(device="cuda").manual_seed(32)
        seq = torch.randint(65, 85, (PAR_READS, PAR_LEN), dtype=torch.uint8,
                            device="cuda", generator=g)
        qual = torch.randint(33, 75, (PAR_READS, PAR_LEN), dtype=torch.uint8,
                             device="cuda", generator=g)
        lens_q = torch.full((PAR_READS,), PAR_LIVE, dtype=torch.int32,
                            device="cuda")
        merged, _, _ = dist.sharded_qc_step(m)(
            *dist.shard_batch_arrays(m, seq, qual, lens_q), [PAR_READS])
        whole = qc_step(seq, qual, lens_q, PAR_READS)
        for k, v in merged.items():
            check(torch.equal(v, whole[k]), f"process-group psum of {k}")
        with dsort_stages(PG_READS, 1) as ex:
            res, s, peak = timed_call(lambda: dsort.distributed_dedup(
                m, words[:PG_READS], lens[:PG_READS], sumq[:PG_READS]))
        for a, b in zip(res, ref):
            check(np.array_equal(a, b), "process-group distributed_dedup "
                                        "differs from the in-process one")
        print(f"process group: one-rank NCCL group ({tdist.get_backend()}); "
              f"allreduce_stats is the identity; sharded_qc_step's psum "
              f"(all_reduce) equal to qc_step; distributed_dedup of "
              f"{PG_READS} reads (all_to_all_single, all_gather) equal to the "
              f"in-process {PAR_SHARDS}-shard result in {s * 1e3:.1f} ms "
              f"(stages {stage_ms(ex)}), "
              f"peak reserved {peak} [{card}]")
    finally:
        tdist.destroy_process_group()
        init.unlink(missing_ok=True)


def phase_parallel(card: str, chr1) -> int:
    """The parallel layer (ngstpu_torch/parallel) on the card: the sharded
    QC step (the parallel path's qc_hist launches), the sharded pileup on
    chr1's events, the distributed dedup and sort at config 3's size, the
    process-group backend on a one-rank NCCL group, the dry run on four
    shards of the card and scalebench's one-card row. One card measures
    the structure, not the scaling. Returns the counted launches."""
    from ngstpu_torch.parallel import dryrun, scalebench

    launches = par_qc(card)
    par_pileup(card, chr1)
    words, lens, sumq = par_inputs()
    ref = par_dsort(card, words, lens, sumq)
    par_group(card, words, lens, sumq, ref)
    del words, lens, sumq, ref
    t0 = time.monotonic()
    dryrun.dryrun_multichip(PAR_SHARDS, "cuda")
    print(f"dryrun_multichip({PAR_SHARDS}) on the card: five phases OK in "
          f"{time.monotonic() - t0:.2f}s")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scalebench.main([])
    for line in out.getvalue().splitlines():
        print(f"scalebench: {line}")
    return launches


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not (REPO / "ngstpu_torch").is_dir():
        fail("run from a checkout of the repository: ngstpu_torch/ must sit "
             "beside chip_smoke.py")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    os.environ.setdefault("NGSTPU_SHM_POOL", "0")

    card = card_line()
    print(f"card: {card}")
    from ngstpu_torch.io import native
    from ngstpu_torch.kernels import build

    t0 = time.monotonic()
    check(native.get_lib() is not None, "the native host library did not "
                                        "build or load")
    print(f"native library build: libngsio_torch {native.BUILD_SECONDS:.2f}s "
          f"(load {time.monotonic() - t0:.2f}s)")
    t0 = time.monotonic()
    build.load("qc_hist")
    log = build.BUILD_LOG["qc_hist"]
    print(f"kernel build: qc_hist {log['seconds']:.2f}s "
          f"(load {time.monotonic() - t0:.2f}s)")
    for line in log["log"].splitlines():
        if "ptxas info" in line:
            print(f"  {line.strip()}")

    walls = {}

    def timed(name: str, phase, *args):
        t0 = time.monotonic()
        out = phase(*args)
        walls[name] = round(time.monotonic() - t0, 3)
        return out

    hist = timed("kernel", phase_kernel, card)
    paths = {}
    timed("sorts", phase_sorts, np.random.default_rng(2024))
    paths["pipeline generic"] = timed("pipeline", phase_pipeline, card)
    timed("tools", phase_tools, card)
    paths["fastqc"] = timed("fastqc", phase_fastqc, card)
    paths["fastq_count_kthread"] = timed("kthread", phase_kthread, card)
    timed("host tools", phase_host_tools)
    chr1 = timed("bam", phase_bam, card)
    paths["server"] = timed("server", phase_server, card)
    align = timed("align", phase_align, card)
    paths["parallel"] = timed("parallel", phase_parallel, card, chr1)
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"phase walls (s): {walls}")
    print(f"qc_hist launches by path: {paths}")
    check(all(paths.values()), f"a path never launched qc_hist: {paths}")
    print("align (torch ops, no hand kernel): " + "; ".join(
        f"{name} {r['ms']:.3f} ms, {r['gcups']:.3f} GCUPS, {r['launches']} "
        f"launches, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, share "
        f"{r['share']:.5f}" for name, r in align.items()) + f" [{card}]")

    main_shape = hist[MAIN_SHAPE]
    kernels = [{"name": "qc_hist", "route": "cuda",
                "source": "ngstpu_torch/csrc/qc_hist.cu",
                "replaces": "ngstpu/kernels/hist_pallas.py:27",
                "launches": sum(paths.values()), "paths": paths,
                "max_abs_err": max(h["err"] for h in hist.values()),
                "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
                "bound_ms": main_shape["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "share": main_shape["share"],
                "shape": MAIN_SHAPE,
                "shapes": hist}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
