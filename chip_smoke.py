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
lane file (10M x 100 bp, Illumina tile names) and PE on 2,097,152 pairs,
forced to the card and in the default placement, against a host-placement
run on the CPU (every TSV and PNG); fastq_count_kthread -H -L -t 2 on the
generic route, cuda against cpu; and each host-only tool once. Last, the
BAM pileup tools on bench_pileup.py's WGS-shaped BAM (2^23 reads over 24 x
100 Mbp) and its small genome (2^20 reads over 4 x 5 Mbp), made and
indexed by the port: bam2depth and bam2wig with the sparse sweep forced
onto the card and in the default placement or every pileup mode, the
dense engine's negative-start fallback onto the card, bam_sliding_count,
bamSplitChr and index, each against a host-placement run on the CPU;
then one profiled sparse run and the sweep alone on one chromosome.

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
LANE_READS = 10_000_000  # one lane file of BASELINE config 3's size


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
                 runs: list, reads: int, card: str,
                 compare: bool = True) -> dict:
    """Run `tool` once per (tag, device, env) in `runs`, the first being
    the reference. Every later run's output files and stderr lines must
    equal the reference's (unless not `compare`: timing turns); each run's
    outputs are removed once compared. Returns {tag: run info}."""
    slug = label.replace(" ", "_").replace("-", "")
    res = {}
    for tag, device, env in runs:
        prefix = WORK / f"{slug}_{tag}"
        info = run_tool(tool, [*argv, "-o", str(prefix)], device, env)
        files = [pathlib.Path(f"{prefix}{suf}") for suf in outputs]
        if not compare:
            for f in files:
                f.unlink()
        elif res:
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
    if compare and len(runs) > 1:
        print(f"  {label}: {', '.join(outputs) or 'output'} and stderr of "
              f"{', '.join(t for t, _, _ in runs[1:])} byte-identical to "
              f"the {runs[0][0]} run")
    return res


def phase_tools(card: str) -> None:
    """The sort-engine tools and the 2-bit codec, each held against a run
    of the port on the CPU (every route of ngstpu gives that run's bytes).
    At 10M reads: gzfastq_uniq and gzfastq_sort -s/-n on the fast route
    and the generic route with the work on the card, and in the default
    placement. At 2,097,152 reads (pairs): gzfastq_uniq PE, uniqQ,
    uniq_sort and ordered_uniq. The codec on the 10M input."""
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
        # timing turns: host, device (above), device, host
        compare_runs(label, tool, argv, outputs,
                     [("fast2", "cuda", FAST), ("host2", "cpu", HOST)],
                     BIG_READS, card, compare=False)
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
    big.unlink()

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
    small_runs = [("host", "cpu", HOST), ("cuda", "cuda", FAST)]
    for label, tool, argv, outputs in (
            ("gzfastq_uniqQ -S", "gzfastq_uniqQ", ["-1", comp, "-S"],
             ("_sortKeyUniq.fq",)),
            ("gzfastq_uniqQ -C", "gzfastq_uniqQ", ["-1", comp, "-C"],
             ("_sortKeyUniq.fq",)),
            ("gzfastq_uniq_sort SE", "gzfastq_uniq_sort", ["-1", comp],
             ("_1_uniq.fq.gz",)),
            ("gzfastq_uniq_sort PE", "gzfastq_uniq_sort",
             ["-1", str(pe[0]), "-2", str(pe[1])],
             ("_1_uniq.fq.gz", "_2_uniq.fq.gz")),
            ("ordered_uniq", "ordered_uniq", ["-i", comp], ("",)),
            ("ordered_uniq -r 20", "ordered_uniq", ["-i", comp, "-r", "20"],
             ("",))):
        res = compare_runs(label, tool, argv, outputs, small_runs, N_READS,
                           card)
        check(res["cuda"]["counts"]["sorts"] > 0,
              f"{label}: no sort ran on the card")
    for path in pe:
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
    reads) and PE on the tools phase's 2,097,152 pairs renamed the same
    way (with N calls and adapters planted), each forced to the card and
    in the default placement, against the host placement on the CPU.
    Returns the kernel launches of the card runs."""
    from ngstpu_torch.testing.fixtures import (illumina_fastq_fast,
                                              illumina_fastq_pair_fast)

    t0 = time.monotonic()
    lane = WORK / "lane.fq"
    lane.write_bytes(illumina_fastq_fast(
        LANE_READS, READ_LEN, seed=79, n_tiles=96, dup_frac=0.3, hot=8,
        n_frac=0.01, adapter_frac=0.005))
    pe = [WORK / "lane_1.fq", WORK / "lane_2.fq"]
    for path, data in zip(pe, illumina_fastq_pair_fast(
            N_READS, READ_LEN, seed=78, n_tiles=96, dup_frac=0.3,
            n_frac=0.01, adapter_frac=0.005)):
        path.write_bytes(data)
    print(f"input: {LANE_READS} x {READ_LEN} bp ({lane.stat().st_size} "
          f"bytes) and {N_READS} pairs, Illumina names over 96 tiles, made "
          f"in {time.monotonic() - t0:.2f}s")
    runs = [("host", "cpu", HOST), ("cuda", "cuda", FAST),
            ("default", "cuda", DEFAULT)]
    launches = 0
    for label, inputs, reads, expect in (("fastqc SE", [lane], LANE_READS, 18),
                                         ("fastqc PE", pe, N_READS, 33)):
        res = compare_dirs(
            label, runs, card, reads,
            lambda tag, device, env, d: run_tool(
                "fastqc", [str(d / "qc"), *map(str, inputs)], device, env),
            expect)
        for tag in ("cuda", "default"):
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
    profile_fastqc(lane, card)
    for path in (lane, *pe):
        path.unlink()
    return launches


def profile_fastqc(lane: pathlib.Path, card: str) -> None:
    """One more fastqc SE run on the card under torch.profiler: the
    device's busy time against the wall, and the device ops that take the
    most time (the launches of this run are not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ngstpu_torch.tools.profile_pipeline import TOP, device_ops

    d = WORK / "fastqc_profile"
    d.mkdir()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        info = run_tool("fastqc", [str(d / "qc"), str(lane)], "cuda", FAST)
    torch.cuda.synchronize()
    shutil.rmtree(d)
    busy, ops = device_ops(prof)
    print(f"fastqc SE profiled (cuda): wall {info['wall']:.3f}s, device busy "
          f"{busy:.3f} ms ({100 * busy / 1e3 / info['wall']:.2f}% of wall), "
          f"{sum(c for _, c in ops.values())} device ops [{card}]")
    print(f"    stages: {'; '.join(info['timing'])}")
    for name, (ms, count) in sorted(ops.items(),
                                    key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {ms:10.3f} ms  x{count:<5d} {name[:90]}")


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
    cuda sweeps of the forced-sparse runs."""
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
    time_sweep(wgs, card)
    print(f"PILEUP cuda sweeps by run: {sweeps}")
    return sweeps


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
    """Two more sparse bam2depth runs on the WGS BAM: under torch.profiler,
    the card's busy share of the wall and the sweep's device time per
    launch (kernels, then copies); under cProfile, the host functions that
    take the most time (cProfile's own cost inflates that run's wall)."""
    import cProfile
    import pstats

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
    host = cProfile.Profile()
    wall = sparse_bam2depth(wgs, host)
    stats = pstats.Stats(host)
    print(f"bam2depth WGS sparse under cProfile (cuda): wall {wall:.3f}s; "
          f"host functions by own time [{card}]")
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:2 * TOP]
    for (path, line, func), (_, calls, own, cum, _) in top:
        print(f"  own {own:8.3f}s  cum {cum:8.3f}s  x{calls:<8d} "
              f"{pathlib.Path(path).name}:{line}({func})")


def time_sweep(wgs: str, card: str) -> None:
    """sparse_pileup_sweep alone on the first WGS chromosome's events, on
    the card (CUDA events, warm), with the bound of its I/O: 8 bytes read
    and 9 written per event over the card's memory rate (the sort's own
    passes come on top); and merged_intervals on the same events with
    the device verdict (upload, sweep, pull, compaction) against the
    host verdict (the native radix sweep). The card's sweep is held
    against the same function on CPU tensors (compacted rows, exact).
    PILEUP is not read after these launches."""
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
    timed("bam", phase_bam, card)
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"phase walls (s): {walls}")
    print(f"qc_hist launches by path: {paths}")
    check(all(paths.values()), f"a path never launched qc_hist: {paths}")

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
