"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the metrics.

Everything that belongs to one configuration, traffic mix, metric or tool
is found by name (see Layout), so a later cell or metric is new files and
new entries in BENCHMARK.json, never an edit here. The program under test
is the port (ngstpu_torch): its warm server's request path,
tools/server.py:_run_tool, called in process, back to back, by one caller.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from contextlib import nullcontext
from multiprocessing import get_context
from pathlib import Path
from types import SimpleNamespace

from .gen import fastq as gen

FOLDER = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ngstpu")
# The keys a traffic mix may hold. The harness drives every mix as a
# closed loop with one caller, taking the input sets in turn; a mix that
# asks for another load needs new code here, not a key that nothing reads.
# gzip_level (1-9) writes every input file as .fq.gz at that level, in
# BGZF, the layout bcl2fastq2 writes (gen.fastq.bgzf_file).
TRAFFIC_KEYS = {"tool", "argv", "reads_per_file", "sets", "gzip_level", "why"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _load(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Layout:
    """BENCHMARK.json at `root` and the benchmark's folder: configs as
    BENCHMARK.json's `file` names them, traffic/<mix>.json,
    metrics/<metric>.py (a `read(ctx)` that returns a number or None) and
    refs/<tool>.py, the tool's plain reference: `expected(paths, device,
    sample=1)` from a call's input files, `compare(expected, prefix)`
    giving each number compared for one call whose outputs start with
    `prefix` (its standard output is at prefix + ".stdout"), and `LIMITS`,
    each number's limit. sample > 1 is the reference's control."""

    def __init__(self, root: Path, folder: Path = FOLDER):
        self.root, self.folder = Path(root), Path(folder)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, workload: str) -> SimpleNamespace:
        wl = {w["name"]: w for w in self.bench["workloads"]}.get(workload)
        if wl is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        entry = {c["name"]: c for c in self.bench["configs"]}[wl["config"]]
        cfg = json.loads((self.root / entry["file"]).read_text())
        traffic = json.loads(
            (self.folder / "traffic" / f"{wl['traffic']}.json").read_text())
        unknown = set(traffic) - TRAFFIC_KEYS
        if unknown or traffic.get("sets", 0) < 2:
            raise ValueError(f"traffic {wl['traffic']!r}: keys "
                             f"{sorted(unknown)} are not the harness's, or "
                             "fewer than 2 input sets (a call's answer must "
                             "differ from the previous call's)")
        level = traffic.get("gzip_level", 1)
        if type(level) is not int or not 1 <= level <= 9:
            raise ValueError(f"traffic {wl['traffic']!r}: gzip_level "
                             f"{level!r} is not a whole number from 1 to 9")
        return SimpleNamespace(name=workload, chips=wl["chips"], config=cfg,
                               traffic=traffic)

    def metrics(self, workload: str, kind: str) -> list[dict]:
        """The cell's metrics of `kind` (end_to_end or per_layer)."""
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        return _load(self.folder / "metrics" / f"{metric}.py",
                     f"ngsbench_metric_{metric}")

    def ref(self, tool: str):
        return _load(self.folder / "refs" / f"{tool}.py",
                     f"ngsbench_ref_{tool}")


def prepare_env(root: Path) -> Path:
    """The run's environment, before torch is imported: the program's
    default placement (no NGSTPU_* setting but the private buffer pool),
    caches at fixed paths inside the checkout, and a work directory under
    TMPDIR holding the inputs, outputs and a HOME of the run's own, so the
    link probe measures in every run as in a fresh server. Returns the
    work directory."""
    for k in [k for k in os.environ if k.startswith("NGSTPU_")]:
        del os.environ[k]
    os.environ["NGSTPU_SHM_POOL"] = "0"
    cache = Path(root) / ".cache" / "ngsbench"
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(cache / sub)
    work = Path(tempfile.mkdtemp(prefix="ngsbench-"))
    (work / "home").mkdir()
    os.environ["HOME"] = str(work / "home")
    return work


class MemorySampler:
    """Peak of this process's resident set, VmRSS in /proc/self/status,
    every `period` seconds on a thread of its own. A kernel whose status
    lacks VmRSS fails the run rather than read something else."""

    def __init__(self, period: float = 0.01):
        self.period, self.peak = period, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def sample() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k == "VmRSS":
                    return int(v.split()[0]) * 1024
        raise RuntimeError("/proc/self/status has no VmRSS")

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.sample())
            self._stop.wait(self.period)

    def __enter__(self):
        self.peak = self.sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.sample())


def make_inputs(cell, seed: int, work: Path) -> list[dict]:
    """The mix's input sets, written under `work` from the seed and synced
    to disk, so that no write-back of them falls in the window: per set
    its mate files and their reads and bases. A mix with gzip_level has
    each file compressed to BGZF in a child process of its own as its set
    is written, and keeps only the .fq.gz, with its compressed bytes."""
    t = cell.traffic
    mates = 2 if cell.config["layout"] == "PE" else 1
    level = t.get("gzip_level")
    (work / "in").mkdir()
    sets, pending = [], []
    # zlib's buffers stay out of this process's heap, which the window's
    # peak_rss_gib reads
    with (nullcontext() if level is None else ProcessPoolExecutor(
            t["sets"] * mates, mp_context=get_context("spawn"))) as pool:
        for j in range(t["sets"]):
            paths = [str(work / "in" / f"s{j}_m{m + 1}.fq")
                     for m in range(mates)]
            shape = gen.write_set(cell.config, t["reads_per_file"], seed, j,
                                  paths)
            files = [dict(reads=r, bases=b) for r, b in shape]
            if level is None:
                for p in paths:
                    fd = os.open(p, os.O_RDONLY)
                    os.fsync(fd)
                    os.close(fd)
            else:
                pending += [(f, pool.submit(gen.bgzf_file, p, p + ".gz",
                                            level))
                            for f, p in zip(files, paths)]
                paths = [p + ".gz" for p in paths]
            sets.append(dict(paths=paths, reads=sum(r for r, _ in shape),
                             files=files))
        for f, fut in pending:
            f["compressed_bytes"] = fut.result()
    return sets


def argv_for(template: list[str], out: str, paths: list[str]) -> list[str]:
    argv = []
    for a in template:
        argv += paths if a == "{inputs}" else [a.replace("{out}", out)]
    return argv


def port_tool():
    """The program's request path: the warm server's _run_tool."""
    from ngstpu_torch.tools.server import _run_tool

    return _run_tool


def set_up(cell, seed: int, device, work: Path, tool, marks: list) -> list:
    """The set-up after the imports: the program's warm-up, the inputs
    from the seed, and one untimed call per input shape (every set of a
    mix has one shape), on the last set, so that the window's first call
    asks for another answer. Returns the input sets."""
    from ngstpu_torch.tools import server

    took = server.warm_up(device)
    marks.append(("warm-up", sum(took.values())))
    t1 = time.monotonic()
    sets = make_inputs(cell, seed, work)
    marks.append(("inputs", time.monotonic() - t1))
    t = cell.traffic
    (work / "warm").mkdir()
    t1 = time.monotonic()
    rc, _, err = tool(t["tool"], argv_for(t["argv"], str(work / "warm" / "r"),
                                           sets[-1]["paths"]),
                      str(work), device)
    marks.append(("untimed call", time.monotonic() - t1))
    if rc != 0:
        raise RuntimeError(f"the untimed call failed, rc {rc}:\n"
                           + err.decode(errors="replace")[-2000:])
    shutil.rmtree(work / "warm")
    return sets


def window(traffic: dict, sets: list, seconds: float, trace: bool, device,
           work: Path, tool) -> tuple[list, float, MemorySampler]:
    """Whole calls back to back until `seconds` have passed, taking the
    input sets in turn, each into an output directory of its own; traced,
    each writes its stage walls to a file of its own. Each call keeps its
    wall and the process's CPU seconds in it, for the diagnosis of
    spreads. Returns the calls, the window's start and
    the memory sampler."""
    import torch

    (work / "out").mkdir()
    (work / "stages").mkdir()
    calls = []
    with MemorySampler() as mem:
        start = time.monotonic()
        while not calls or time.monotonic() - start < seconds:
            i = len(calls)
            s = sets[i % len(sets)]
            out = work / "out" / str(i)
            out.mkdir()
            if trace:
                os.environ["NGSTPU_STAGE_JSON"] = str(work / "stages"
                                                      / f"{i}.json")
            argv = argv_for(traffic["argv"], str(out / "r"), s["paths"])
            with torch.profiler.record_function(f"ngsbench.call.{i}"):
                r0 = resource.getrusage(resource.RUSAGE_SELF)
                c0 = time.monotonic()
                rc, stdout, _ = tool(traffic["tool"], argv, str(work), device)
                c1 = time.monotonic()
                r1 = resource.getrusage(resource.RUSAGE_SELF)
            (out / "r.stdout").write_bytes(stdout)
            calls.append(dict(index=i, set=i % len(sets), start=c0, end=c1,
                              rc=rc, out=str(out / "r"), reads=s["reads"],
                              files=s["files"],
                              user_s=r1.ru_utime - r0.ru_utime,
                              sys_s=r1.ru_stime - r0.ru_stime))
    os.environ.pop("NGSTPU_STAGE_JSON", None)
    return calls, start, mem


def stage_walls(work: Path, calls: list) -> dict:
    """Call index -> {stage: wall seconds}, from the program's stage JSON."""
    out = {}
    for c in calls:
        p = work / "stages" / f"{c['index']}.json"
        if p.is_file():
            d = json.loads(p.read_text().splitlines()[-1])
            out[c["index"]] = {k: v["wall_s"] for k, v in d.items()
                               if isinstance(v, dict)}
    return out


def check(ref, sets: list, calls: list, device) -> tuple[dict, set]:
    """Every call's outputs against the reference's: each number compared
    (its worst over the calls) beside its limit, and the calls that failed
    (a number over its limit, or rc != 0)."""
    worst = {k: 0 for k in ref.LIMITS}
    bad = set()
    for j in sorted({c["set"] for c in calls}):
        exp = ref.expected(sets[j]["paths"], device)
        for c in (c for c in calls if c["set"] == j):
            for k, v in ref.compare(exp, c["out"]).items():
                worst[k] = max(worst[k], v)
                if v > ref.LIMITS[k]:
                    bad.add(c["index"])
        del exp
    rc_bad = [c["index"] for c in calls if c["rc"] != 0]
    bad.update(rc_bad)
    checks = {k: {"value": worst[k], "limit": ref.LIMITS[k]} for k in worst}
    checks["calls_rc_nonzero"] = {"value": len(rc_bad), "limit": 0}
    return checks, bad


def run_cell(layout: Layout, cell, seed: int, seconds: float, trace: bool,
             device, work: Path, t0: float, tool=None) -> dict:
    """One run; returns the result line's object. `tool(name, argv, cwd,
    device) -> (rc, stdout, stderr)` is the program's request path."""
    import torch

    from .peaks import peak
    from .trace import Trace

    tool = tool or port_tool()
    marks = [("imports", time.monotonic() - t0)]
    sets = set_up(cell, seed, device, work, tool, marks)
    gc.collect()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    calls, start, mem = window(cell.traffic, sets, seconds, trace, device,
                               work, tool)
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(work / "trace.json"))
        del prof
    dev_peak = (torch.cuda.max_memory_reserved(device)
                if device.type == "cuda" else 0)
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit("ngsbench: the run loaded " + ", ".join(leaked))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t1 = time.monotonic()
    checks, bad = check(layout.ref(cell.traffic["tool"]), sets, calls, device)
    marks.append(("check", time.monotonic() - t1))
    from ngstpu_torch.utils.linkprobe import LAST_PROBE

    sys.stderr.write("ngsbench: " + ", ".join(f"{k} {v:.3f} s"
                                              for k, v in marks)
                     + "; link probe " + json.dumps(LAST_PROBE)
                     + "; per call wall/user/sys s "
                     + " ".join(f"{c['end'] - c['start']:.3f}/"
                                f"{c['user_s']:.2f}/{c['sys_s']:.2f}"
                                for c in calls) + "\n")

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    tr = Trace(work / "trace.json") if trace else None
    stages = stage_walls(work, calls) if trace else None
    ctx = SimpleNamespace(calls=calls, setup_s=start - t0,
                          host_peak_bytes=mem.peak, trace=tr, stages=stages,
                          hbm_bytes_per_s=peak(name, "hbm_bytes_per_s"))
    metrics = {}
    for m in layout.metrics(cell.name, "per_layer" if trace else "end_to_end"):
        v = layout.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = dict(correct=bool(calls) and not bad and all(
                      c["value"] <= c["limit"] for c in checks.values()),
                  attempted=len(calls), failed=len(bad), metrics=metrics,
                  device=dict(platform="gpu" if device.type == "cuda"
                              else device.type, kind=name, count=cell.chips,
                              memory_peak_bytes=dev_peak))
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s())
        result["breakdown"] = dict(device_ops=tr.top_ops(),
                                   idle_gaps=tr.idle_by_stage(stages))
    result["checks"] = checks
    return result
