"""`ngstpu-torch` CLI: the port's subcommands, with ngstpu's flags and outputs.

    python -m ngstpu_torch.tools.cli [--device DEV] <tool> [args...]
    python -m ngstpu_torch.tools.cli [--device DEV] serve [--socket PATH]

DEV defaults to ``cuda``; without a CUDA device the run fails rather than
falling back to the CPU. ``--device cpu`` runs the plain PyTorch versions.
The tools of HOST_ONLY have no device code: they are copies of ngstpu's
host tools, called without a device.

With NGSTPU_SERVER=<socket> a tool call goes to the warm server there
(tools/server.py), which runs it on its own device and environment; an
unreachable server means a local run. The routing happens before anything
imports torch. NGSTPU_TRACE=<dir> profiles a local run with
torch.profiler and writes a Chrome trace file into <dir>.
"""

from __future__ import annotations

import importlib
import os
import sys
import time
import zlib

TOOLS = {
    "fastq_count": "ngstpu_torch.tools.fastq_count",
    "fastq_count_kthread": "ngstpu_torch.tools.fastq_count_kthread",
    "fastq_trim": "ngstpu_torch.tools.fastq_trim",
    "pick_pair": "ngstpu_torch.tools.pick_pair",
    "gzfastq_sample": "ngstpu_torch.tools.gzfastq_sample",
    "gzfastq_uniq": "ngstpu_torch.tools.gzfastq_uniq",
    "gzfastq_uniqQ": "ngstpu_torch.tools.gzfastq_uniqQ",
    "gzfastq_uniq_sort": "ngstpu_torch.tools.gzfastq_uniq_sort",
    "gzfastq_sort": "ngstpu_torch.tools.gzfastq_sort",
    "gzfastq_sort_list": "ngstpu_torch.tools.gzfastq_sort_list",
    "gzfastq_mrle": "ngstpu_torch.tools.gzfastq_mrle",
    "fastq2twobit": "ngstpu_torch.tools.fastq2twobit",
    "twoBit2seq": "ngstpu_torch.tools.twobit2seq",
    "fastqc": "ngstpu_torch.tools.fastqc",
    "pipeline": "ngstpu_torch.tools.pipeline",
    "ordered_uniq": "ngstpu_torch.tools.ordered_uniq",
    "bam2depth": "ngstpu_torch.tools.bam2depth",
    "bam2wig": "ngstpu_torch.tools.bam2wig",
    "bam_sliding_count": "ngstpu_torch.tools.bam_sliding_count",
    "bamSplitChr": "ngstpu_torch.tools.bam_split_chr",
    "index": "ngstpu_torch.tools.bam_index",
}
HOST_ONLY = frozenset(("fastq_trim", "pick_pair", "gzfastq_sample",
                       "gzfastq_mrle", "bam_sliding_count", "bamSplitChr",
                       "index"))


def _usage() -> int:
    sys.stderr.write("usage: ngstpu-torch [--device DEV] <tool> [args...]\n"
                     "tools:\n")
    for name in TOOLS:
        sys.stderr.write(f"  {name}\n")
    sys.stderr.write("  serve          (warm-process server; route calls "
                     "with NGSTPU_SERVER=<socket>)\n")
    return 1


def run(name: str, argv: list[str], dev) -> int:
    """Tool `name`'s main on `dev` (none for HOST_ONLY tools), with a
    FileNotFoundError, malformed input or a closed pipe turned into an
    exit code and a message, as the reference tools fail."""
    mod = importlib.import_module(TOOLS[name])
    try:
        if name in HOST_ONLY:
            return mod.main(argv) or 0
        return mod.main(argv, device=dev) or 0
    except FileNotFoundError as e:
        sys.stderr.write(f"ngstpu-torch {name}: {e}\n")
        return 1
    except (ValueError, EOFError, zlib.error) as e:
        # malformed input (bad FASTQ record structure, bad BAM/BGZF magic,
        # truncated gzip streams) fails cleanly like a CLI, not with a
        # traceback
        sys.stderr.write(f"ngstpu-torch {name}: invalid input: {e}\n")
        return 1
    except BrokenPipeError:
        return 0


def _traced(trace_dir: str, name: str, argv: list[str], dev) -> int:
    """run() under torch.profiler (CPU activity, and the card's on CUDA);
    the Chrome trace goes to <trace_dir>/<tool>.<pid>.<ns>.pt.trace.json,
    the port's counterpart of ngstpu's jax.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=acts)
    try:
        with prof:
            return run(name, argv, dev)
    finally:
        stamp = f"{os.getpid()}.{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"{name}.{stamp}.pt.trace.json"))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if argv[:1] == ["--device"]:
        if len(argv) < 2:
            return _usage()
        device, argv = argv[1], argv[2:]
    if not argv or argv[0] in ("-h", "--help", "help"):
        return _usage()
    name = argv[0]
    if name == "serve":
        from .server import main as serve_main

        return serve_main(argv[1:], device)
    if name not in TOOLS:
        sys.stderr.write(f"ngstpu-torch: unknown tool '{name}'\n")
        return 2
    server_sock = os.environ.get("NGSTPU_SERVER")
    if server_sock:
        from .server import call_server

        rc = call_server(server_sock, name, argv[1:])
        if rc is not None:
            return rc
        sys.stderr.write("ngstpu-torch: server unreachable, running "
                         "locally\n")
    from ..utils.device import resolve_device

    dev = resolve_device(device)  # raises without the requested device
    trace_dir = os.environ.get("NGSTPU_TRACE")
    if trace_dir:
        return _traced(trace_dir, name, argv[1:], dev)
    return run(name, argv[1:], dev)


if __name__ == "__main__":
    sys.exit(main())
