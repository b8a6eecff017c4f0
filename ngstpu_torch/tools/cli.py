"""`ngstpu-torch` CLI: the port's subcommands, with ngstpu's flags and outputs.

    python -m ngstpu_torch.tools.cli [--device DEV] <tool> [args...]

DEV defaults to ``cuda``; without a CUDA device the run fails rather than
falling back to the CPU. ``--device cpu`` runs the plain PyTorch versions.
The tools of HOST_ONLY have no device code: they are copies of ngstpu's
host tools, called without a device.
"""

from __future__ import annotations

import importlib
import sys
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
}
HOST_ONLY = frozenset(("fastq_trim", "pick_pair", "gzfastq_sample",
                       "gzfastq_mrle"))


def _usage() -> int:
    sys.stderr.write("usage: ngstpu-torch [--device DEV] <tool> [args...]\n"
                     "tools:\n")
    for name in TOOLS:
        sys.stderr.write(f"  {name}\n")
    return 1


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
    if name not in TOOLS:
        sys.stderr.write(f"ngstpu-torch: unknown tool '{name}'\n")
        return 2
    from ..utils.device import resolve_device

    dev = resolve_device(device)  # raises without the requested device
    mod = importlib.import_module(TOOLS[name])
    try:
        if name in HOST_ONLY:
            return mod.main(argv[1:]) or 0
        return mod.main(argv[1:], device=dev) or 0
    except FileNotFoundError as e:
        sys.stderr.write(f"ngstpu-torch {name}: {e}\n")
        return 1
    except (ValueError, EOFError, zlib.error) as e:
        # malformed input (bad FASTQ record structure, truncated gzip
        # streams) fails cleanly like a CLI, not with a traceback
        sys.stderr.write(f"ngstpu-torch {name}: invalid input: {e}\n")
        return 1
    except BrokenPipeError:
        return 0


if __name__ == "__main__":
    sys.exit(main())
