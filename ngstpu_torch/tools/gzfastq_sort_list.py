"""gzfastq_sort_list: the same contract as gzfastq_sort (the reference
implements the same sort with a linked list + qsort, reference
gzfastq_sort_list.c), mirroring ngstpu/tools/gzfastq_sort_list.py."""

from __future__ import annotations

import torch

from .gzfastq_sort import main as _sort_main


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    return _sort_main(list(argv), device=device)
