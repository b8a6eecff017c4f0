"""Device placement of the fast path's dedup sort (torch).

Only _sort_device_async moves here from ngstpu/tools/emitters.py; the ring
and clone writers, the partition bounds and the host sort are imported
from that (jax-free) module.
"""

from __future__ import annotations

import numpy as np
import torch

from ngstpu.tools.emitters import N_PARTS, _partition_bounds


def _sort_device_async(words_all: np.ndarray, key_lens: np.ndarray,
                       sumq_all: np.ndarray, bucket: np.ndarray,
                       const_len: bool, W: int, device: torch.device):
    """Partition rows by leading packed byte (prefix order == sdscmp order
    on the 2-bit alphabet) and queue one LSD sort per partition on
    `device` NOW, so the device sorts while the caller's trim loop runs;
    the returned generator yields each partition's groups as its results
    are pulled.

    The pooled staging buffers pipe.stage{p} / pipe.lens{p} are handed to
    the next lane of a multi-lane run: every host->device copy from them is
    a synchronous copy from pageable memory, finished before this returns.
    """
    from ngstpu.utils.bufpool import get_buffer, get_matrix

    from ..ops.sortengine import rep_counts_host, sort_partition, words_tensor

    B = len(words_all)
    bounds = _partition_bounds(bucket, N_PARTS)
    top = words_all[:, 0] >> np.uint32(24) if B else np.zeros(0, np.uint32)
    part = np.searchsorted(bounds, top, side="right")
    handles = []
    for p in range(N_PARTS):
        idx_p = np.flatnonzero(part == p).astype(np.int64)
        n_p = len(idx_p)
        if n_p == 0:
            continue
        # no row padding: the JAX package pads to 256K-row multiples so XLA
        # compiles few shapes; eager torch has nothing to recompile
        stage = get_matrix(f"pipe.stage{p}", n_p, W, np.uint32)
        np.take(words_all, idx_p, axis=0, out=stage)
        w_dev = words_tensor(stage, device)
        if const_len:
            l_dev = torch.zeros(n_p, dtype=torch.int32, device=device)
        else:
            lstage = get_buffer(f"pipe.lens{p}", 4 * n_p, np.int32)
            np.take(np.asarray(key_lens, np.int32), idx_p, out=lstage)
            l_dev = torch.from_numpy(lstage).to(device)
        perm, is_head = sort_partition(w_dev, l_dev, n_p,
                                       length_key=not const_len,
                                       maybe_padding=False)
        handles.append((perm, is_head, idx_p, n_p))

    def gen():
        for perm_d, is_head_d, idx_p, n_p in handles:
            perm = perm_d.cpu().numpy()
            is_head = is_head_d.cpu().numpy()
            rep_local, counts = rep_counts_host(perm, is_head, n_p,
                                                sumq_all[idx_p])
            yield idx_p[rep_local], counts

    return gen()
