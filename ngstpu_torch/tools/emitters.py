"""Writer/sort-dispatch machinery of the offset-indexed fast paths
(pipeline, gzfastq_uniq, gzfastq_sort, fastq_trim).

The host half is a copy of the JAX package's tools/emitters.py: the ring
writer, the page-recycling and cloning sinks, the partition bounds and the
native host sort. _sort_device_async is the port's own, on torch.

The ring writer is the output half of the reference's kt_pipeline overlap
(reference klib/kthread.c:83-143): formatting chunk k+1 overlaps writing
chunk k, buffers come from the persistent pool, and the duplicate uniq
output is a kernel-side copy_file_range clone.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

N_PARTS = 4
CHUNK_RECORDS = 1 << 19

_SFR_WAIT_BEFORE, _SFR_WRITE, _SFR_WAIT_AFTER = 1, 2, 4


def _libc_sync_file_range():
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        fn = libc.sync_file_range
        fn.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_long,
                       ctypes.c_uint]
        return fn
    except (OSError, AttributeError):
        return None


class _PageRecycler:
    """Windowed writeback + page-drop BEHIND the write cursor.

    On slow-fault VMs the dominant output cost is allocating NEW
    page-cache pages (first-touch of guest-physical memory measured
    30MB/s..3GB/s by host phase); steadily recycling our own just-written
    pages keeps the working set to one window and measured 2-5x faster
    sequential output than letting 3.4GB of dirty cache accumulate
    (scripts experiment, round 5). Protocol per wrote(upto): start async
    writeback for the fresh bytes, then WAIT + POSIX_FADV_DONTNEED on
    everything more than `window` behind — dropped pages return to the
    guest free pool and the next chunk's allocation reuses them.
    NGSTPU_WRITE_RECYCLE=0 disables.
    """

    WINDOW = 256 << 20
    # engage only past this many bytes written: sub-GB outputs fit the
    # warm page pool and the writeback waits would be pure overhead
    # (measured ~0.3-0.5s on the 2M-read composite); multi-GB outputs
    # (the 10M-read tools) are where the allocation wall lives
    START = 1 << 30

    _sfr = None
    _sfr_loaded = False

    # adaptive cutoff: if the first START bytes wrote FASTER than this,
    # page allocation is cheap in the current host phase and the
    # writeback waits would only add latency (the C reference pays no
    # in-window writeback either) — skip recycling for this stream
    BW_SKIP = 900e6

    def __init__(self, fileobj, window: int | None = None,
                 start: int | None = None):
        self._f = fileobj
        self._window = self.WINDOW if window is None else window
        self._start = self.START if start is None else start
        self._synced = 0
        self._dropped = 0
        self._wbytes = 0
        self._wsecs = 0.0
        self._decided = False
        self._on = os.environ.get("NGSTPU_WRITE_RECYCLE", "1") != "0" \
            and hasattr(os, "posix_fadvise")
        if self._on and not _PageRecycler._sfr_loaded:
            _PageRecycler._sfr = _libc_sync_file_range()
            _PageRecycler._sfr_loaded = True
        if _PageRecycler._sfr is None:
            self._on = False

    def note_write(self, nbytes: int, seconds: float) -> None:
        """Observed cost of a plain write() — the allocation-wall probe."""
        self._wbytes += nbytes
        self._wsecs += seconds

    def wrote(self, upto: int) -> None:
        if not self._on or upto <= self._synced or upto < self._start:
            return
        if not self._decided:
            self._decided = True
            if self._wbytes >= (self._start >> 1) and self._wsecs > 0 \
                    and self._wbytes / self._wsecs > self.BW_SKIP:
                self._on = False
                return
        try:
            fd = self._f.fileno()
            _PageRecycler._sfr(fd, self._synced, upto - self._synced,
                               _SFR_WRITE)
            self._synced = upto
            drop_to = upto - self._window
            if drop_to > self._dropped:
                _PageRecycler._sfr(fd, self._dropped,
                                   drop_to - self._dropped,
                                   _SFR_WAIT_BEFORE | _SFR_WRITE
                                   | _SFR_WAIT_AFTER)
                os.posix_fadvise(fd, self._dropped,
                                 drop_to - self._dropped,
                                 os.POSIX_FADV_DONTNEED)
                self._dropped = drop_to
        except OSError:
            self._on = False


class _RecyclingSink:
    """Plain single-file sink for _RingWriter with page recycling."""

    def __init__(self, f, window: int | None = None,
                 start: int | None = None):
        self._f = f
        self._off = 0
        self._rec = _PageRecycler(f, window=window, start=start)

    def write(self, mv) -> None:
        import time

        t0 = time.monotonic()
        self._f.write(mv)
        self._rec.note_write(len(mv), time.monotonic() - t0)
        self._off += len(mv)
        self._rec.wrote(self._off)

class _RingWriter:
    """Background single-file writer fed from a ring of pooled buffers.

    The producer borrows a buffer name via `acquire()`, fills it, and
    `submit()`s (view, nbytes); the writer thread writes and returns the
    name to the free ring — formatting chunk k+1 overlaps writing chunk k
    without ever copying the text (the kt_pipeline overlap of reference
    klib/kthread.c:83-143 on the output side)."""

    def __init__(self, sink, names: list[str]):
        self._sink = sink
        self._free: "queue.Queue[str]" = queue.Queue()
        for n in names:
            self._free.put(n)
        self._work: "queue.Queue[tuple | None]" = queue.Queue()
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def acquire(self) -> str:
        return self._free.get()

    def submit(self, name: str, view: np.ndarray, nbytes: int) -> None:
        self._work.put((name, view, nbytes))

    def _drain(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            name, view, nbytes = item
            if self._err is None:
                try:
                    self._sink.write(memoryview(view[:nbytes]))
                except BaseException as e:
                    self._err = e
            self._free.put(name)

    def close(self) -> None:
        if self._t is not None:
            self._work.put(None)
            self._t.join()
            self._t = None
        try:
            if hasattr(self._sink, "close"):
                self._sink.close()  # flush a threaded sink (clone queue)
        finally:
            if self._err is not None:
                err, self._err = self._err, None
                raise err


class _CloningSink:
    """Write each block to f1 and kernel-clone the written range into f2
    (the two uniq outputs are byte-identical; copy_file_range avoids a
    second user-space pass over the text). Falls back to a plain double
    write where copy_file_range is unsupported."""

    def __init__(self, f1, f2):
        self._f1, self._f2 = f1, f2
        self._off = 0
        self._cfr = hasattr(os, "copy_file_range")
        self._rec1 = _PageRecycler(f1)
        self._rec2 = _PageRecycler(f2)
        # the clone runs on its own thread so chunk k's kernel copy (and
        # both files' writeback/recycle) overlaps chunk k+1's f1 write;
        # maxsize bounds the clone lag to two chunks, well inside the
        # recycler window, so the copy_file_range source is still cached
        # when the clone reaches it
        self._q: "queue.Queue[tuple | None]" = queue.Queue(maxsize=2)
        self._err: BaseException | None = None
        self._fd_in = -1
        self._t = threading.Thread(target=self._clone_loop, daemon=True)
        self._t.start()

    def _src_fd(self) -> int:
        # copy_file_range/pread need a READABLE source fd; f1 is the
        # write-only output stream, so the clone opens its own read
        # descriptor on the same path (round-5 fix: with f1's own fd the
        # kernel returned EBADF and every "clone" silently fell back to
        # a second user-space write)
        if self._fd_in < 0:
            self._fd_in = os.open(self._f1.name, os.O_RDONLY)
        return self._fd_in

    def _clone_range(self, off: int, n: int) -> None:
        done = 0
        if self._cfr:
            try:
                src = self._src_fd()
                while done < n:
                    k = os.copy_file_range(
                        src, self._f2.fileno(), n - done,
                        off + done, off + done)
                    if k == 0:
                        break
                    done += k
            except OSError:
                self._cfr = False
        while done < n:
            # fallback reads back from f1 — the authoritative bytes —
            # never from the producer's pooled buffer (which may already
            # be reused by the time the clone thread gets here)
            chunk = os.pread(self._src_fd(), min(n - done, 8 << 20),
                             off + done)
            if not chunk:
                raise OSError("clone source short read")
            self._f2.seek(off + done)
            self._f2.write(chunk)
            done += len(chunk)

    def _clone_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            off, n = item
            if self._err is None:
                try:
                    self._clone_range(off, n)
                    # recycle AFTER the clone: f1's source range must
                    # still be cached when copy_file_range reads it
                    self._rec1.wrote(off + n)
                    self._rec2.wrote(off + n)
                except BaseException as e:  # pragma: no cover - rethrown
                    self._err = e

    def write(self, mv) -> None:
        import time

        if self._err is not None:
            err, self._err = self._err, None
            raise err
        n = len(mv)
        t0 = time.monotonic()
        self._f1.write(mv)
        dt = time.monotonic() - t0
        self._rec1.note_write(n, dt)
        self._rec2.note_write(n, dt)  # same phase, same wall
        self._q.put((self._off, n))
        self._off += n

    def close(self) -> None:
        if self._t is not None:
            self._q.put(None)
            self._t.join()
            self._t = None
        if self._fd_in >= 0:
            try:
                os.close(self._fd_in)
            finally:
                self._fd_in = -1
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def _fresh(path: str) -> str:
    """Unlink `path` before (re)creating it: truncate-open of a file whose
    pages are still dirty in cache forces synchronous invalidation (up to
    ~0.7s per 300MB output measured); unlinking instead lets the
    kernel drop the old inode's dirty pages in the background."""
    try:
        os.unlink(path)
    except OSError:
        pass
    return path


def _partition_bounds(bucket_hist: np.ndarray, n_parts: int) -> np.ndarray:
    """Key-range split points (leading packed byte) giving ~equal rows."""
    cum = np.cumsum(bucket_hist.astype(np.int64))
    total = int(cum[-1])
    targets = (np.arange(1, n_parts) * total) // n_parts
    return np.searchsorted(cum, targets).astype(np.uint32)

def _sort_host_async(words_all: np.ndarray, key_lens: np.ndarray,
                     sumq_all: np.ndarray, const_len: bool):
    """Host placement of the dedup sort (thin accelerator link): ONE native
    call fuses the bucketed parallel sort with group/representative/count
    extraction (each bucket's groups are scanned while its rows are still
    cache-hot). The call runs on a background thread STARTED NOW (ctypes
    releases the GIL), so it fills the CPU stalls of the trim loop's ring
    writer; the returned generator joins, then yields group blocks."""
    import ctypes
    import threading

    from ..io.native import get_lib
    from ..utils.bufpool import get_buffer

    B = len(words_all)
    W = words_all.shape[1]
    lib = get_lib()
    perm = get_buffer("pipe.perm", 4 * B, np.int32)[:B]
    rep = get_buffer("pipe.rep", 8 * B, np.int64)[:B]
    counts = get_buffer("pipe.cnt", 8 * B, np.int64)[:B]
    lens = np.ascontiguousarray(key_lens, np.int32)
    lens_p = lens.ctypes.data_as(ctypes.c_void_p)
    use_len = 0 if const_len else 1

    # STREAMED (round 5): scatter once, then a sorter thread walks the
    # 256 byte buckets in ascending (== key) order, sorting each and
    # extracting its groups in place (ngs_dedup_groups_range — a group
    # never straddles buckets); the generator yields each bucket's group
    # block as it lands, so the uniq emit of bucket k overlaps the radix
    # of bucket k+1 instead of waiting for the whole sort.
    boff = np.zeros(257, np.int64)
    lib.ngs_msd_scatter_u32(words_all, B, W, perm, boff)
    done_q: "queue.Queue[tuple]" = queue.Queue()

    def run():
        try:
            for k in range(256):
                g = lib.ngs_dedup_groups_range(
                    words_all, lens_p, sumq_all, use_len, W, perm,
                    int(boff[k]), int(boff[k + 1]), rep, counts)
                done_q.put((k, g, None))
        except BaseException as e:  # pragma: no cover - surfaced below
            done_q.put((-1, 0, e))

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def gen():
        # batch tiny buckets so downstream text assembly stays chunky
        MIN_GROUPS = 1 << 18
        pend: list = []
        pend_n = 0
        for _ in range(256):
            k, g, err = done_q.get()
            if err is not None:
                raise err
            if g:
                pend.append((int(boff[k]), g))
                pend_n += g
            if pend_n >= MIN_GROUPS or (k == 255 and pend):
                if len(pend) == 1:
                    o, n = pend[0]
                    yield rep[o:o + n], counts[o:o + n]
                else:
                    # each bucket's groups sit at its scatter offset with
                    # a gap after (groups <= rows) — gather them tight
                    yield (np.concatenate([rep[o:o + n] for o, n in pend]),
                           np.concatenate([counts[o:o + n]
                                           for o, n in pend]))
                pend, pend_n = [], 0
        t.join()

    return gen()


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
    from ..ops.sortengine import rep_counts_host, sort_partition, words_tensor
    from ..utils.bufpool import get_buffer, get_matrix

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
