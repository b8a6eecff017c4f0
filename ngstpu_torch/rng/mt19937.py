"""Bit-exact RNG parity with the reference's samplers.

Three generators must match the C toolchain exactly for gzfastq_sample parity
(SURVEY.md §7 hard parts):

1. GSL-style MT19937 (2002 seeding) as vendored in fastq-tools rng.c —
   used by `gzfastq_sample -n` with fixed seed 4357
   (reference gzfastq_sample.c:245-250). Includes the rejection-sampling
   `fastq_rng_uniform_int` (scale = 0xffffffff // k) and the Fisher-Yates
   `shuffle` call sequence (gzfastq_sample.c:157-171).
2. glibc rand() (TYPE_3 additive generator) — `-s` with a nonzero integer
   seed does srand(seed); seed = rand() (gzfastq_sample.c:364-367).
3. khash __ac_X31_hash_string (h = h*31 + c) — the per-read keep/drop hash
   of `-s` mode (gzfastq_sample.c:150-153).

The MT19937 block update and the X31 hash are vectorized with numpy; the
Fisher-Yates swap application is a thin Python loop over precomputed draws
(rejections are handled exactly).
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


class MT19937:
    """MT19937 with the 2002 Knuth seeding (GSL / fastq-tools mt_set)."""

    def __init__(self, seed: int = 4357):
        if seed == 0:
            seed = 4357
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> np.uint64(30))) + i) & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._buf = np.empty(0, dtype=np.uint32)
        self._pos = 0

    def _twist_fast(self) -> np.ndarray:
        """Fully vectorized twist: resolve the second chunk's dependency.

        For k in [N-M, N): out[k] = out[k-(N-M)] ^ f(y[k]). Since k-(N-M) <
        N-M for k < 2(N-M)=454, and >= N-M after, there is a chain of depth
        ceil(N/(N-M)) = 3. Resolve with 3 vector steps.
        """
        mt = self._mt
        nxt = np.roll(mt, -1)
        y = (mt & _UPPER) | (nxt & _LOWER)
        f = (y >> np.uint32(1)) ^ np.where(y & np.uint32(1), _MATRIX_A, np.uint32(0))
        out = np.empty(_N, dtype=np.uint32)
        out[:_N - _M] = mt[_M:] ^ f[:_N - _M]
        # The C loop runs in place, so the wrap-around word y[N-1] combines
        # OLD mt[N-1] with UPDATED mt[0] (rng.c's final block) — recompute
        # f[N-1] from out[0] before resolving the chain.
        y_last = (mt[_N - 1] & _UPPER) | (out[0] & _LOWER)
        f[_N - 1] = (y_last >> np.uint32(1)) ^ (
            _MATRIX_A if (y_last & np.uint32(1)) else np.uint32(0))
        # chain: indices N-M..N use out[k-(N-M)]
        lo = _N - _M
        while lo < _N:
            hi = min(_N, lo + (_N - _M))
            out[lo:hi] = out[lo - (_N - _M): hi - (_N - _M)] ^ f[lo:hi]
            lo = hi
        self._mt = out
        k = out.copy()
        k ^= k >> np.uint32(11)
        k ^= (k << np.uint32(7)) & np.uint32(0x9D2C5680)
        k ^= (k << np.uint32(15)) & np.uint32(0xEFC60000)
        k ^= k >> np.uint32(18)
        return k

    def draw_block(self) -> np.ndarray:
        return self._twist_fast()

    def draws(self, n: int) -> np.ndarray:
        """Next n raw 32-bit outputs."""
        chunks = [self._buf] if len(self._buf) else []
        got = len(self._buf)
        while got < n:
            b = self.draw_block()
            chunks.append(b)
            got += _N
        buf = np.concatenate(chunks) if chunks else np.empty(0, np.uint32)
        self._buf = buf[n:]
        return buf[:n].copy()

    def uniform_int(self, k: int) -> int:
        """fastq_rng_uniform_int: rejection sampling with scale division."""
        scale = 0xFFFFFFFF // k
        while True:
            r = int(self.draws(1)[0]) // scale
            if r < k:
                return r


def gsl_fisher_yates(n: int, seed: int = 4357) -> np.ndarray:
    """Reproduce index_without_replacement(rng, n): xs=[0..n) shuffled with
    the exact draw sequence of shuffle() (gzfastq_sample.c:157-163)."""
    rng = MT19937(seed)
    xs = np.arange(n, dtype=np.uint64)
    # Pre-draw with small overhead for rejections; top up as needed.
    est = n + 64 + n // 100000
    draws = rng.draws(est)
    pos = 0
    for i in range(n - 1, 0, -1):
        k = i + 1
        scale = 0xFFFFFFFF // k
        while True:
            if pos >= len(draws):
                draws = rng.draws(max(1024, n // 100))
                pos = 0
            j = int(draws[pos]) // scale
            pos += 1
            if j < k:
                break
        xs[j], xs[i] = xs[i], xs[j]
    return xs


def sample_indices(n: int, pick: int, seed: int = 4357) -> np.ndarray:
    """The `-n` selection: first `pick` entries of the shuffled permutation,
    sorted ascending (gzfastq_sample.c:249-250)."""
    xs = gsl_fisher_yates(n, seed)
    return np.sort(xs[:pick].astype(np.int64))


def glibc_rand_first(seed: int) -> int:
    """First output of glibc srand(seed); rand() (TYPE_3 additive LCG)."""
    r = np.zeros(345, dtype=np.int64)
    r[0] = np.int32(seed)
    for i in range(1, 31):
        # r[i] = (16807 * r[i-1]) % 2147483647, computed without overflow
        r[i] = (16807 * r[i - 1]) % 2147483647
        if r[i] < 0:
            r[i] += 2147483647
    for i in range(31, 34):
        r[i] = r[i - 31]
    # glibc discards the first 310 additive outputs; the first rand() result
    # is (r[313] + r[341]) mod 2^32 >> 1, i.e. index 344.
    for i in range(34, 345):
        r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
    return int(r[344] >> 1) & 0x7FFFFFFF


def x31_hash_batch(names: np.ndarray, starts: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
    """Vectorized khash X31 string hash over a ragged name table.

    h = s[0]; for c in s[1:]: h = (h << 5) - h + c   (mod 2^32)
    (reference khash.h __ac_X31_hash_string).
    """
    b = len(starts)
    if b == 0:
        return np.zeros(0, dtype=np.uint32)
    lmax = int(lens.max())
    h = np.zeros(b, dtype=np.uint32)
    col_idx = starts.astype(np.int64)
    for c in range(lmax):
        active = lens > c
        ch = names[np.clip(col_idx + c, 0, len(names) - 1)].astype(np.uint32)
        if c == 0:
            h = np.where(active, ch, h)
        else:
            h = np.where(active, (h * np.uint32(31)) + ch, h)
    return h
