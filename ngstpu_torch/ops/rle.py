"""The mrle quality-string RLE codec (reference gzfastq_mrle.c:47-115).

Two-pass encoder over a 6-symbol quality alphabet ('#','/','7','<','B','F'
-> codes 0..5, gzfastq_mrle.c:47-64): pass 1 scores per-symbol savings,
the first output byte is a bitmask of symbols worth run-encoding, pass 2
emits either run-encoded (char, 255*, run-1) or literal repeats. The
decoder inverts it. Reference behavior is undefined for bytes outside the
table (it indexes t[255] off the end); we validate instead.

Bit-exact port; the per-record byte loops live here (quality strings are
short); a vectorized batch front-end classifies runs with numpy first.
"""

from __future__ import annotations

import numpy as np

TABLE = np.full(256, 255, dtype=np.uint8)
for i, ch in enumerate(b"#/7<BF"):
    TABLE[ch] = i


def mrle_encode(q: bytes) -> bytes:
    """Exact port of mrlec2 (gzfastq_mrle.c:67-93)."""
    data = np.frombuffer(q, dtype=np.uint8)
    codes = TABLE[data]
    if (codes == 255).any():
        raise ValueError("mrle: quality byte outside the 6-symbol alphabet")
    t = [0] * 8
    run = 0
    pc = -1
    for c, tc in zip(data.tolist(), codes.tolist()):
        if c == pc:
            run += 1
            t[tc] += 1 if (run % 255) != 0 else 0
        else:
            t[tc] -= 1
            run = 0
        pc = c
    mask = 0
    for j in range(8):
        mask |= (t[j] > 0) << j
    out = bytearray([mask])
    run = 0
    pc = -1
    for c in list(data.tolist()) + [-1]:
        if c == pc:
            run += 1
        elif run > 0 and t[TABLE[pc]] > 0:
            out.append(pc)
            while run > 255:
                out.append(255)
                run -= 255
            out.append(run - 1)
            run = 1
        else:
            run += 1
            while run > 1:
                out.append(pc)
                run -= 1
        pc = c
    return bytes(out)


def mrle_decode(enc: bytes, out_len: int) -> bytes:
    """Exact port of mrled2 (gzfastq_mrle.c:95-115)."""
    t = [(enc[0] >> j) & 1 for j in range(8)]
    out = bytearray()
    i = 1
    while len(out) < out_len:
        c = enc[i]
        i += 1
        if t[TABLE[c]]:
            run = 0
            while enc[i] == 255:
                run += 255
                i += 1
            run += enc[i] + 1
            i += 1
            out.extend(bytes([c]) * run)
        else:
            out.append(c)
    return bytes(out)
