"""Minimal dependency-free PNG writer + canvas drawing ops.

Stands in for the reference's libgd usage (reference
bam_sliding_count.c:274-329 draw_hits): create an RGB canvas, draw
rectangles/pixels/labels, emit a PNG via zlib. Not a byte-parity surface —
the reference's PNG bytes depend on libgd internals — but the rendered
geometry mirrors draw_hits.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 5x7 bitmap font for labels (digits, uppercase, a few symbols)
_FONT = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11110 00001 00001 01110 00001 00001 11110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    "c": "00000 00000 01110 10000 10000 10001 01110",
    "h": "10000 10000 10110 11001 10001 10001 10001",
    "r": "00000 00000 10110 11001 10000 10000 10000",
    "A": "01110 10001 10001 11111 10001 10001 10001",
    "B": "11110 10001 10001 11110 10001 10001 11110",
    "C": "01110 10001 10000 10000 10000 10001 01110",
    "D": "11110 10001 10001 10001 10001 10001 11110",
    "E": "11111 10000 10000 11110 10000 10000 11111",
    "F": "11111 10000 10000 11110 10000 10000 10000",
    "G": "01110 10001 10000 10111 10001 10001 01111",
    "H": "10001 10001 10001 11111 10001 10001 10001",
    "I": "01110 00100 00100 00100 00100 00100 01110",
    "J": "00111 00010 00010 00010 00010 10010 01100",
    "K": "10001 10010 10100 11000 10100 10010 10001",
    "L": "10000 10000 10000 10000 10000 10000 11111",
    "M": "10001 11011 10101 10101 10001 10001 10001",
    "N": "10001 11001 10101 10011 10001 10001 10001",
    "O": "01110 10001 10001 10001 10001 10001 01110",
    "P": "11110 10001 10001 11110 10000 10000 10000",
    "Q": "01110 10001 10001 10001 10101 10010 01101",
    "R": "11110 10001 10001 11110 10100 10010 10001",
    "S": "01111 10000 10000 01110 00001 00001 11110",
    "T": "11111 00100 00100 00100 00100 00100 00100",
    "U": "10001 10001 10001 10001 10001 10001 01110",
    "V": "10001 10001 10001 10001 10001 01010 00100",
    "W": "10001 10001 10001 10101 10101 11011 10001",
    "X": "10001 10001 01010 00100 01010 10001 10001",
    "Y": "10001 10001 01010 00100 00100 00100 00100",
    "Z": "11111 00001 00010 00100 01000 10000 11111",
    "%": "11001 11010 00010 00100 01000 01011 10011",
    ":": "00000 01100 01100 00000 01100 01100 00000",
    "-": "00000 00000 00000 11111 00000 00000 00000",
    "/": "00001 00010 00010 00100 01000 01000 10000",
    "(": "00010 00100 01000 01000 01000 00100 00010",
    ")": "01000 00100 00010 00010 00010 00100 01000",
    "_": "00000 00000 00000 00000 00000 00000 11111",
    ".": "00000 00000 00000 00000 00000 01100 01100",
    ",": "00000 00000 00000 00000 01100 00100 01000",
}


class Canvas:
    def __init__(self, width: int, height: int,
                 background=(255, 255, 255)):
        self.a = np.empty((height, width, 3), dtype=np.uint8)
        self.a[:] = background

    def set_pixel(self, x: int, y: int, color) -> None:
        if 0 <= x < self.a.shape[1] and 0 <= y < self.a.shape[0]:
            self.a[y, x] = color

    def rectangle(self, x1, y1, x2, y2, color) -> None:
        x1, x2 = sorted((max(0, int(x1)), min(self.a.shape[1] - 1, int(x2))))
        y1, y2 = sorted((max(0, int(y1)), min(self.a.shape[0] - 1, int(y2))))
        self.a[y1, x1:x2 + 1] = color
        self.a[y2, x1:x2 + 1] = color
        self.a[y1:y2 + 1, x1] = color
        self.a[y1:y2 + 1, x2] = color

    def filled_rectangle(self, x1, y1, x2, y2, color) -> None:
        x1, x2 = sorted((max(0, int(x1)), min(self.a.shape[1], int(x2))))
        y1, y2 = sorted((max(0, int(y1)), min(self.a.shape[0], int(y2))))
        self.a[y1:y2 + 1, x1:x2 + 1] = color

    def text(self, x: int, y: int, s: str, color, scale: int = 2) -> None:
        cx = int(x)
        for ch in s:
            pat = _FONT.get(ch) or _FONT.get(ch.upper())
            if pat:
                rows = pat.split()
                for ry, row in enumerate(rows):
                    for rx, bit in enumerate(row):
                        if bit == "1":
                            self.filled_rectangle(
                                cx + rx * scale, y + ry * scale,
                                cx + rx * scale + scale - 1,
                                y + ry * scale + scale - 1, color)
            cx += 6 * scale

    def to_png(self) -> bytes:
        h, w, _ = self.a.shape
        raw = b"".join(b"\x00" + self.a[i].tobytes() for i in range(h))

        def chunk(tag: bytes, payload: bytes) -> bytes:
            return (struct.pack(">I", len(payload)) + tag + payload
                    + struct.pack(">I", zlib.crc32(tag + payload)))

        ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
        return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def write_png(path: str, canvas: Canvas) -> None:
    with open(path, "wb") as f:
        f.write(canvas.to_png())
