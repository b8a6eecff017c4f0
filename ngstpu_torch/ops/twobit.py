"""2-bit DNA codec as torch tensor ops (ngstpu/ops/twobit.py).

Semantics of the reference twoBit.h codec: T/t/U/u -> 0, C/c -> 1,
A/a -> 2, G/g -> 3, anything else (N included) -> 0, so N packs lossily to
T; four bases per byte, first base in the two most significant bits.
Unpack maps 0..3 to "TCAG". The tables and the numpy codec are in ops/twobit_host.py (a copy of
ngstpu's), which the tools use on the host placement.
"""

from __future__ import annotations

import collections

import torch

from .twobit_host import VAL_TO_NT

# device packs and unpacks per (op, device type): chip_smoke.py reads it to
# show that the card did the work
CODEC: collections.Counter = collections.Counter()


def base_codes(seq: torch.Tensor) -> torch.Tensor:
    """uint8 base bytes -> 2-bit codes (uint8 in 0..3)."""
    is_c = (seq == ord("C")) | (seq == ord("c"))
    is_a = (seq == ord("A")) | (seq == ord("a"))
    is_g = (seq == ord("G")) | (seq == ord("g"))
    return (is_c.to(torch.uint8) + 2 * is_a.to(torch.uint8)
            + 3 * is_g.to(torch.uint8))


def pack2bit(seq: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 bases -> [B, L//4] uint8 packed (L must be %4==0).

    Padding bytes (0) code to T(0), the reference's 'T' fill."""
    B, L = seq.shape
    codes = base_codes(seq).reshape(B, L // 4, 4)
    CODEC["pack2bit", seq.device.type] += 1
    return ((codes[..., 0] << 6) | (codes[..., 1] << 4)
            | (codes[..., 2] << 2) | codes[..., 3])


def unpack2bit(packed: torch.Tensor) -> torch.Tensor:
    """[B, P] uint8 packed -> [B, P*4] uint8 base bytes ("TCAG")."""
    vals = torch.stack([(packed >> 6) & 3, (packed >> 4) & 3,
                        (packed >> 2) & 3, packed & 3], dim=-1)
    lut = torch.from_numpy(VAL_TO_NT[:4].copy()).to(packed.device)
    CODEC["unpack2bit", packed.device.type] += 1
    return lut[vals.long()].reshape(packed.shape[0], packed.shape[1] * 4)
