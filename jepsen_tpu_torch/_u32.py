"""Unsigned 32-bit words in torch tensors.

Bitmap words and transition masks are u32 in meaning. Torch's CPU build
has no shifts on ``torch.uint32``, so the port keeps two carriers and
converts only here, so that bit 31 never changes meaning:

- **raw**: ``int32`` tensors holding the 32 bits as they are (bit 31 set
  reads as negative). This is the format the CUDA kernels take, as
  ``uint32_t*``, and the format the dense engine carries between chunks.
- **wide**: ``int64`` tensors holding 0 ... 2**32 - 1. The plain torch
  versions compute on these.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def widen(raw: torch.Tensor) -> torch.Tensor:
    """Raw int32 words -> int64 words in [0, 2**32)."""
    if raw.dtype != torch.int32:
        raise TypeError(f"raw u32 words are int32, got {raw.dtype}")
    return raw.to(torch.int64) & MASK32


def narrow(wide: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> raw int32 words (same bits)."""
    if wide.dtype != torch.int64:
        raise TypeError(f"wide u32 words are int64, got {wide.dtype}")
    return torch.where(wide >= 2 ** 31, wide - 2 ** 32, wide).to(torch.int32)


def raw_word(v: int) -> int:
    """A Python u32 value as the int32 that carries its bits."""
    v &= MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def bitmap_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy u32 bitmap (any integer dtype holding u32 values) as a raw
    int32 tensor on ``device``."""
    u = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(u.view(np.int32).copy()).to(device)


def bitmap_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A raw int32 (or wide int64) bitmap tensor as a numpy u32 array."""
    if t.dtype == torch.int64:
        t = narrow(t)
    if t.dtype != torch.int32:
        raise TypeError(f"bitmap words are int32 or int64, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32).copy()


def popcount(raw: torch.Tensor) -> int:
    """Total set bits of a raw int32 bitmap."""
    w = widen(raw)
    total = torch.zeros((), dtype=torch.int64, device=raw.device)
    for k in range(32):
        total += ((w >> k) & 1).sum()
    return int(total)


# --- pair keys --------------------------------------------------------------
#
# The sparse engine's pair-key band packs a config into two u32 words
# (hi, lo), ordered as the u64 ``hi << 32 | lo``. A plain ``hi << 32 | lo``
# in int64 is the right bit pattern but the wrong order: it goes negative
# exactly when hi has bit 31 set, which is the invalid flag and KEY_FILL,
# both of which must sort last. Flipping bit 63 maps u64 order onto int64
# order; the plain versions sort and compare such keys.

SIGN64 = -(1 << 63)       # bit 63 of an int64
PAIR_FILL = (1 << 63) - 1  # the (KEY_FILL, KEY_FILL) pair as a pair key


def pair_bits(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Raw int32 words (hi, lo) -> the int64 holding the bit pattern
    ``hi << 32 | lo`` (bit 63 is hi's bit 31). Bitwise algebra on it is
    the pair's; its signed order is not (see :func:`pair_key`)."""
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise TypeError(f"pair words are raw int32, got {hi.dtype} and "
                        f"{lo.dtype}")
    return hi.to(torch.int64) * (1 << 32) + widen(lo)


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Raw int32 words (hi, lo) -> an int64 whose signed order is the u64
    order of ``hi << 32 | lo``: the pattern with bit 63 flipped."""
    return pair_bits(hi, lo) ^ SIGN64


def pair_split(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pair_key`: int64 keys -> raw int32 (hi, lo)."""
    bits = key ^ SIGN64
    return (bits >> 32).to(torch.int32), narrow(bits & MASK32)
