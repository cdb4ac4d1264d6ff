"""Sort-dedup and compaction of the sparse engine's packed keys.

The port of :mod:`jepsen_tpu.lin.psort`'s non-dominance kernels, on
single u32 keys and on (hi, lo) u32 pairs ordered as ``hi << 32 | lo``:

- :func:`dedup_keys` — fold the invalid flag into bit 31, sort, keep the
  first valid key of each run, pack the survivors into an ascending
  prefix padded with :data:`KEY_FILL`. The semantics twin of the sparse
  engine's ``bfs._dedup_keys``.
- :func:`compact_keys` — sort keys (the return filter's survivors, with
  the dropped ones already :data:`KEY_FILL`) into an ascending prefix and
  count the non-FILL ones.
- :func:`dedup_keys2`, :func:`compact_keys2` — their pair-key twins, the
  invalid flag in hi's bit 31 (lo's bit 31 is payload), the dead entries
  (KEY_FILL, KEY_FILL) pairs. The argument order is the reference's:
  (hi, lo).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/psort.cu`` through :mod:`jepsen_tpu_torch.lin.psort_cuda`) or
raises; on a CPU tensor it runs the ``*_plain`` version, the same
function in torch ops, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against on the card. Keys are u32 in
meaning and travel as raw int32 tensors (:mod:`jepsen_tpu_torch._u32`);
the plain versions widen them to int64 so that bit 31 and
:data:`KEY_FILL` sort last, and order pairs by
:func:`jepsen_tpu_torch._u32.pair_key`.
"""

from __future__ import annotations

import torch

from jepsen_tpu_torch import _u32

MIN_N = 1024              # smallest kernel size (the TPU's tiling minimum)
PSORT_MAX_N = 1 << 19     # the reference's size gate, kept until measured
KEY_FILL = 0xFFFFFFFF     # pad beyond count; sorts after any config
KEY_FILL_RAW = -1         # KEY_FILL as the int32 that carries its bits
_INVALID = 1 << 31

# Kernel launches since import (or since a caller reset them): one per
# launch of each CUDA kernel, none for the plain versions.
LAUNCHES = {"dedup_keys": 0, "compact_keys": 0, "dedup_keys2": 0,
            "compact_keys2": 0}


def pad_size(n: int) -> int:
    """The kernel size for an n-element dedup: next power of two, at
    least :data:`MIN_N`."""
    return max(MIN_N, 1 << (n - 1).bit_length())


def available(n: int) -> bool:
    """Size gate: the kernels take n-element inputs up to
    :data:`PSORT_MAX_N` (padded); larger ones take the torch.sort path."""
    return pad_size(n) <= PSORT_MAX_N


def _check(keys: torch.Tensor, cap: int, what: str) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"{what} takes raw int32[n] keys, got "
                         f"{keys.dtype}{list(keys.shape)}")
    n = keys.numel()
    if n < 1 or cap < 1 or pad_size(n) < cap:
        # The output is keys[cap]: the padded size must cover cap (every
        # engine call passes n >= cap).
        raise ValueError(f"{what} contract: pad_size({n})={pad_size(n)} "
                         f"< cap {cap}")


def _kernel_args(keys: torch.Tensor, what: str) -> None:
    if keys.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {keys.device}")
    if not available(keys.numel()):
        raise ValueError(f"{what} kernel takes at most {PSORT_MAX_N} keys "
                         f"padded, got {keys.numel()}")
    if not keys.is_contiguous():
        raise ValueError(f"{what} needs contiguous tensors")


def dedup_keys(key: torch.Tensor, valid: torch.Tensor, cap: int):
    """Single-u32-key sort-dedup. ``key`` raw int32[n] (payload below bit
    31), ``valid`` bool[n]. Returns (keys int32[cap] ascending with
    KEY_FILL padding, count int32 = min(total, cap), overflow bool =
    total > cap), all on the keys' device. The CUDA path does not
    synchronise with the host."""
    _check(key, cap, "dedup_keys")
    if valid.dtype != torch.bool or valid.shape != key.shape \
            or valid.device != key.device:
        raise ValueError("dedup_keys: valid must be bool with key's shape "
                         "and device")
    if key.device.type == "cpu":
        return dedup_keys_plain(key, valid, cap)
    _kernel_args(key, "dedup_keys")
    if not valid.is_contiguous():
        raise ValueError("dedup_keys needs contiguous tensors")
    from jepsen_tpu_torch.lin import psort_cuda

    out, flags = psort_cuda.dedup(key, valid, cap, pad_size(key.numel()))
    LAUNCHES["dedup_keys"] += 1
    return out, flags[0], flags[1] != 0


def dedup_keys_plain(key: torch.Tensor, valid: torch.Tensor, cap: int):
    """:func:`dedup_keys` in torch ops, on any device and at any size:
    one sort of the widened keys, first-of-run survivors, and a scatter
    of the survivors (already ascending) to their ranks."""
    _check(key, cap, "dedup_keys")
    dev = key.device
    w = _u32.widen(key) | ((~valid).to(torch.int64) << 31)
    s, _ = torch.sort(w)
    prev = torch.roll(s, 1)
    first = torch.arange(s.numel(), device=dev) == 0
    keep = ((s & _INVALID) == 0) & (first | (s != prev))
    total = keep.sum()
    rank = torch.cumsum(keep, 0) - 1
    # Survivors past cap and the non-survivors go to a dummy slot.
    idx = torch.where(keep & (rank < cap), rank, cap)
    out = torch.full((cap + 1,), KEY_FILL, dtype=torch.int64, device=dev)
    out.scatter_(0, idx, torch.where(idx < cap, s, KEY_FILL))
    count = torch.clamp(total, max=cap).to(torch.int32)
    return _u32.narrow(out[:cap]), count, total > cap


def compact_keys(keys: torch.Tensor, cap: int):
    """Pack the non-KEY_FILL entries of ``keys`` (raw int32[n]) into an
    ascending prefix. Returns (keys int32[cap], count int32 = min(number
    of non-FILL keys, cap)) on the keys' device. No dedup: the return
    filter's survivors are distinct by construction."""
    _check(keys, cap, "compact_keys")
    if keys.device.type == "cpu":
        return compact_keys_plain(keys, cap)
    _kernel_args(keys, "compact_keys")
    from jepsen_tpu_torch.lin import psort_cuda

    out, count = psort_cuda.compact(keys, cap, pad_size(keys.numel()))
    LAUNCHES["compact_keys"] += 1
    return out, count[0]


def compact_keys_plain(keys: torch.Tensor, cap: int):
    """:func:`compact_keys` in torch ops, on any device: the widened keys
    sorted, padded with KEY_FILL to cap, and the non-FILL count."""
    _check(keys, cap, "compact_keys")
    w, _ = torch.sort(_u32.widen(keys))
    if w.numel() < cap:
        w = torch.cat([w, torch.full((cap - w.numel(),), KEY_FILL,
                                     dtype=torch.int64, device=w.device)])
    total = (w != KEY_FILL).sum()
    count = torch.clamp(total, max=cap).to(torch.int32)
    return _u32.narrow(w[:cap]), count


# --- pair keys --------------------------------------------------------------


def _check2(hi: torch.Tensor, lo: torch.Tensor, cap: int, what: str) -> None:
    _check(lo, cap, what)
    if hi.dtype != torch.int32 or hi.shape != lo.shape \
            or hi.device != lo.device:
        raise ValueError(f"{what}: hi must be raw int32 with lo's shape "
                         "and device")


def _pair_kernel_args(hi, lo, what: str) -> None:
    _kernel_args(lo, what)
    if not hi.is_contiguous():
        raise ValueError(f"{what} needs contiguous tensors")


def dedup_keys2(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
                cap: int):
    """Pair-key sort-dedup. ``hi``/``lo`` raw int32[n] (hi's payload below
    bit 31), ``valid`` bool[n]. Returns (hi int32[cap], lo int32[cap]
    ascending by (hi, lo) with (KEY_FILL, KEY_FILL) padding, count int32
    = min(total, cap), overflow bool = total > cap) on the keys' device.
    The CUDA path does not synchronise with the host."""
    _check2(hi, lo, cap, "dedup_keys2")
    if valid.dtype != torch.bool or valid.shape != lo.shape \
            or valid.device != lo.device:
        raise ValueError("dedup_keys2: valid must be bool with the keys' "
                         "shape and device")
    if lo.device.type == "cpu":
        return dedup_keys2_plain(hi, lo, valid, cap)
    _pair_kernel_args(hi, lo, "dedup_keys2")
    if not valid.is_contiguous():
        raise ValueError("dedup_keys2 needs contiguous tensors")
    from jepsen_tpu_torch.lin import psort_cuda

    out_hi, out_lo, flags = psort_cuda.dedup2(hi, lo, valid, cap,
                                              pad_size(lo.numel()))
    LAUNCHES["dedup_keys2"] += 1
    return out_hi, out_lo, flags[0], flags[1] != 0


def dedup_keys2_plain(hi: torch.Tensor, lo: torch.Tensor,
                      valid: torch.Tensor, cap: int):
    """:func:`dedup_keys2` in torch ops, on any device and at any size:
    the flag-folded pairs sorted as pair keys, first-of-run survivors,
    and a scatter of the survivors to their ranks."""
    _check2(hi, lo, cap, "dedup_keys2")
    dev = lo.device
    flagged = torch.where(valid, hi, hi | torch.iinfo(torch.int32).min)
    s, _ = torch.sort(_u32.pair_key(flagged, lo))
    first = torch.arange(s.numel(), device=dev) == 0
    # pair_key flips bit 63, so a pair with hi's bit 31 clear is negative.
    keep = (s < 0) & (first | (s != torch.roll(s, 1)))
    total = keep.sum()
    rank = torch.cumsum(keep, 0) - 1
    idx = torch.where(keep & (rank < cap), rank, cap)
    out = torch.full((cap + 1,), _u32.PAIR_FILL, dtype=torch.int64,
                     device=dev)
    out.scatter_(0, idx, torch.where(idx < cap, s, _u32.PAIR_FILL))
    out_hi, out_lo = _u32.pair_split(out[:cap])
    count = torch.clamp(total, max=cap).to(torch.int32)
    return out_hi, out_lo, count, total > cap


def compact_keys2(hi: torch.Tensor, lo: torch.Tensor, cap: int):
    """Pair twin of :func:`compact_keys`: the dropped entries are KEY_FILL
    in both words. Returns (hi int32[cap], lo int32[cap], count int32 =
    min(number of pairs other than (KEY_FILL, KEY_FILL), cap)) on the
    keys' device."""
    _check2(hi, lo, cap, "compact_keys2")
    if lo.device.type == "cpu":
        return compact_keys2_plain(hi, lo, cap)
    _pair_kernel_args(hi, lo, "compact_keys2")
    from jepsen_tpu_torch.lin import psort_cuda

    out_hi, out_lo, count = psort_cuda.compact2(hi, lo, cap,
                                                pad_size(lo.numel()))
    LAUNCHES["compact_keys2"] += 1
    return out_hi, out_lo, count[0]


def compact_keys2_plain(hi: torch.Tensor, lo: torch.Tensor, cap: int):
    """:func:`compact_keys2` in torch ops, on any device: the pair keys
    sorted, padded with the FILL pair to cap, and the count of the others
    (a pair is live when either word is not KEY_FILL)."""
    _check2(hi, lo, cap, "compact_keys2")
    k, _ = torch.sort(_u32.pair_key(hi, lo))
    if k.numel() < cap:
        k = torch.cat([k, torch.full((cap - k.numel(),), _u32.PAIR_FILL,
                                     dtype=torch.int64, device=k.device)])
    total = (k != _u32.PAIR_FILL).sum()
    out_hi, out_lo = _u32.pair_split(k[:cap])
    return out_hi, out_lo, torch.clamp(total, max=cap).to(torch.int32)
