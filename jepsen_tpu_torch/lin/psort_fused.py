"""The compact register band's whole closure fixpoint as one kernel.

The port of :mod:`jepsen_tpu.lin.psort_fused`, single-key and pair mode. The
sparse engine's closure is a chain of passes (saturate, expand by the
row's mutator columns, sort-dedup, test the fixpoint); :func:`fixpoint`
runs the whole chain in one launch with the frontier kept on one SM
(``csrc/psort_fused.cu`` says how). Per-column scalar tables come from
:func:`jepsen_tpu_torch.lin.bfs._fused_row_tables`: the register family's
mutator step is a value match, so legality and successor per (column,
state) collapse to per-column scalars.

One fixpoint equals :func:`jepsen_tpu_torch.lin.bfs._closure_pass_keys_compact`
iterated ungrouped to convergence, and the engine maps non-convergence at
``it_max`` to the same honest budget overflow as the unfused chain. On a
CUDA tensor :func:`fixpoint` launches the kernel (or raises); on a CPU
tensor it runs :func:`fixpoint_plain`. Pair keys (``hi`` given) run the
same loop on 64-bit keys ``hi << 32 | lo``: liveness from hi alone,
saturation and new keys in both words, the sort by (hi, lo).
"""

from __future__ import annotations

import torch

from jepsen_tpu_torch import _u32
from jepsen_tpu_torch.lin import psort
from jepsen_tpu_torch.lin.psort import KEY_FILL

LANE = 128                # the reference's lane width; caps are multiples

# Column-scalar table rows (bfs._fused_row_tables builds them).
COL_EXP_LO, COL_EXP_HI = 0, 1
COL_PRED_LO, COL_PRED_HI = 2, 3
COL_RV_LO, COL_RV_HI = 4, 5
COL_OR_LO, COL_OR_HI = 6, 7
COL_PRE, COL_FLAGS = 8, 9
N_COL_ROWS = 10
FLAG_ACT, FLAG_WRITE, FLAG_JIT = 1, 2, 4
MAX_B = 6                 # state ids the per-column encoding takes
MAX_M = 32                # widest mutator-column bucket (bfs._M_BUCKETS)

# Kernel launches since import (or since a caller reset them): one per
# launch of the CUDA kernel in each key mode, none for the plain version.
LAUNCHES = {"fixpoint": 0, "fixpoint_pair": 0}


def max_n() -> int:
    """The fused kernel's candidate-space bound (padded keys): the
    reference's :data:`jepsen_tpu_torch.lin.psort.PSORT_MAX_N`, kept until
    a measurement on the H100 sets it."""
    return psort.PSORT_MAX_N


def fits(cap: int, M: int, b: int) -> bool:
    """Size and shape gate: the candidate space ``pad(cap * (1 + M))``
    within :func:`max_n`, cap a power of two of at least :data:`LANE`,
    and the packed state id within :data:`MAX_B` bits."""
    return (b <= MAX_B and cap >= LANE and (cap & (cap - 1)) == 0
            and psort.pad_size(cap * (1 + M)) <= max_n())


def _check_args(lo, hi, count, cols, sats, cap, b, it_max):
    if lo.dtype != torch.int32 or tuple(lo.shape) != (cap,):
        raise ValueError(f"lo must be int32[{cap}], got "
                         f"{lo.dtype}{list(lo.shape)}")
    if hi is not None and (hi.dtype != torch.int32 or hi.shape != lo.shape
                           or hi.device != lo.device):
        raise ValueError(f"hi must be None or int32[{cap}] on lo's device, "
                         f"got {hi.dtype}{list(hi.shape)}")
    if cols.dtype != torch.int32 or cols.dim() != 2 \
            or cols.shape[0] != N_COL_ROWS \
            or not 1 <= cols.shape[1] <= MAX_M:
        raise ValueError(f"cols must be int32[{N_COL_ROWS}, M<={MAX_M}], "
                         f"got {cols.dtype}{list(cols.shape)}")
    if not 1 <= b <= MAX_B or sats.dtype != torch.int32 \
            or tuple(sats.shape) != (2, 1 << b):
        raise ValueError(f"sats must be int32[2, {1 << b}] with "
                         f"1 <= b <= {MAX_B}, got b={b} "
                         f"{sats.dtype}{list(sats.shape)}")
    if not fits(cap, int(cols.shape[1]), b):
        raise ValueError(f"fixpoint: cap={cap} M={cols.shape[1]} b={b} "
                         "outside fits()")
    if it_max < 0:
        raise ValueError(f"it_max must be >= 0, got {it_max}")
    dev = lo.device
    if isinstance(count, torch.Tensor) and count.device != dev \
            or cols.device != dev or sats.device != dev:
        raise ValueError("lo, count, cols and sats must share a device")


def _as_tuple(lo, hi, flags):
    """The reference's (lo, hi, count, converged, overflow) view of a
    ``*_flags`` result."""
    return lo, hi, flags[3], flags[0] != 0, flags[1] != 0


def fixpoint(lo, hi, count, cols, sats, *, cap: int, b: int, it_max: int):
    """Run one whole closure fixpoint. ``lo`` raw int32[cap] carried keys
    (KEY_FILL-compacted), ``hi`` their raw int32[cap] high words for pair
    keys or None for single keys, ``count`` the carried count (int32
    tensor or int), ``cols`` raw int32[10, M] and ``sats`` raw
    int32[2, 2^b] from ``bfs._fused_row_tables``. Returns (lo[cap],
    hi[cap] or None, count, converged, overflow) as tensors on lo's
    device; on overflow count is the unclamped survivor total. A view of
    :func:`fixpoint_flags`."""
    return _as_tuple(*fixpoint_flags(lo, hi, count, cols, sats, cap=cap,
                                     b=b, it_max=it_max))


def fixpoint_plain(lo, hi, count, cols, sats, *, cap: int, b: int,
                   it_max: int):
    """:func:`fixpoint` in torch ops, a view of
    :func:`fixpoint_flags_plain`."""
    return _as_tuple(*fixpoint_flags_plain(lo, hi, count, cols, sats,
                                           cap=cap, b=b, it_max=it_max))


def fixpoint_flags(lo, hi, count, cols, sats, *, cap: int, b: int,
                   it_max: int):
    """:func:`fixpoint` with its flags as one tensor: returns (lo[cap],
    hi[cap] or None, flags int32[4] = (converged, overflow, passes,
    count)), so a caller reads every flag with one fetch. On a CUDA
    tensor it launches the kernel (``csrc/psort_fused.cu`` through
    :mod:`jepsen_tpu_torch.lin.psort_fused_cuda`) or raises, without
    synchronising with the host; on a CPU tensor it runs the plain
    version."""
    _check_args(lo, hi, count, cols, sats, cap, b, it_max)
    if lo.device.type == "cpu":
        return _plain(lo, hi, count, cols, sats, cap, b, it_max)
    if lo.device.type != "cuda":
        raise ValueError(f"fixpoint runs on cuda or cpu, not {lo.device}")
    if not (lo.is_contiguous() and cols.is_contiguous()
            and sats.is_contiguous()
            and (hi is None or hi.is_contiguous())):
        raise ValueError("fixpoint needs contiguous tensors")
    from jepsen_tpu_torch.lin import psort_fused_cuda

    if isinstance(count, torch.Tensor):
        cnt_in = count.reshape(1).to(torch.int32)
    else:
        # A fill kernel, not a host-to-device copy, which would wait for
        # the stream.
        cnt_in = torch.full((1,), int(count), dtype=torch.int32,
                            device=lo.device)
    n_pad = psort.pad_size(cap * (1 + int(cols.shape[1])))
    out = psort_fused_cuda.fixpoint(lo, hi, cnt_in, cols, sats, cap, b,
                                    n_pad, it_max)
    LAUNCHES["fixpoint" if hi is None else "fixpoint_pair"] += 1
    return out


def fixpoint_flags_plain(lo, hi, count, cols, sats, *, cap: int, b: int,
                         it_max: int):
    """:func:`fixpoint_flags` in torch ops on int64 words, on any device.
    It follows ``jepsen_tpu.lin.psort_fused._fixpoint_body`` pass for
    pass: saturate, expand, sort, first-of-run dedup, compact, and the
    same changed / overflow / it_max loop test. Pair keys compute on the
    64-bit pattern (:func:`jepsen_tpu_torch._u32.pair_bits`) and sort as
    pair keys."""
    _check_args(lo, hi, count, cols, sats, cap, b, it_max)
    return _plain(lo, hi, count, cols, sats, cap, b, it_max)


def _plain(lo, hi, count, cols, sats, cap, b, it_max):
    dev = lo.device
    pair = hi is not None
    M = int(cols.shape[1])
    n_pad = psort.pad_size(cap * (1 + M))
    smask = (1 << b) - 1
    cw = _u32.widen(cols)
    if pair:
        # Bit algebra on the 64-bit pattern; its dead entry is all ones,
        # its invalid flag bit 63, and it sorts with bit 63 flipped.
        def word(r_lo, r_hi):
            return _u32.pair_bits(cols[r_hi], cols[r_lo]).unsqueeze(1)

        fill, invalid, flip = -1, _u32.SIGN64, _u32.SIGN64
        sat = _u32.pair_bits(sats[1], sats[0])
        x = _u32.pair_bits(hi, lo)
    else:
        def word(r_lo, r_hi):
            return cw[r_lo].unsqueeze(1)

        fill, invalid, flip = KEY_FILL, 1 << 31, 0
        sat = _u32.widen(sats)[0]
        x = _u32.widen(lo)
    exp = word(COL_EXP_LO, COL_EXP_HI)
    pred = word(COL_PRED_LO, COL_PRED_HI)
    rv = word(COL_RV_LO, COL_RV_HI)
    or_ = word(COL_OR_LO, COL_OR_HI)
    pre = cw[COL_PRE].unsqueeze(1)
    flg = cw[COL_FLAGS].unsqueeze(1)
    col_on = (flg & FLAG_ACT) != 0
    is_write = (flg & FLAG_WRITE) != 0
    jit_static = (flg & FLAG_JIT) != 0
    tail = torch.full((n_pad - (1 + M) * cap,), fill, dtype=torch.int64,
                      device=dev)
    first = torch.arange(n_pad, device=dev) == 0

    def live_of(v):
        # Liveness reads the high word alone for pairs, as the reference.
        return (v >> 32) != -1 if pair else v != fill

    cnt = int(count)
    it = 0
    changed, ovf = True, False
    while changed and not ovf and it < it_max:
        x1 = torch.where(live_of(x), x | sat[x & smask], x)
        base = x1.unsqueeze(0)                          # [1, cap]
        legal = live_of(base) & col_on \
            & (is_write | ((base & smask) == pre)) \
            & ((base & exp) == 0) & ((base & pred) == pred) \
            & (jit_static | ((rv & ~base) != 0))
        blocks = torch.where(legal, (base & ~smask) | or_, fill)
        s, _ = torch.sort(torch.cat([x1, blocks.reshape(-1), tail]) ^ flip)
        s = s ^ flip
        keep = ((s & invalid) == 0) & (first | (s != torch.roll(s, 1)))
        total = int(keep.sum())
        surv = s[keep][:cap]
        new = torch.full((cap,), fill, dtype=torch.int64, device=dev)
        new[:surv.numel()] = surv
        changed = bool((new != x).any()) or total != cnt
        x, cnt = new, total
        ovf = total > cap
        it += 1
    converged = not changed and not ovf
    flags = torch.tensor([int(converged), int(ovf), it, cnt],
                         dtype=torch.int32, device=dev)
    if pair:
        out_hi, out_lo = _u32.pair_split(x ^ flip)
        return out_lo, out_hi, flags
    return _u32.narrow(x), None, flags
