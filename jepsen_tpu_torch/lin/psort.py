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
- :func:`dedup_keys_dom`, :func:`dedup_keys2_dom` — sort-dedup with
  dominance pruning for the crash-dom bands, on (group, dominance word)
  pairs of single keys or of pair keys: the semantics twins of the sparse
  engine's ``bfs._dedup_keys_dom`` and ``bfs._dedup_keys2_dom``.

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
# The compaction kernels' size gate: the reference's, kept until measured.
PSORT_MAX_N = 1 << 19
# The dedup kernels' size gate, set on the H100 (chip_smoke.py phases 10
# and 14): the radix kernel against the engine's torch.sort twin
# (bfs._dedup_keys_sort / _dedup_keys2_sort) at n = 2^19, 2^20 and 2^21.
# It is also the kernels' limit (kDedupMaxN in psort.cu).
DEDUP_MAX_N = 1 << 21
KEY_FILL = 0xFFFFFFFF     # pad beyond count; sorts after any config
KEY_FILL_RAW = -1         # KEY_FILL as the int32 that carries its bits
_INVALID = 1 << 31

# The dominance prune of the crash-dom dedups (the reference's values).
# Unforced, each entry is tested against its group's representative and
# the predecessors at the DOM_WINDOW distances while the padded size is at
# most DOM_WINDOW_MAX_N; forced, against every predecessor of its group
# at distances 1..DOM_CHAIN, and the prune and an order-preserving
# compaction of the survivors run ``iters`` rounds (DOM_ITERS in the
# reference's Pallas kernels; the engine passes 2 in-chunk and 6 in the
# host-row executor).
DOM_WINDOW = (1, 2)
DOM_WINDOW_MAX_N = 1 << 18
DOM_CHAIN = 128
DOM_ITERS = 2
# The dominance kernels take every size the engine gives them (the host
# caps reach 524288 x (1 + M) candidates).
DOM_MAX_N = 1 << 26
# The pair dominance dedup runs in one launch up to this padded size (the
# in-chunk tiers 256 .. 4,096 at M 32), set on the H100 (chip_smoke.py
# phase 19: the one launch against the multi-launch chain on the pair
# crash-dom headline's candidates at each tier, every candidate valid,
# and random keys at the gate). One block sorts a call's valid entries,
# which beats the chain's 14 or more launches while they are few (the
# headline's fullest calls hold 168 .. 1,809) and loses to its 132 SMs
# on dense random keys; larger calls, the upper tiers and the host-row
# executor's caps, keep the multi-launch chain.
DOM_ONE_MAX_N = 1 << 18
# The single-key dominance dedup's twin gate, set on the H100 the same
# way (chip_smoke.py phase 19 on the single-key crash-dom headline's
# candidates at each tier, every candidate valid, and random keys at the
# gate): one launch beats the chain at the in-chunk tiers 256 .. 4,096
# (n_pad 8,192 .. 131,072 at M 16), even with every candidate valid, and
# loses to its 132 SMs on dense random keys at the gate; larger calls,
# the upper tiers and the host-row executor's caps, keep the chain.
DOM1_ONE_MAX_N = 1 << 18
# The pair compaction runs in one launch up to this padded size, and on
# the bitonic network above (up to PSORT_MAX_N), set on the H100
# (chip_smoke.py phase 14: both routes at every size of its
# COMPACT_SIZES on ascending-with-holes and arbitrary input, and the one
# launch against the engine's torch.sort on the pair headline's spike
# compactions). On the engine's input, which its return filter keeps
# ascending, one block wins up to 2^17 and loses from 2^18 to the
# network's 132 SMs (one SM's share of the traffic); on arbitrary input,
# which the engine does not send, it loses at every size; past
# PSORT_MAX_N the engine's torch.sort beats it too.
COMPACT2_ONE_MAX_N = 1 << 17
# The single-key compaction's twin gate, set on the H100 the same way
# (chip_smoke.py phase 10: both routes at every size of its
# COMPACT_SIZES on ascending-with-holes and arbitrary input, and at every
# size the sparse headline compacts at, on its own recorded inputs). On
# the engine's input one block wins up to 2^18 (0.1129 ms against the
# network's 0.1416 at 2^18, 0.0051 against 0.0138 at 2^10), a size
# further than the pairs as 4-byte keys halve its traffic, and loses
# from 2^19 (0.2220 against 0.1728); on arbitrary input, which the
# engine does not send, it loses at every size (0.0186 against 0.0136
# at 2^10, 4.3464 against 0.1734 at 2^19).
COMPACT_ONE_MAX_N = 1 << 18
# The one-launch compaction's limit at both key widths (kCompactOneMaxN
# in psort.cu).
COMPACT_ONE_LIMIT = 1 << 21

# Kernel launches since import (or since a caller reset them): one per
# launch of each CUDA kernel, none for the plain versions.
LAUNCHES = {"dedup_keys": 0, "compact_keys": 0, "dedup_keys2": 0,
            "compact_keys2": 0, "dedup_keys_dom": 0, "dedup_keys2_dom": 0}


def pad_size(n: int) -> int:
    """The kernel size for an n-element dedup: next power of two, at
    least :data:`MIN_N`."""
    return max(MIN_N, 1 << (n - 1).bit_length())


def dom_window(n: int, force: bool = False) -> tuple:
    """The dominance window of an n-element dedup: :data:`DOM_WINDOW`
    while the padded size is at most :data:`DOM_WINDOW_MAX_N` or when
    ``force`` (which also runs the chain over 1..DOM_CHAIN), else empty."""
    if force or pad_size(n) <= DOM_WINDOW_MAX_N:
        return DOM_WINDOW
    return ()


def available(n: int) -> bool:
    """Size gate of the compactions: the kernels take n-element inputs up
    to :data:`PSORT_MAX_N` (padded); larger ones take the torch.sort
    path."""
    return pad_size(n) <= PSORT_MAX_N


def dedup_available(n: int) -> bool:
    """Size gate of the dedups: the engine sends n-element dedups up to
    :data:`DEDUP_MAX_N` (padded) to :func:`dedup_keys` /
    :func:`dedup_keys2`, larger ones to its torch.sort twins."""
    return pad_size(n) <= DEDUP_MAX_N


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


def _kernel_args(keys: torch.Tensor, what: str, max_n: int) -> None:
    if keys.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {keys.device}")
    if pad_size(keys.numel()) > max_n:
        raise ValueError(f"{what} kernel takes at most {max_n} keys "
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
    _kernel_args(key, "dedup_keys", DEDUP_MAX_N)
    if not valid.is_contiguous():
        raise ValueError("dedup_keys needs contiguous tensors")
    from jepsen_tpu_torch.lin import psort_cuda

    out, flags = psort_cuda.dedup(key, valid, cap)
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
    filter's survivors are distinct by construction. On the card it runs
    in one launch up to :data:`COMPACT_ONE_MAX_N` (which keeps the
    input's order when its live keys arrive ascending, and sorts them
    otherwise), and on the bitonic network above."""
    _check(keys, cap, "compact_keys")
    if keys.device.type == "cpu":
        return compact_keys_plain(keys, cap)
    one = compact_one_launch(keys.numel())
    _kernel_args(keys, "compact_keys", COMPACT_ONE_LIMIT if one
                 else PSORT_MAX_N)
    from jepsen_tpu_torch.lin import psort_cuda

    if one:
        out, count = psort_cuda.compact_one(keys, cap)
    else:
        out, count = psort_cuda.compact(keys, cap, pad_size(keys.numel()))
    LAUNCHES["compact_keys"] += 1
    return out, count[0]


def compact_one_launch(n: int) -> bool:
    """Route of an n-key compaction on the card: one launch while its
    padded size is at most :data:`COMPACT_ONE_MAX_N`, else the bitonic
    network."""
    return pad_size(n) <= COMPACT_ONE_MAX_N


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


def _pair_kernel_args(hi, lo, what: str, max_n: int) -> None:
    _kernel_args(lo, what, max_n)
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
    _pair_kernel_args(hi, lo, "dedup_keys2", DEDUP_MAX_N)
    if not valid.is_contiguous():
        raise ValueError("dedup_keys2 needs contiguous tensors")
    from jepsen_tpu_torch.lin import psort_cuda

    out_hi, out_lo, flags = psort_cuda.dedup2(hi, lo, valid, cap)
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
    keys' device. On the card it runs in one launch up to
    :data:`COMPACT2_ONE_MAX_N` (which keeps the input's order when its
    live pairs arrive ascending, and sorts them otherwise), and on the
    bitonic network above."""
    _check2(hi, lo, cap, "compact_keys2")
    if lo.device.type == "cpu":
        return compact_keys2_plain(hi, lo, cap)
    one = compact2_one_launch(lo.numel())
    _pair_kernel_args(hi, lo, "compact_keys2",
                      COMPACT_ONE_LIMIT if one else PSORT_MAX_N)
    from jepsen_tpu_torch.lin import psort_cuda

    if one:
        out_hi, out_lo, count = psort_cuda.compact2_one(hi, lo, cap)
    else:
        out_hi, out_lo, count = psort_cuda.compact2(hi, lo, cap,
                                                    pad_size(lo.numel()))
    LAUNCHES["compact_keys2"] += 1
    return out_hi, out_lo, count[0]


def compact2_one_launch(n: int) -> bool:
    """Route of an n-pair compaction on the card: one launch while its
    padded size is at most :data:`COMPACT2_ONE_MAX_N`, else the bitonic
    network."""
    return pad_size(n) <= COMPACT2_ONE_MAX_N


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


# --- dominance dedups (the crash-dom bands) ---------------------------------


def _dom_rounds(n: int, force: bool, iters: int) -> tuple[int, int]:
    """(rounds, chain): prune rounds, and the predecessor distances
    1..chain each entry is tested against besides its representative."""
    if force:
        return max(1, iters), DOM_CHAIN
    window = dom_window(n, False)
    # The window is a run of distances from 1, so one bound describes it.
    assert window == tuple(range(1, len(window) + 1))
    return 1, len(window)


def dom_one_launch(n: int, pair: bool = True) -> bool:
    """Route of an n-entry dominance dedup of the pair band (``pair``) or
    the single-key band on the card: one launch while its padded size is
    at most the band's gate (:data:`DOM_ONE_MAX_N`,
    :data:`DOM1_ONE_MAX_N`), else the multi-launch chain."""
    return pad_size(n) <= (DOM_ONE_MAX_N if pair else DOM1_ONE_MAX_N)


def _check_dom(words, cap: int, what: str) -> None:
    _check(words[0], cap, what)
    for t in words[1:]:
        if t.dtype != torch.int32 or t.shape != words[0].shape \
                or t.device != words[0].device:
            raise ValueError(f"{what}: every word array must be raw int32 "
                             "with the same shape and device")


def _dom_kernel_args(words, what: str) -> None:
    t = words[0]
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    if pad_size(t.numel()) > DOM_MAX_N:
        raise ValueError(f"{what} kernel takes at most {DOM_MAX_N} keys "
                         f"padded, got {t.numel()}")
    if not all(x.is_contiguous() for x in words):
        raise ValueError(f"{what} needs contiguous tensors")


def dedup_keys_dom(a: torch.Tensor, w: torch.Tensor, cmask: int, rmask: int,
                   cap: int, *, force: bool, iters: int = DOM_ITERS):
    """Sort-dedup with dominance pruning over single keys. ``a`` raw
    int32[n] is each key's group part (mutator bits and state, the invalid
    flag in bit 31), ``w`` its dominance word (crashed bits as they are,
    read bits complemented); ``cmask``/``rmask`` the u32 masks of the
    row's crashed and read slots. Within a group (equal ``a``) an entry
    whose word is a strict superset of another's is dominated. Sorted by
    (a, w), an entry is dropped when it is invalid, a duplicate of its
    predecessor, or dominated by its group's first entry or by a
    predecessor within the window (``force``: the chain 1..DOM_CHAIN,
    with ``iters`` prune-and-compact rounds). The survivors' full keys
    ``(a & 0x7FFFFFFF) | (w & cmask) | (~w & rmask)`` are returned
    ascending: (keys int32[cap] with KEY_FILL padding, count int32 =
    min(total, cap), overflow bool = total > cap), on the keys' device.
    The CUDA path does not synchronise with the host."""
    _check_dom((a, w), cap, "dedup_keys_dom")
    if a.device.type == "cpu":
        return dedup_keys_dom_plain(a, w, cmask, rmask, cap, force=force,
                                    iters=iters)
    _dom_kernel_args((a, w), "dedup_keys_dom")
    from jepsen_tpu_torch.lin import psort_cuda

    n = a.numel()
    rounds, chain = _dom_rounds(n, force, iters)
    if dom_one_launch(n, pair=False):
        out, flags = psort_cuda.dedup_dom_one(a, w, cmask, rmask, cap, chain,
                                              rounds)
    else:
        out, flags = psort_cuda.dedup_dom(a, w, cmask, rmask, cap,
                                          pad_size(n), chain, rounds)
    LAUNCHES["dedup_keys_dom"] += 1
    return out, flags[0], flags[1] != 0


def _dom_prune(ga, gw, keys, invalid, chain: int):
    """One prune round over entries sorted by (group, word): ``ga`` and
    ``gw`` are int64 bit patterns of the group and the word, ``keys``
    equal exactly where both are equal, ``invalid`` the flagged entries
    (they sort last). Returns the keep mask."""
    n = ga.numel()
    idx = torch.arange(n, device=ga.device)
    no = torch.zeros(1, dtype=torch.bool, device=ga.device)
    start = torch.cat([~no, ga[1:] != ga[:-1]])
    dup = torch.cat([no, keys[1:] == keys[:-1]])
    # Each group's first index, broadcast over the group (the reference's
    # segmented scan): groups are contiguous after the sort.
    gfirst = torch.cummax(torch.where(start, idx, 0), 0)[0]
    f = gw[gfirst]
    dominated = ((f & ~gw) == 0) & (gw != f)
    # A predecessor at distance d is in the group exactly when d <= i -
    # gfirst[i]; past the valid entries' longest span no distance can
    # matter.
    n_valid = int((~invalid).sum())
    span = int((idx - gfirst)[:n_valid].max()) if n_valid else 0
    for d in range(1, min(chain, span) + 1):
        pw = gw[:-d]
        hit = (ga[d:] == ga[:-d]) & ((pw & ~gw[d:]) == 0) & (pw != gw[d:])
        dominated[d:] |= hit
    return ~invalid & ~dup & ~dominated


def _dom_rounds_plain(ga, gw, keys, invalid, rounds: int, chain: int):
    """The prune rounds on sorted (group, word) entries, compacting the
    survivors in order between rounds (the reference masks the rest to
    the fill and sorts again, which gives the same array). Returns the
    final (ga, gw, keep)."""
    n = ga.numel()
    keep = None
    for rnd in range(rounds):
        if rnd:
            m = keep.nonzero().squeeze(1)
            pad = n - m.numel()

            def pack(x, fill):
                return torch.cat([x[m], torch.full((pad,), fill,
                                                   dtype=x.dtype,
                                                   device=x.device)])

            ga, gw = pack(ga, -1), pack(gw, -1)
            keys, invalid = pack(keys, _u32.PAIR_FILL), pack(invalid, True)
        keep = _dom_prune(ga, gw, keys, invalid, chain)
    return ga, gw, keep


def dedup_keys_dom_plain(a: torch.Tensor, w: torch.Tensor, cmask: int,
                         rmask: int, cap: int, *, force: bool,
                         iters: int = DOM_ITERS):
    """:func:`dedup_keys_dom` in torch ops, on any device and at any size:
    one sort of the (a, w) pairs as pair keys, the prune rounds, then a
    sort of the survivors' full keys."""
    _check_dom((a, w), cap, "dedup_keys_dom")
    s, _ = torch.sort(_u32.pair_key(a, w))
    sa, sw = _u32.pair_split(s)
    ga, gw = _u32.widen(sa), _u32.widen(sw)
    invalid = (ga & _INVALID) != 0
    ga, gw, keep = _dom_rounds_plain(ga, gw, s, invalid,
                                     *_dom_rounds(a.numel(), force, iters))
    cm, rm = cmask & _u32.MASK32, rmask & _u32.MASK32
    full = (ga & 0x7FFFFFFF) | (gw & cm) | (~gw & rm)
    out, _ = torch.sort(torch.where(keep, full & _u32.MASK32, KEY_FILL))
    return _dom_out(out, keep.sum(), cap, KEY_FILL,
                    lambda k: (_u32.narrow(k),))


def _dom_out(out, total, cap: int, fill, split):
    """The first ``cap`` sorted keys (fill past the input) as the words
    ``split`` makes of them, the clamped count and the overflow flag."""
    if out.numel() < cap:
        out = torch.cat([out, torch.full((cap - out.numel(),), fill,
                                         dtype=out.dtype, device=out.device)])
    return (*split(out[:cap]), torch.clamp(total, max=cap).to(torch.int32),
            total > cap)


def _pair_word(hi: int, lo: int) -> int:
    """The int64 holding the bit pattern ``hi << 32 | lo`` of two u32
    values (as :func:`jepsen_tpu_torch._u32.pair_bits` of tensors)."""
    v = ((hi & _u32.MASK32) << 32) | (lo & _u32.MASK32)
    return v - (1 << 64) if v >> 63 else v


def dedup_keys2_dom(a_hi: torch.Tensor, a_lo: torch.Tensor,
                    w_hi: torch.Tensor, w_lo: torch.Tensor, cmask_hi: int,
                    cmask_lo: int, rmask_hi: int, rmask_lo: int, cap: int, *,
                    force: bool, iters: int = DOM_ITERS):
    """Pair-key twin of :func:`dedup_keys_dom`: the group part is the pair
    (a_hi, a_lo) with the invalid flag in a_hi's bit 31, the dominance
    word the pair (w_hi, w_lo); entries sort by the 128-bit key (a_hi,
    a_lo, w_hi, w_lo). The survivors' full keys are (hi, lo) =
    ``((a_hi & 0x7FFFFFFF) | (w_hi & cmask_hi) | (~w_hi & rmask_hi),
    a_lo | (w_lo & cmask_lo) | (~w_lo & rmask_lo))``, returned ascending:
    (hi int32[cap], lo int32[cap] with (KEY_FILL, KEY_FILL) padding, count
    int32, overflow bool). The CUDA path does not synchronise."""
    words = (a_hi, a_lo, w_hi, w_lo)
    _check_dom(words, cap, "dedup_keys2_dom")
    if a_lo.device.type == "cpu":
        return dedup_keys2_dom_plain(*words, cmask_hi, cmask_lo, rmask_hi,
                                     rmask_lo, cap, force=force, iters=iters)
    _dom_kernel_args(words, "dedup_keys2_dom")
    from jepsen_tpu_torch.lin import psort_cuda

    n = a_lo.numel()
    rounds, chain = _dom_rounds(n, force, iters)
    masks = (cmask_hi, cmask_lo, rmask_hi, rmask_lo)
    if dom_one_launch(n, pair=True):
        out_hi, out_lo, flags = psort_cuda.dedup2_dom_one(
            *words, *masks, cap, chain, rounds)
    else:
        out_hi, out_lo, flags = psort_cuda.dedup2_dom(
            *words, *masks, cap, pad_size(n), chain, rounds)
    LAUNCHES["dedup_keys2_dom"] += 1
    return out_hi, out_lo, flags[0], flags[1] != 0


def dedup_keys2_dom_plain(a_hi: torch.Tensor, a_lo: torch.Tensor,
                          w_hi: torch.Tensor, w_lo: torch.Tensor,
                          cmask_hi: int, cmask_lo: int, rmask_hi: int,
                          rmask_lo: int, cap: int, *, force: bool,
                          iters: int = DOM_ITERS):
    """:func:`dedup_keys2_dom` in torch ops, on any device and at any size:
    the 128-bit sort as two stable sorts (by word pair, then by group
    pair), the prune rounds, then a sort of the survivors' full pair
    keys."""
    words = (a_hi, a_lo, w_hi, w_lo)
    _check_dom(words, cap, "dedup_keys2_dom")
    n = a_lo.numel()
    ka, kw = _u32.pair_key(a_hi, a_lo), _u32.pair_key(w_hi, w_lo)
    order = torch.sort(kw, stable=True)[1]
    order = order[torch.sort(ka[order], stable=True)[1]]
    ka, kw = ka[order], kw[order]
    # Bit patterns (bit 63 = hi's bit 31) for the bit algebra.
    ga, gw = ka ^ _u32.SIGN64, kw ^ _u32.SIGN64
    invalid = ga < 0
    # Distinct (ka, kw) pairs in sorted order get distinct ranks: the dup
    # test compares both words.
    keys = torch.stack([ka, kw], 1)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=ka.device),
                      (keys[1:] == keys[:-1]).all(1)])
    pair_id = torch.cumsum(~same, 0)
    ga, gw, keep = _dom_rounds_plain(ga, gw, pair_id, invalid,
                                     *_dom_rounds(n, force, iters))
    cm, rm = _pair_word(cmask_hi, cmask_lo), _pair_word(rmask_hi, rmask_lo)
    full = (ga & ~_u32.SIGN64) | (gw & cm) | (~gw & rm)
    out, _ = torch.sort(torch.where(keep, full ^ _u32.SIGN64,
                                    _u32.PAIR_FILL))
    return _dom_out(out, keep.sum(), cap, _u32.PAIR_FILL, _u32.pair_split)
