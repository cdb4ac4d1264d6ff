"""The sparse frontier engine for wide windows.

The port of :mod:`jepsen_tpu.lin.bfs`: it decides histories past the dense
engine's bounds (windows 21-64, or more states than its bitmap holds) in
four bands, chosen by :func:`key_band`:

- the compact register band: read-value-match register histories
  (cas-register, register) with a few interned values, on single u32
  keys (window + state bits <= 31) or (hi, lo) u32 pairs (the
  cockroach-class concurrency), crash-free or with crashed ops (the
  crash-dom bands: the partition-nemesis histories of BASELINE config 5);
- the generic packed band: any other one-word packed kernel on single u32
  keys (a mutex past window 20, BASELINE config 3; a one-word set; a
  value-rich register), each pass stepping every slot of the window
  (:func:`_expand_keys`);
- the multiword band: states wider than one word (sets past 31 elements,
  the queues) and windows past the key bands, as bitsets of NW u32 words
  and state vectors (:func:`_search_chunk`, at the end of this module).

A config (linearized-slot bitset B, model state s) is the key
``B << b | s`` (state id NIL remapped to ``nil_id``). Where window + b
fits 31 bits it is ONE u32 key (the single-key band); up to 60 bits
(b <= 6) it is a pair of u32 words (hi, lo), ordered as
``hi << 32 | lo``, with the invalid flag in hi's bit 31 (the pair-key
band: cockroach's 30 processes give window 29, and 29 + 3 > 31). The
frontier is an ascending, deduplicated array of keys padded with
``KEY_FILL`` (both words, for pairs), carried on the device as raw int32
(:mod:`jepsen_tpu_torch._u32`); ``hi`` is None in the single-key band.
Per return event (row):

1. the just-in-time closure to fixpoint: saturate each config with the
   legal pure reads, expand it by the row's mutator columns
   (:func:`expansion_tables`: chain and JIT gates), sort-dedup; one
   launch of :func:`jepsen_tpu_torch.lin.psort_fused.fixpoint` where
   :func:`jepsen_tpu_torch.lin.psort_fused.fits` holds, else a host-
   driven chain of :func:`_closure_pass_keys_compact` passes, each one
   :func:`jepsen_tpu_torch.lin.psort.dedup_keys` (pairs:
   ``dedup_keys2``), grouped by G column groups as in the reference; the
   generic band's passes (:func:`_closure_pass_keys`) dedup through
   ``dedup_keys`` too, ungrouped and never fused;
2. the return filter: configs must hold the returner's bit, which is
   then dropped; :func:`jepsen_tpu_torch.lin.psort.compact_keys` (pairs:
   ``compact_keys2``) packs the survivors when any config was dropped.

Rows run on a count-tiered prefix of the frontier (:data:`ROW_TIERS`),
with a retry at the top tier on overflow; chunks of :data:`CHUNK` rows
escalate through the cap schedule from their entry frontier, and a
frontier past the last chunk cap hands off to spike mode
(:func:`_spike_rows`). The row loop is driven from the host: one
blocking fetch per row (count, converged, overflow, survivors of the
filter) picks the next row's tier, where the reference switches tiers on
the device. The multiword band runs the same chunk, escalation and spike
loops, one row of :func:`_search_chunk` (K = 1) at a time, with the
reference's memory-bounded spike ladder (:func:`_mw_spike_caps`).

With crashed ops the compact band becomes a crash-dom band: every closure
pass dedups with dominance pruning (:func:`_dedup_keys_dom`, pairs
:func:`_dedup_keys2_dom`: a config that consumed a superset of another's
crashed ops and a subset of its reads, in the same group, is dropped),
the closure is ungrouped and never fused, the row tiers stop at
:data:`CHUNK_TIER_CAP`, and a row that outgrows them runs in the host-row
executor (:func:`_host_rows`): one row at a time through
:data:`HOST_ROW_CAPS`, escalating from the row's entry frontier, with the
pass budget :func:`_host_it_max` (the source of ``overflow: budget``).
The generic and multiword bands run crashed ops through their ordinary
loops, with no dominance.

The search is supervised (:mod:`jepsen_tpu_torch.lin.supervise`): each
chunk (site ``chunk``), spike mini-chunk (``spike``) and host-row rung
(``host-fixpoint``, ``host-pass``) runs under the dispatch watchdog, on a
copy of the engine that owns its stats (:func:`_guarded`), and a wedge
or a fault there becomes the next rung of the host-row ladder (the fused
per-row fixpoint, then one closure pass a dispatch; on the CPU only,
then the CPU oracle, :func:`_host_row_cpu`) or an honest ``overflow:
wedge`` / ``fault`` unknown. ``check_packed`` checkpoints the frontier at committed row
boundaries and resumes from a checkpoint, and takes a carried frontier
(the incremental entry) and returns one (``partial=True``).

Not ported: the host-row executor's dispatch amortisations (episode
scheduler, K-row waves), which change no verdict.
"""

from __future__ import annotations

import copy
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from jepsen_tpu_torch import _u32, resolve_device, util
from jepsen_tpu_torch.lin import psort, psort_fused, supervise
from jepsen_tpu_torch.lin.prepare import PackedHistory, reduction_tables
from jepsen_tpu_torch.models.kernels import (F_CAS, F_WRITE, NIL,
                                             PACKED_STATE_KERNELS,
                                             READ_VALUE_MATCH_KERNELS,
                                             packed_state_bound)

# The reference's values, kept until a measurement on the H100 sets them.
# Chunk cap ladder of the generic packed and multiword bands.
DEFAULT_CAP_SCHEDULE = (256, 2048, 16384, 131072)
# Chunk cap ladder of the compact register band: a small first level and
# the top level the band runs at on the card.
PACKED_CAP_SCHEDULE = (16384, 131072)
# Spike-mode capacities, past the last chunk cap, in SPIKE_CHUNK-row
# mini-chunks; spike mode hands back at a mini-chunk boundary once the
# frontier is at most SPIKE_DROPBACK.
SPIKE_CAP_SCHEDULE = (262144, 524288, 1048576)
SPIKE_CHUNK = 32
SPIKE_DROPBACK = 32768
SPIKE_MIN_ROWS = 64       # rows a spike runs before it may hand back
MAX_DEVICE_WINDOW = 64
CHUNK = 512
# Row tiers: a row whose frontier is small runs on a prefix of the
# frontier array; the tier must hold TIER_MARGIN x the live count.
ROW_TIERS = (256, 1024, 4096, 16384, 65536)
TIER_MARGIN = 4
# Expansion-column buckets: tables are padded to the next bucket.
_M_BUCKETS = (4, 8, 16, 32)
# Candidate bound of a grouped closure pass (tier * (1 + Mg)); the
# reference's windowed-dominance bound, psort.DOM_WINDOW_MAX_N.
_GROUP_BOUND = 1 << 18
# The crash-dom bands: the in-chunk tier ceiling (rows that need more run
# in the host-row executor), the candidate bound that keeps every in-chunk
# closure ungrouped (tier * (1 + M) <= it for any window at these tiers),
# and the host-row executor's capacity ladder.
CHUNK_TIER_CAP = 65536
CHUNK_CAND_MAX = 1 << 22
HOST_ROW_CAPS = (4096, 16384, 65536, 262144, 524288)
# Prune rounds of the crash-dom dedups: in-chunk and in the host-row
# executor (whose rows are the frontier blowups).
DOM_ITERS_CHUNK = 2
DOM_ITERS_HOST = 6
# The multiword spike ladder's memory budget: the bytes of candidate rows
# a closure pass may hold (about 3 copies of cap * (W + 1) rows of
# 1 + NW + S words); the reference's value.
_MW_SPIKE_BUDGET_BYTES = 3 << 29

KEY_FILL = psort.KEY_FILL
ANALYZER = "gpu-bfs"


def _dedup_keys(key, valid, cap):
    """Single-u32-key sort-dedup (invalid flag in bit 31), survivors
    ascending with KEY_FILL padding. Within
    :func:`jepsen_tpu_torch.lin.psort.dedup_available` it is
    :func:`jepsen_tpu_torch.lin.psort.dedup_keys` (the kernel on the
    card); above it :func:`_dedup_keys_sort`, as the reference takes
    lax.sort there. Returns (keys[cap], count, overflow) as tensors."""
    if psort.dedup_available(key.numel()):
        return psort.dedup_keys(key, valid, cap)
    return _dedup_keys_sort(key, valid, cap)


def _dedup_keys_sort(key, valid, cap):
    """The reference's lax.sort dedup in torch.sort, for candidate spaces
    past the dedup kernels' size gate: sort the flag-folded keys, turn
    the invalid and repeated ones into KEY_FILL, and sort again to pack
    the survivors."""
    n = key.numel()
    w = _u32.widen(key) | ((~valid).to(torch.int64) << 31)
    s, _ = torch.sort(w)
    first = torch.arange(n, device=s.device) == 0
    mask = ((s >> 31) == 0) & (first | (s != torch.roll(s, 1)))
    total = mask.sum()
    out, _ = torch.sort(torch.where(mask, s, KEY_FILL))
    return (_u32.narrow(out[:cap]), torch.clamp(total, max=cap)
            .to(torch.int32), total > cap)


def _dedup_keys2(hi, lo, valid, cap):
    """Pair-key twin of :func:`_dedup_keys` for 64-bit configs (hi, lo
    raw int32 words, order ``hi << 32 | lo``, the invalid flag in hi's bit
    31): :func:`jepsen_tpu_torch.lin.psort.dedup_keys2` within the
    dedup kernels' size gate, :func:`_dedup_keys2_sort` above it. Returns
    (hi[cap], lo[cap], count, overflow) as tensors."""
    if psort.dedup_available(lo.numel()):
        return psort.dedup_keys2(hi, lo, valid, cap)
    return _dedup_keys2_sort(hi, lo, valid, cap)


def _dedup_keys2_sort(hi, lo, valid, cap):
    """The reference's two-key lax.sort dedup in torch.sort, for candidate
    spaces past the kernels' size gate: sort the flag-folded pair keys
    (:func:`jepsen_tpu_torch._u32.pair_key`), turn the invalid and
    repeated ones into the FILL pair, and sort again."""
    n = lo.numel()
    flagged = torch.where(valid, hi, hi | torch.iinfo(torch.int32).min)
    s, _ = torch.sort(_u32.pair_key(flagged, lo))
    first = torch.arange(n, device=s.device) == 0
    # pair_key flips bit 63: a pair whose hi has bit 31 clear is negative.
    mask = (s < 0) & (first | (s != torch.roll(s, 1)))
    total = mask.sum()
    out, _ = torch.sort(torch.where(mask, s, _u32.PAIR_FILL))
    out_hi, out_lo = _u32.pair_split(out[:cap])
    return (out_hi, out_lo, torch.clamp(total, max=cap).to(torch.int32),
            total > cap)


def _host_it_max(W: int) -> int:
    """Closure pass budget per (row, capacity) in the host-row executor:
    ungrouped convergence needs O(window) passes; past it the row is an
    honest ``budget`` overflow."""
    return 4 * W + 16


def _dom_split(key, valid, cmask: int, rmask: int):
    """A raw int32 key word as its dominance dedup's (group, word) pair
    over the crashed (``cmask``) and read (``rmask``) key bits, u32
    values: the group part is the other bits with the invalid flag in bit
    31, the word the crashed bits as they are and the read bits
    complemented, so that "crashed a subset and read a superset" is one
    subset test."""
    a = key & _u32.raw_word(~(cmask | rmask))
    a = torch.where(valid, a, a | torch.iinfo(torch.int32).min)
    w = (key & _u32.raw_word(cmask)) | (~key & _u32.raw_word(rmask))
    return a, w


def _dedup_keys_dom(key, valid, cap, cmask: int, rmask: int, *,
                    dom_force: bool = True, dom_iters: int = DOM_ITERS_CHUNK):
    """Single-key sort-dedup with dominance pruning over the row's crashed
    and read key bits (:func:`_dom_split`):
    :func:`jepsen_tpu_torch.lin.psort.dedup_keys_dom`, at any size.
    Returns (keys[cap], count, overflow) as tensors."""
    a, w = _dom_split(key, valid, cmask, rmask)
    return psort.dedup_keys_dom(a, w, cmask, rmask, cap, force=dom_force,
                                iters=dom_iters)


def _dom_split2(hi, lo, valid, cmask_hi: int, cmask_lo: int, rmask_hi: int,
                rmask_lo: int):
    """Pair-key twin of :func:`_dom_split`: (a_hi, a_lo, w_hi, w_lo), the
    invalid flag in a_hi's bit 31."""
    a_hi, w_hi = _dom_split(hi, valid, cmask_hi, rmask_hi)
    a_lo, w_lo = _dom_split(lo, torch.ones_like(valid), cmask_lo, rmask_lo)
    return a_hi, a_lo, w_hi, w_lo


def _dedup_keys2_dom(hi, lo, valid, cap, cmask_hi: int, cmask_lo: int,
                     rmask_hi: int, rmask_lo: int, *, dom_force: bool = True,
                     dom_iters: int = DOM_ITERS_CHUNK):
    """Pair-key twin of :func:`_dedup_keys_dom` (the masks' halves as u32
    values): :func:`jepsen_tpu_torch.lin.psort.dedup_keys2_dom`. Returns
    (hi[cap], lo[cap], count, overflow) as tensors."""
    words = _dom_split2(hi, lo, valid, cmask_hi, cmask_lo, rmask_hi,
                        rmask_lo)
    return psort.dedup_keys2_dom(*words, cmask_hi, cmask_lo, rmask_hi,
                                 rmask_lo, cap, force=dom_force,
                                 iters=dom_iters)


def _key_bit_words(pos):
    """(lo, hi) u32 masks for KEY-space bit position(s) ``pos`` (numpy
    int array; negative = no bit)."""
    pos = np.asarray(pos)
    live = pos >= 0
    lo = np.where(live & (pos < 32),
                  np.uint32(1) << (np.clip(pos, 0, 31).astype(np.uint32)),
                  np.uint32(0))
    hi = np.where(live & (pos >= 32),
                  np.uint32(1) << (np.clip(pos - 32, 0, 31)
                                   .astype(np.uint32)),
                  np.uint32(0))
    return lo, hi


def expansion_tables(p: PackedHistory, b: int):
    """Host-side mutator-compacted expansion tables in KEY space (slot j
    at key bit b + j), as :func:`jepsen_tpu.lin.bfs.expansion_tables`
    builds them: each row's active non-pure slots gathered into M
    columns (M bucketed by :data:`_M_BUCKETS`)::

        exp_lo/exp_hi[R, M]      u32  slot key-bit (0 = padding)
        exp_f[R, M]              i32  function id
        exp_v[R, M, VW]          i32  interned value words
        exp_act[R, M]            bool column live
        exp_pred_lo/_hi[R, M]    u32  canonical-chain predecessor key-bit
        crash_lo/crash_hi[R]     u32  key-space mask of crashed slots
        read_lo/read_hi[R]       u32  key-space mask of pure (read) slots
        exp_jit[R, M]            bool column statically useful
        exp_rv_lo/_hi[R, M]      u32  key-space mask of active reads
                                      whose value is the column's post-state

    ``exp_jit``/``exp_rv`` carry the just-in-time linearization reduction:
    a mutator expands only when it is the returner, feeds the returner's
    precondition chain, or makes a pending unheld read legal. Cached on
    the PackedHistory after first computation."""
    cached = getattr(p, "_expansion_tables", None)
    if cached is not None and cached[0] == b:
        return cached[1]

    pure, pred = reduction_tables(p)
    act = np.asarray(p.active)
    slot_f = np.asarray(p.slot_f)
    slot_v = np.asarray(p.slot_v)
    R, W = act.shape
    vw = slot_v.shape[2]
    mut = act & ~pure
    counts = mut.sum(axis=1)
    need = max(1, int(counts.max()) if R else 1)
    M = next((bk for bk in _M_BUCKETS if bk >= need), W)

    exp_lo = np.zeros((R, M), np.uint32)
    exp_hi = np.zeros((R, M), np.uint32)
    exp_f = np.zeros((R, M), np.int32)
    exp_v = np.zeros((R, M, vw), np.int32)
    exp_act = np.zeros((R, M), bool)
    exp_pred_lo = np.zeros((R, M), np.uint32)
    exp_pred_hi = np.zeros((R, M), np.uint32)
    exp_slot = np.full((R, M), -1, np.int64)

    rr, jj = np.nonzero(mut)
    mm = (mut.cumsum(axis=1) - 1)[rr, jj]
    exp_lo[rr, mm], exp_hi[rr, mm] = _key_bit_words(b + jj)
    exp_f[rr, mm] = slot_f[rr, jj]
    exp_v[rr, mm] = slot_v[rr, jj]
    exp_act[rr, mm] = True
    exp_slot[rr, mm] = jj
    pj = pred[rr, jj]
    pl_, ph_ = _key_bit_words(np.where(pj >= 0, b + pj, -1))
    exp_pred_lo[rr, mm] = pl_
    exp_pred_hi[rr, mm] = ph_

    crash_lo = np.zeros(R, np.uint32)
    crash_hi = np.zeros(R, np.uint32)
    cr, cj = np.nonzero(np.asarray(p.crashed) & act)
    cl_, ch_ = _key_bit_words(b + cj)
    np.bitwise_or.at(crash_lo, cr, cl_)
    np.bitwise_or.at(crash_hi, cr, ch_)
    read_lo = np.zeros(R, np.uint32)
    read_hi = np.zeros(R, np.uint32)
    pr_, pj_ = np.nonzero(pure & act)
    rl_, rh_ = _key_bit_words(b + pj_)
    np.bitwise_or.at(read_lo, pr_, rl_)
    np.bitwise_or.at(read_hi, pr_, rh_)

    # --- JIT-linearization gating tables ---------------------------------
    exp_jit = np.ones((R, M), bool)
    exp_rv_lo = np.zeros((R, M), np.uint32)
    exp_rv_hi = np.zeros((R, M), np.uint32)
    if R:
        V = 1 << b
        # Post-state and precondition per column as value bitmasks over
        # state ids (< 2^b <= 64, one u64 per row); NIL words map to the
        # nil state id, a real reachable state.
        nil_sid = max(len(p.unintern), 2)

        def as_sid(w):
            return np.where(w == NIL, nil_sid, w)

        is_cas = exp_f == F_CAS
        is_wr = exp_f == F_WRITE
        post = np.where(is_cas, as_sid(exp_v[:, :, 1]),
                        as_sid(exp_v[:, :, 0]))
        post = np.where(exp_act & (is_cas | is_wr), post, -1)
        pre_v = np.where(exp_act & is_cas, as_sid(exp_v[:, :, 0]), -1)

        def vbit(ids):
            ok = (ids >= 0) & (ids < V)
            return np.where(ok, np.uint64(1) << np.clip(ids, 0, V - 1)
                            .astype(np.uint64), np.uint64(0))

        post_bit = vbit(post)
        pre_bit = vbit(pre_v)
        # Read-observed values per row (NIL reads match any state and
        # gate nothing).
        rv = np.where(pure & act & (slot_v[:, :, 0] != NIL)
                      & (slot_v[:, :, 0] >= 0),
                      slot_v[:, :, 0], -1)
        read_mask = np.bitwise_or.reduce(vbit(rv), axis=1)
        ret = np.asarray(p.ret_slot)
        is_ret_col = exp_slot == ret[:, None]
        ret_f = slot_f[np.arange(R), ret]
        ret_pre = np.where(ret_f == F_CAS,
                           as_sid(slot_v[np.arange(R), ret, 0]), -1)
        P = vbit(ret_pre)
        # Fixpoint: pre(m) joins P for every mutator m whose post-state
        # is in P or read-observed.
        for _ in range(V):
            useful = (post_bit & (P | read_mask)[:, None]) != 0
            P2 = P | np.bitwise_or.reduce(
                np.where(useful, pre_bit, np.uint64(0)), axis=1)
            if np.array_equal(P2, P):
                break
            P = P2
        exp_jit = is_ret_col | ((post_bit & P[:, None]) != 0)
        rv_lo_v = np.zeros((R, V), np.uint32)
        rv_hi_v = np.zeros((R, V), np.uint32)
        rr2, jj2 = np.nonzero((rv >= 0) & (rv < V))
        vv2 = rv[rr2, jj2]
        kl_, kh_ = _key_bit_words(b + jj2)
        np.bitwise_or.at(rv_lo_v, (rr2, vv2), kl_)
        np.bitwise_or.at(rv_hi_v, (rr2, vv2), kh_)
        pcl = np.clip(post, 0, V - 1)
        has_post = (post >= 0) & (post < V)
        exp_rv_lo = np.where(
            has_post, np.take_along_axis(rv_lo_v, pcl, axis=1), 0) \
            .astype(np.uint32)
        exp_rv_hi = np.where(
            has_post, np.take_along_axis(rv_hi_v, pcl, axis=1), 0) \
            .astype(np.uint32)

    out = (exp_lo, exp_hi, exp_f, exp_v, exp_act, exp_pred_lo,
           exp_pred_hi, crash_lo, crash_hi, read_lo, read_hi,
           exp_jit, exp_rv_lo, exp_rv_hi)
    p._expansion_tables = (b, out)
    return out


def reduction_bit_tables(p: PackedHistory, nw: int):
    """Host-side (pure[R,W], pred_bit[R,W,nw]) from
    :func:`jepsen_tpu_torch.lin.prepare.reduction_tables`: predecessor
    slot indices as per-word bitmasks (all zero without a predecessor)."""
    pure, pred = reduction_tables(p)
    R, W = pred.shape
    pred_bit = np.zeros((R, W, nw), np.uint32)
    rr, jj = np.nonzero(pred >= 0)
    pj = pred[rr, jj]
    pred_bit[rr, jj, pj // 32] = np.uint32(1) << (pj % 32).astype(np.uint32)
    return pure, pred_bit


def _sat_tables(act, v_row, pure_row, *, W, b, nil_id):
    """Saturation tables: pure-slot legality is a plain value match, so
    the key-space mask of legal pure reads depends only on the state id.
    ``act``/``pure_row`` [..., W], ``v_row`` [..., W, VW] (numpy, any
    leading row axes) -> (sat_lo, sat_hi) u32 [..., 2^b]; hi is zero for
    windows inside one word. The one definition the unfused pass and the
    fused kernel's tables share."""
    kbit_lo, kbit_hi = _key_bit_words(b + np.arange(W))
    sid = np.arange(1 << b, dtype=np.int64)
    raw = np.where(sid == nil_id, int(NIL), sid)
    v0 = np.asarray(v_row)[..., 0].astype(np.int64)            # [..., W]
    m = (v0[..., None] == int(NIL)) | (v0[..., None] == raw)   # [..., W, V]
    cond = m & (np.asarray(pure_row) & np.asarray(act))[..., None]
    sat_lo = np.bitwise_or.reduce(
        np.where(cond, kbit_lo[:, None], np.uint32(0)), axis=-2)
    sat_hi = np.bitwise_or.reduce(
        np.where(cond, kbit_hi[:, None], np.uint32(0)), axis=-2)
    return sat_lo.astype(np.uint32), sat_hi.astype(np.uint32)


def _fused_row_tables(exp_r, act, v_row, pure_row, *, W, b, nil_id):
    """Per-row scalar tables of the fused fixpoint
    (:mod:`jepsen_tpu_torch.lin.psort_fused`): the register family's
    mutator step is a value match (a write always applies, a cas iff the
    state is its precondition), so legality and successor per (column,
    state) collapse to per-column scalars. ``exp_r`` holds the
    :func:`expansion_tables` arrays with any leading row axes; returns
    ``cols`` u32[..., 10, M] (key bit, chain mask, rv mask, the OR-in word
    for new keys with the post-state id and its saturation mask, the cas
    precondition id, act/write/jit flags) and ``sats`` u32[..., 2, 2^b]
    (:func:`_sat_tables`)."""
    (exp_lo, exp_hi, exp_f, exp_v, exp_act, exp_pred_lo, exp_pred_hi,
     _cl, _ch, _rl, _rh, exp_jit, exp_rv_lo, exp_rv_hi) = exp_r
    sat_lo, sat_hi = _sat_tables(act, v_row, pure_row, W=W, b=b,
                                 nil_id=nil_id)
    is_cas = exp_f == F_CAS
    is_wr = exp_f == F_WRITE

    def as_sid(w):
        return np.where(w == NIL, nil_id, w).astype(np.uint32)

    # A write's precondition never matches (state ids are < 2^b).
    pre = np.where(is_cas, as_sid(exp_v[..., 0]), np.uint32(0xFFFF))
    post = np.where(is_cas, as_sid(exp_v[..., 1]), as_sid(exp_v[..., 0]))
    post_i = np.clip(post.astype(np.int64), 0, (1 << b) - 1)
    or_lo = exp_lo | np.take_along_axis(sat_lo, post_i, axis=-1) | post
    or_hi = exp_hi | np.take_along_axis(sat_hi, post_i, axis=-1)
    flags = (exp_act.astype(np.uint32) * psort_fused.FLAG_ACT
             | is_wr.astype(np.uint32) * psort_fused.FLAG_WRITE
             | exp_jit.astype(np.uint32) * psort_fused.FLAG_JIT)
    cols = np.stack([exp_lo, exp_hi, exp_pred_lo, exp_pred_hi, exp_rv_lo,
                     exp_rv_hi, or_lo, or_hi, pre, flags],
                    axis=-2).astype(np.uint32)
    sats = np.stack([sat_lo, sat_hi], axis=-2)
    return cols, sats


class RowTables(NamedTuple):
    """One row's device tables for the unfused closure pass (wide int64
    words): the mutator columns and the saturation table. The hi words
    are the key bits past bit 31; all zero in the single-key band."""

    exp_lo: torch.Tensor        # [M]
    exp_hi: torch.Tensor        # [M]
    exp_f: torch.Tensor         # [M]
    exp_v: torch.Tensor         # [M, VW]
    exp_act: torch.Tensor       # [M] bool
    exp_pred_lo: torch.Tensor   # [M]
    exp_pred_hi: torch.Tensor   # [M]
    exp_jit: torch.Tensor       # [M] bool
    exp_rv_lo: torch.Tensor     # [M]
    exp_rv_hi: torch.Tensor     # [M]
    sat_lo: torch.Tensor        # [2^b]
    sat_hi: torch.Tensor        # [2^b]

    def columns(self, lo: int, hi: int) -> "RowTables":
        """The tables of columns [lo, hi), zero-padded past M (padding
        columns are inactive)."""
        M = self.exp_lo.shape[0]

        def cut(t):
            part = t[lo:min(hi, M)]
            if part.shape[0] == hi - lo:
                return part
            pad = torch.zeros((hi - lo - part.shape[0],) + t.shape[1:],
                              dtype=t.dtype, device=t.device)
            return torch.cat([part, pad])

        return RowTables(*(cut(t) for t in self[:-2]), self.sat_lo,
                         self.sat_hi)


def _expand_keys_compact(lo_in, hi_in, count, tbl: RowTables, *, cap, b,
                         nil_id, step_fn):
    """The candidate half of :func:`_closure_pass_keys_compact`: in-place
    saturation of the carried keys and their expansion by the mutator
    columns with the chain and JIT gates. ``lo_in`` raw int32[cap],
    ``hi_in`` its high words for pair keys or None, ``count`` the carried
    count. Returns (cand_lo raw int32[cap*(1+M)], cand_hi or None,
    cand_valid bool)."""
    dev = lo_in.device
    pair = hi_in is not None
    x = _u32.widen(lo_in)
    cfg_valid = torch.arange(cap, device=dev) < count
    smask = (1 << b) - 1
    n_sid = 1 << b
    sv = torch.where(cfg_valid, x, 0) & smask
    state = torch.where(cfg_valid, torch.where(sv == nil_id, int(NIL), sv),
                        0)
    M = tbl.exp_lo.shape[0]
    ok, new_state = step_fn(state.view(cap, 1, 1), tbl.exp_f.view(1, M),
                            tbl.exp_v.unsqueeze(0))
    nsv = new_state[..., 0]
    pns = torch.where(nsv == int(NIL), nil_id, nsv)
    in_range = (pns >= 0) & (pns < n_sid)
    pidx = pns.clamp(0, n_sid - 1)
    nsat_lo = torch.where(in_range, tbl.sat_lo[pidx], 0)
    lo1 = torch.where(cfg_valid, x | tbl.sat_lo[sv], x)

    l1 = lo1.unsqueeze(1)
    already = (l1 & tbl.exp_lo) != 0
    chain_ok = (l1 & tbl.exp_pred_lo) == tbl.exp_pred_lo
    jit_ok = tbl.exp_jit | ((tbl.exp_rv_lo & ~l1) != 0)
    if pair:
        hi1 = torch.where(cfg_valid, _u32.widen(hi_in) | tbl.sat_hi[sv],
                          _u32.widen(hi_in))
        h1 = hi1.unsqueeze(1)
        already = already | ((h1 & tbl.exp_hi) != 0)
        chain_ok = chain_ok & ((h1 & tbl.exp_pred_hi) == tbl.exp_pred_hi)
        jit_ok = jit_ok | ((tbl.exp_rv_hi & ~h1) != 0)
    fresh = ok & tbl.exp_act & ~already & cfg_valid.unsqueeze(1)
    legal = fresh & chain_ok & jit_ok
    new_lo = ((l1 & ~smask) | tbl.exp_lo | nsat_lo | pns) & _u32.MASK32
    cand = torch.cat([torch.where(cfg_valid, lo1, 0), new_lo.reshape(-1)])
    cand_valid = torch.cat([cfg_valid, legal.reshape(-1)])
    cand_hi = None
    if pair:
        nsat_hi = torch.where(in_range, tbl.sat_hi[pidx], 0)
        new_hi = h1 | tbl.exp_hi | nsat_hi
        cand_hi = _u32.narrow(torch.cat([torch.where(cfg_valid, hi1, 0),
                                         new_hi.reshape(-1)]))
    return _u32.narrow(cand), cand_hi, cand_valid


def _closure_pass_keys_compact(lo_in, hi_in, count, tbl: RowTables, *,
                               cap, b, nil_id, step_fn, dom=None,
                               dom_iters: int = DOM_ITERS_CHUNK):
    """ONE closure pass over packed keys with mutator-compacted expansion
    columns (single u32 keys, or (hi, lo) pairs when ``hi_in`` is given):
    expand, sort-dedup, and test the fixpoint against the pass INPUT.
    ``dom`` (crash-dom bands) is the row's (crash_lo, crash_hi, read_lo,
    read_hi) key masks: the dedup then prunes dominated configs in the
    forced mode with ``dom_iters`` rounds, as every call site of the
    reference's crash-dom band does. Returns (lo, hi or None, count,
    changed, overflow) as tensors."""
    cand, cand_hi, valid = _expand_keys_compact(
        lo_in, hi_in, count, tbl, cap=cap, b=b, nil_id=nil_id,
        step_fn=step_fn)
    if hi_in is not None:
        if dom is not None:
            cl, ch, rl, rh = dom
            h2, l2, n2, o2 = _dedup_keys2_dom(cand_hi, cand, valid, cap, ch,
                                              cl, rh, rl,
                                              dom_iters=dom_iters)
        else:
            h2, l2, n2, o2 = _dedup_keys2(cand_hi, cand, valid, cap)
        changed = torch.any(l2 != lo_in) | torch.any(h2 != hi_in) \
            | (n2 != count)
        return l2, h2, n2, changed, o2
    if dom is not None:
        l2, n2, o2 = _dedup_keys_dom(cand, valid, cap, dom[0], dom[2],
                                     dom_iters=dom_iters)
    else:
        l2, n2, o2 = _dedup_keys(cand, valid, cap)
    changed = torch.any(l2 != lo_in) | (n2 != count)
    return l2, None, n2, changed, o2


def _expand_keys(keys_in, count, act, f_row, v_row, pure_row, pred_row, *,
                 cap, b, nil_id, step_fn):
    """The candidates of one generic packed-band closure pass over single
    u32 keys (``bits << b | state id``), the generic branch of
    :func:`jepsen_tpu.lin.bfs._expand_keys`: unpack, step every (config,
    slot), saturate the carried keys in place with their legal pure slots
    (expansions pick theirs up when carried), and gate expansion by the
    canonical chain. ``keys_in`` raw int32[cap]; ``act``/``pure_row``
    bool[W], ``f_row`` [W], ``v_row`` [W, VW], ``pred_row`` [W] (the
    slot-space predecessor masks), int64 on the keys' device. Returns
    (cand raw int32[cap * (1 + W)], cand_valid bool)."""
    dev = keys_in.device
    W = act.shape[0]
    slot_bit = torch.ones(W, dtype=torch.int64, device=dev) \
        << torch.arange(W, device=dev)
    cfg_valid = torch.arange(cap, device=dev) < count
    k = _u32.widen(keys_in)
    cfg = torch.where(cfg_valid, k, 0)
    bits1 = cfg >> b
    sv = cfg & ((1 << b) - 1)
    state = torch.where(cfg_valid, torch.where(sv == nil_id, int(NIL), sv),
                        0)
    ok, new_state = step_fn(state.view(cap, 1, 1), f_row.view(1, W),
                            v_row.unsqueeze(0))
    already = (bits1.unsqueeze(1) & slot_bit) != 0
    fresh = ok & act & ~already & cfg_valid.unsqueeze(1)
    nsv = new_state[..., 0].to(torch.int64)
    pns = torch.where(nsv == int(NIL), nil_id, nsv) & _u32.MASK32
    # Distinct slot bits, so their sum is their OR.
    sat = ((fresh & pure_row).to(torch.int64) * slot_bit).sum(1)
    keys = torch.where(cfg_valid, k | (sat << b), k)
    bits1 = bits1 | sat
    chain_ok = (bits1.unsqueeze(1) & pred_row) == pred_row
    legal = fresh & ~pure_row & chain_ok
    new_keys = (((bits1.unsqueeze(1) | slot_bit) << b) | pns) & _u32.MASK32
    cand = torch.cat([torch.where(cfg_valid, keys, 0), new_keys.reshape(-1)])
    cand_valid = torch.cat([cfg_valid, legal.reshape(-1)])
    return _u32.narrow(cand), cand_valid


def _closure_pass_keys(keys_in, count, act, f_row, v_row, pure_row, pred_row,
                       *, cap, b, nil_id, step_fn):
    """ONE generic packed-band closure pass: :func:`_expand_keys`'s
    candidates through :func:`_dedup_keys`, the fixpoint tested against
    the pass INPUT (the stable set holds a config and its saturated twin).
    Returns (keys, count, changed, overflow) as tensors."""
    cand, valid = _expand_keys(keys_in, count, act, f_row, v_row, pure_row,
                               pred_row, cap=cap, b=b, nil_id=nil_id,
                               step_fn=step_fn)
    k2, n2, o2 = _dedup_keys(cand, valid, cap)
    changed = torch.any(k2 != keys_in) | (n2 != count)
    return k2, n2, changed, o2


def _filter_pass_keys(keys, count: int, s: int, *, cap, b,
                      n_keep: int | None = None):
    """Return-event filter over packed keys: the returner (slot ``s``)
    must be linearized; survivors drop its bit. Dropping a bit every
    survivor holds is injective and monotone, so when nothing is dropped
    the pass is one bit-clear, and otherwise the dropped entries become
    KEY_FILL and one sort (:func:`jepsen_tpu_torch.lin.psort.compact_keys`)
    compacts. ``count`` and ``s`` are host ints; ``n_keep`` (the
    survivor count, when the caller fetched it already) saves a fetch.
    Returns (keys, count, dead) with host ints."""
    bit = _u32.raw_word(1 << (b + s))
    cfg_valid = torch.arange(cap, device=keys.device) < count
    if n_keep is None:
        keep = cfg_valid & ((keys & bit) != 0)
        n_keep = int(keep.sum())          # a blocking fetch
    if n_keep == count:
        return (torch.where(cfg_valid, keys & ~bit, keys), count,
                count == 0)
    keep = cfg_valid & ((keys & bit) != 0)
    dropped = torch.where(keep, keys & ~bit, psort.KEY_FILL_RAW)
    if psort.available(cap):
        keys, _ = psort.compact_keys(dropped, cap)
    else:
        # Past the kernels' size gate, the reference's lax.sort.
        keys = _u32.narrow(torch.sort(_u32.widen(dropped))[0])
    return keys, n_keep, n_keep == 0


def _pack_frontier_keys(bits, state, count, cap, b, nil_id):
    """The packed-key encoding ``bits << b | state-id`` (NIL remapped to
    nil_id), KEY_FILL past count, padded or cut to ``cap``: int64 tensors
    ``bits`` [n, 1], ``state`` [n, 1] -> raw int32[cap]."""
    n = bits.shape[0]
    dev = bits.device
    sv = state[:, 0].to(torch.int64)
    ps = torch.where(sv == int(NIL), nil_id, sv)
    live = torch.arange(n, device=dev) < count
    keys = torch.where(live, (bits[:, 0].to(torch.int64) << b) | ps,
                       KEY_FILL)
    if cap > n:
        keys = torch.cat([keys, torch.full((cap - n,), KEY_FILL,
                                           dtype=torch.int64, device=dev)])
    return _u32.narrow(keys[:cap])


def _unpack_frontier_keys(keys, count, cap, b, nil_id):
    """Inverse of :func:`_pack_frontier_keys`: raw int32 keys ->
    (bits int64[cap, 1], state int64[cap, 1] with NIL restored), zero
    past count."""
    k = _u32.widen(keys[:cap])
    live = torch.arange(k.numel(), device=k.device) < count
    cfg = torch.where(live, k, 0)
    sv = cfg & ((1 << b) - 1)
    state = torch.where(live, torch.where(sv == nil_id, int(NIL), sv), 0)
    return (cfg >> b).unsqueeze(1), state.unsqueeze(1)


def _key_bit(pos: int) -> tuple[int, int]:
    """Raw (lo, hi) words of the single KEY-space bit ``pos``."""
    if pos < 32:
        return _u32.raw_word(1 << pos), 0
    return 0, _u32.raw_word(1 << (pos - 32))


def _filter_pass_keys2(lo, hi, count: int, s: int, *, cap, b,
                       n_keep: int | None = None):
    """Pair-key return filter (see :func:`_filter_pass_keys`: an injective
    bit drop, one bit-clear when nothing is dropped, else one compacting
    sort, :func:`jepsen_tpu_torch.lin.psort.compact_keys2`). The
    returner's key bit b + s lies in either word. Returns (lo, hi, count,
    dead) with host ints."""
    bit_lo, bit_hi = _key_bit(b + s)
    cfg_valid = torch.arange(cap, device=lo.device) < count
    keep = cfg_valid & (((lo & bit_lo) | (hi & bit_hi)) != 0)
    if n_keep is None:
        n_keep = int(keep.sum())          # a blocking fetch
    if n_keep == count:
        return (torch.where(cfg_valid, lo & ~bit_lo, lo),
                torch.where(cfg_valid, hi & ~bit_hi, hi), count, count == 0)
    d_hi = torch.where(keep, hi & ~bit_hi, psort.KEY_FILL_RAW)
    d_lo = torch.where(keep, lo & ~bit_lo, psort.KEY_FILL_RAW)
    if psort.available(cap):
        hi, lo, _ = psort.compact_keys2(d_hi, d_lo, cap)
    else:
        # Past the kernels' size gate, the reference's two-key lax.sort.
        hi, lo = _u32.pair_split(torch.sort(_u32.pair_key(d_hi, d_lo))[0])
    return lo, hi, n_keep, n_keep == 0


def _pack_frontier_keys2(bits, state, count, cap, b, nil_id):
    """The pair-key encoding of windows past 31 - b bits: the 64-bit config
    ``bitset << b | state-id`` split into (lo, hi) u32 words, (KEY_FILL,
    KEY_FILL) past count, padded or cut to ``cap``. int64 tensors ``bits``
    [n, nw] (u32 words), ``state`` [n, 1] -> raw int32 (lo[cap],
    hi[cap])."""
    n = bits.shape[0]
    dev = bits.device
    sv = state[:, 0].to(torch.int64)
    ps = torch.where(sv == int(NIL), nil_id, sv)
    b0 = bits[:, 0].to(torch.int64)
    b1 = bits[:, 1].to(torch.int64) if bits.shape[1] > 1 \
        else torch.zeros_like(b0)
    lo = ((b0 << b) | ps) & _u32.MASK32
    hi = ((b0 >> (32 - b)) | (b1 << b)) & _u32.MASK32
    live = torch.arange(n, device=dev) < count
    lo = torch.where(live, lo, KEY_FILL)
    hi = torch.where(live, hi, KEY_FILL)
    if cap > n:
        pad = torch.full((cap - n,), KEY_FILL, dtype=torch.int64,
                         device=dev)
        lo, hi = torch.cat([lo, pad]), torch.cat([hi, pad])
    return _u32.narrow(lo[:cap]), _u32.narrow(hi[:cap])


def _unpack_frontier_keys2(lo, hi, count, cap, b, nil_id, nw):
    """Inverse of :func:`_pack_frontier_keys2`: raw int32 (lo, hi) ->
    (bits int64[cap, nw] of u32 words, state int64[cap, 1] with NIL
    restored), zero past count."""
    live = torch.arange(cap, device=lo.device) < count
    lo = torch.where(live, _u32.widen(lo[:cap]), 0)
    hi = torch.where(live, _u32.widen(hi[:cap]), 0)
    mask = (1 << b) - 1
    sv = lo & mask
    state = torch.where(live, torch.where(sv == nil_id, int(NIL), sv), 0)
    cols = [(lo >> b) | ((hi & mask) << (32 - b))]
    if nw > 1:
        cols.append(hi >> b)
    cols += [torch.zeros_like(lo)] * (nw - len(cols))
    return torch.stack(cols, dim=1), state.unsqueeze(1)


def _chunk_slice(a: np.ndarray, base: int, chunk: int) -> np.ndarray:
    """Static-shape chunk slice, zero-padded past the end of the table."""
    end = min(base + chunk, a.shape[0])
    part = a[base:end]
    if part.shape[0] == chunk:
        return part
    pad = np.zeros((chunk - part.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([part, pad], axis=0)


def _fill(n: int, device) -> torch.Tensor:
    return torch.full((n,), psort.KEY_FILL_RAW, dtype=torch.int32,
                      device=device)


def _resize(lo: torch.Tensor, hi, cap: int):
    """The frontier words cut or KEY_FILL-padded to ``cap`` (live keys are
    a prefix, so cutting past the count drops nothing); ``hi`` None stays
    None."""
    def fit(t):
        if t.shape[0] >= cap:
            return t[:cap]
        return torch.cat([t, _fill(cap - t.shape[0], t.device)])

    return fit(lo), None if hi is None else fit(hi)


def band_error(p: PackedHistory) -> str | None:
    """None when this engine takes the history, else the reason: no step
    kernel, or a window past the device bitset."""
    if p.kernel is None:
        return f"no device kernel for {type(p.model).__name__}"
    if p.window > MAX_DEVICE_WINDOW:
        return (f"concurrency window {p.window} exceeds device bitset "
                f"width {MAX_DEVICE_WINDOW}")
    return None


def key_band(p: PackedHistory, packed_keys: bool | None = None) -> str:
    """The band that decides ``p`` (a history :func:`band_error` passes):
    ``"compact"`` (read-value-match registers with b <= 6 state bits, on
    single keys to window + b <= 31 and pair keys to 60), ``"generic"``
    (another one-word packed kernel, on single keys to 31) or
    ``"multiword"`` (the rest). ``packed_keys=False`` forces the
    multiword band, as in the reference."""
    name = p.kernel.name
    if p.state_width == 1 and name in PACKED_STATE_KERNELS \
            and packed_keys is not False:
        b = packed_state_bound(p.kernel, len(p.unintern)).bit_length()
        rvm = name in READ_VALUE_MATCH_KERNELS and b <= 6
        if p.window + b <= 31:
            return "compact" if rvm else "generic"
        if rvm and p.window + b <= 60:
            return "compact"
    return "multiword"


class ChunkOut(NamedTuple):
    """A chunk's result. ``rows_done`` counts the dead or overflowing row
    itself; ``pre_*`` are the frontier before the last row run (the spike
    hand-off and its explain snapshot start there). ``hi``/``pre_hi`` are
    the pair keys' high words, None on single keys; in the multiword band
    ``lo``/``hi`` are the bits and the states (:class:`_MWEngine`)."""

    lo: torch.Tensor
    hi: torch.Tensor | None
    count: int
    rows_done: int
    dead: bool
    ovf: bool
    pre_lo: torch.Tensor
    pre_hi: torch.Tensor | None
    pre_count: int


class _Engine:
    """One history's packed-key search state in the compact band: host
    tables, their per-chunk device copies, and the row and chunk loops
    (:class:`_GenericEngine` is the generic band's). A frontier is ``lo``
    and, in the pair-key band (window + b > 31), ``hi``; ``hi`` is None on
    single keys, as the reference threads ``key_hi``."""

    resize = staticmethod(_resize)

    def __init__(self, p: PackedHistory, device):
        self.p = p
        self.dev = device
        self.nil_id = packed_state_bound(p.kernel, len(p.unintern))
        self.b = self.nil_id.bit_length()
        self.W = p.window
        self.nw = (p.window + 31) // 32
        self.pair = p.window + self.b > 31
        self.step_fn = p.kernel.step
        self.pure_h, pred_bit = reduction_bit_tables(p, self.nw)
        self._init_band(pred_bit)
        self.max_tier = CHUNK_TIER_CAP if self.crash_dom else None
        self._chunk_key = None
        # Work counters: rows run per tier, fused rows, unfused closure
        # passes (per tier), return filters that dropped configs (one
        # compacting sort each), top-tier retries, and blocking
        # device-to-host fetches.
        self.stats = {"rows": 0, "tiers": {}, "fused_rows": 0,
                      "unfused_passes": 0, "unfused_tiers": {},
                      "compactions": 0, "retries": 0, "fetches": 0}
        # The host-row executor's counters (the reference's per-row path):
        # episodes entered, rows run, closure dispatches (a fused fixpoint
        # run, or one pass of the per-pass rung), closure passes inside
        # them, passes of runs thrown away by an escalation, rows whose
        # sticky-raised starting level held (hits) or escalated all the
        # same (misses); and the supervision's: watchdog trips, faults,
        # dispatches routed past a quarantined shape, and rows decided on
        # the CPU oracle.
        self.host_stats = _host_stats()

    @property
    def band(self) -> str:
        """The band this engine searches in, as a result's ``band`` names
        it: ``compact`` or ``crash-dom``, ``pair-`` before either on pair
        keys."""
        return ("pair-" if self.pair else "") \
            + ("crash-dom" if self.crash_dom else "compact")

    def _init_band(self, pred_bit) -> None:
        """The compact band expands by mutator-compacted columns (M of
        them). Crashed ops put it in a crash-dom band: dominance dedups,
        in-chunk tiers capped at CHUNK_TIER_CAP, and the host-row executor
        past them."""
        del pred_bit
        self.exp_h = expansion_tables(self.p, self.b)
        self.M = int(self.exp_h[0].shape[-1])
        self.crash_dom = bool(np.asarray(self.p.crashed).any())

    def attempt(self):
        """A shallow copy of the engine with a fresh stats dict, for one
        guarded attempt (:func:`_guarded`): it shares the immutable
        tables, keeps its own table bindings when the engine loads
        others, and writes only its own stats, merged back by
        :meth:`harvest` when the attempt is the one harvested."""
        a = copy.copy(self)
        a.stats = _fresh_stats(self.stats)
        return a

    def harvest(self, stats: dict) -> None:
        _merge_stats(self.stats, stats)

    def from_frontier(self, bits, state, count: int, cap: int):
        """A frontier in the multiword layout (numpy ``bits`` u32[n, nw'],
        ``state`` i32[n, 1], the checkpoint's and the incremental entry's)
        as key words of ``cap`` keys on the engine's device; ``nw'`` may
        be below the engine's (zero high words)."""
        n = int(count)
        fb = np.zeros((n, self.nw), np.int64)
        src = np.asarray(bits)[:n, :self.nw]
        fb[:, :src.shape[1]] = src
        bt = torch.from_numpy(fb).to(self.dev)
        st = torch.from_numpy(np.asarray(state)[:n, :1].astype(np.int64)) \
            .to(self.dev)
        if self.pair:
            return _pack_frontier_keys2(bt, st, n, cap, self.b, self.nil_id)
        return _pack_frontier_keys(bt[:, :1], st, n, cap, self.b,
                                   self.nil_id), None

    def to_frontier(self, lo, hi, n: int):
        """The first ``n`` configs of a frontier in the multiword layout:
        numpy (bits u32[n, nw], state i32[n, 1])."""
        bits, state = self.unpack(lo, hi, n)
        bits = bits[:n].cpu().numpy()
        if bits.shape[1] < self.nw:
            bits = np.pad(bits, ((0, 0), (0, self.nw - bits.shape[1])))
        return (bits.astype(np.uint32),
                state[:n].cpu().numpy().astype(np.int32))

    def cap_schedule(self, device) -> tuple:
        """The default cap schedule. Row tiers make small frontiers cheap
        at any cap, so on the card the compact band runs top-cap from the
        start; the CPU keeps a small first level."""
        return PACKED_CAP_SCHEDULE[-1:] if device.type == "cuda" \
            else PACKED_CAP_SCHEDULE

    def init_keys(self, cap: int):
        """The initial frontier (empty bitset, the initial state) as
        (lo, hi) words of ``cap`` keys; hi is None for single keys."""
        bits = torch.zeros((1, self.nw), dtype=torch.int64, device=self.dev)
        state = torch.as_tensor(np.asarray(self.p.init_state, np.int64),
                                device=self.dev).view(1, 1)
        if self.pair:
            return _pack_frontier_keys2(bits, state, 1, cap, self.b,
                                        self.nil_id)
        return _pack_frontier_keys(bits[:, :1], state, 1, cap, self.b,
                                   self.nil_id), None

    def unpack(self, lo, hi, count: int):
        """A frontier decoded to (bits int64[cap, nw], state int64[cap,
        1])."""
        if hi is None:
            return _unpack_frontier_keys(lo, count, lo.shape[0], self.b,
                                         self.nil_id)
        return _unpack_frontier_keys2(lo, hi, count, lo.shape[0], self.b,
                                      self.nil_id, self.nw)

    def spike_levels(self, top: int, spike_caps):
        """The spike capacities past the chunked top cap ``top`` (None
        when there are none)."""
        return tuple(sorted(c for c in spike_caps if c > top)) or None

    def load_chunk(self, base: int, rows: int) -> None:
        """Device tables for rows [base, base + rows)."""
        if self._chunk_key == (base, rows):
            return
        p, dev = self.p, self.dev
        act = _chunk_slice(np.asarray(p.active), base, rows)
        v_row = _chunk_slice(np.asarray(p.slot_v), base, rows)
        pure = _chunk_slice(self.pure_h, base, rows)
        self.ret = _chunk_slice(np.asarray(p.ret_slot), base, rows).tolist()

        def put(a, dtype=np.int64):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        sl = [_chunk_slice(t, base, rows) for t in self.exp_h]
        cols, sats = _fused_row_tables(tuple(sl), act, v_row, pure, W=self.W,
                                       b=self.b, nil_id=self.nil_id)
        self.cols = _u32.bitmap_from_numpy(cols, dev)
        self.sats = _u32.bitmap_from_numpy(sats, dev)
        (exp_lo, exp_hi, exp_f, exp_v, exp_act, exp_pred_lo, exp_pred_hi,
         _cl, _ch, _rl, _rh, exp_jit, exp_rv_lo, exp_rv_hi) = sl
        self.rows = RowTables(
            put(exp_lo), put(exp_hi), put(exp_f), put(exp_v),
            put(exp_act, bool), put(exp_pred_lo), put(exp_pred_hi),
            put(exp_jit, bool), put(exp_rv_lo), put(exp_rv_hi),
            put(sats[:, 0]), put(sats[:, 1]))
        # The rows' (crash_lo, crash_hi, read_lo, read_hi) key masks.
        self.dom = np.stack(sl[7:11], axis=1).tolist() if self.crash_dom \
            else None
        self._chunk_key = (base, rows)

    def row_tables(self, r: int) -> RowTables:
        return RowTables(*(t[r] for t in self.rows))

    def row_dom(self, r: int):
        """Row r's dominance masks for the closure's dedup, or None outside
        the crash-dom bands."""
        return None if self.dom is None else tuple(self.dom[r])

    def row_at_tier(self, tier: int, r: int, lo, hi, count: int,
                    fused: bool):
        """One full row (closure fixpoint + return filter) on the first
        ``tier`` entries of the frontier; ``fused`` allows the fused
        fixpoint where it fits. Returns (lo[cap], hi[cap] or None, count,
        dead, overflow) with host ints and flags."""
        cap = lo.shape[0]
        l_t, h_t = _resize(lo, hi, tier)
        s = self.ret[r]
        st = self.stats
        st["rows"] += 1
        st["tiers"][tier] = st["tiers"].get(tier, 0) + 1
        l_t, h_t, cnt, ovf, n_keep = self._closure(l_t, h_t, count, r, tier,
                                                   fused)
        if ovf:
            return lo, hi, cnt, False, True
        if n_keep is None:
            # The return filter's fetch (the fused fixpoint's one fetch
            # carried its survivor count).
            st["fetches"] += 1
        if h_t is None:
            l_t, count, dead = _filter_pass_keys(l_t, cnt, s, cap=tier,
                                                 b=self.b, n_keep=n_keep)
        else:
            l_t, h_t, count, dead = _filter_pass_keys2(
                l_t, h_t, cnt, s, cap=tier, b=self.b, n_keep=n_keep)
        if count != cnt:
            st["compactions"] += 1
        l_t, h_t = _resize(l_t, h_t, cap)
        return l_t, h_t, count, dead, False

    def _closure(self, lo, hi, count: int, r: int, tier: int, fused: bool):
        """Row r's closure fixpoint on ``tier`` keys: the fused fixpoint
        where ``fused`` allows it and it fits (not with the dominance
        dedups), else the grouped pass chain. Returns (lo, hi, count,
        overflow, n_keep), ``n_keep`` the return filter's survivors when
        the fused fixpoint fetched them, else None."""
        M = self.M
        # The crash-dom bands' bound keeps the closure ungrouped.
        bound = CHUNK_CAND_MAX if self.crash_dom else _GROUP_BOUND
        Mg = max(1, bound // tier - 1)
        G = -(-M // Mg) if Mg < M else 1
        Mg = min(Mg, M)
        # Convergence needs O(G * window) passes; exhaustion flags
        # overflow, which retries at the top tier or escalates.
        it_max = G * (self.W + 4) + 8
        if not (fused and not self.crash_dom
                and psort_fused.fits(tier, M, self.b)):
            return (*self._closure_unfused(lo, hi, count, r, tier, G, Mg,
                                           it_max), None)
        lo, hi, flags = psort_fused.fixpoint_flags(
            lo, hi, count, self.cols[r], self.sats[r], cap=tier, b=self.b,
            it_max=it_max)
        bit_lo, bit_hi = _key_bit(self.b + self.ret[r])
        held = (lo & bit_lo) if hi is None \
            else (lo & bit_lo) | (hi & bit_hi)
        keep = (torch.arange(tier, device=self.dev) < flags[3]) \
            & (held != 0)
        # The row's one blocking fetch: the flags and the survivors of
        # the return filter.
        self.stats["fused_rows"] += 1
        self.stats["fetches"] += 1
        conv, o2, _, cnt, n_keep = torch.cat(
            (flags, keep.sum().to(torch.int32).view(1))).tolist()
        return lo, hi, cnt, bool(o2 or not conv), n_keep

    def _pass_done(self, tier: int, n2, changed, o2):
        """Count one unfused closure pass and fetch its (count, changed,
        overflow) flags: the pass's blocking fetch."""
        n2, changed, o2 = torch.stack(
            (n2.to(torch.int32), changed.to(torch.int32),
             o2.to(torch.int32))).tolist()
        st = self.stats
        st["unfused_passes"] += 1
        st["unfused_tiers"][tier] = st["unfused_tiers"].get(tier, 0) + 1
        st["fetches"] += 1
        return n2, changed, o2

    def _closure_unfused(self, lo, hi, count: int, r: int, tier: int,
                         G: int, Mg: int, it_max: int):
        """The grouped pass chain: columns Mg at a time, ending after G
        consecutive unchanged passes; one fetch per pass. Returns (lo,
        hi, count, overflow)."""
        tbl = self.row_tables(r)
        dom = self.row_dom(r)
        groups = [tbl.columns(g * Mg, (g + 1) * Mg)
                  for g in range(G)] if G > 1 else [tbl]
        g = since = it = 0
        ovf = False
        while since < G and not ovf:
            supervise.check_stop()
            l2, h2, n2, changed, o2 = _closure_pass_keys_compact(
                lo, hi, count, groups[g], cap=tier, b=self.b,
                nil_id=self.nil_id, step_fn=self.step_fn, dom=dom)
            n2, changed, o2 = self._pass_done(tier, n2, changed, o2)
            g = 0 if g + 1 >= G else g + 1
            since = 0 if changed else since + 1
            # Converging exactly at the budget is convergence, not
            # overflow.
            ovf = ovf or bool(o2) or (it + 1 >= it_max and since < G)
            it += 1
            lo, hi, count = l2, h2, n2
        return lo, hi, count, ovf

    def host_pass(self, r: int, lo, hi, count: int, cap: int, tbl=None,
                  dom=None):
        """ONE closure pass of the host-row executor for row r at ``cap``
        (the per-pass rung's dispatch): ungrouped, with the forced
        dominance dedup at :data:`DOM_ITERS_HOST` rounds, and its one
        fetch; ``tbl``/``dom`` are row r's tables when the caller has
        them. Returns (lo, hi, count, changed, overflow) with host ints
        and flags."""
        l2, h2, n2, ch, o2 = _closure_pass_keys_compact(
            lo, hi, count, self.row_tables(r) if tbl is None else tbl,
            cap=cap, b=self.b, nil_id=self.nil_id, step_fn=self.step_fn,
            dom=self.row_dom(r) if tbl is None else dom,
            dom_iters=DOM_ITERS_HOST)
        n2, ch, o2 = torch.stack((n2.to(torch.int32), ch.to(torch.int32),
                                  o2.to(torch.int32))).tolist()
        self.stats["fetches"] += 1
        return l2, h2, n2, bool(ch), bool(o2)

    def host_filter(self, r: int, lo, hi, count: int, cap: int):
        """Row r's return filter on a converged closure at ``cap``.
        Returns (lo, hi, count)."""
        s = self.ret[r]
        if hi is None:
            lo, count, _ = _filter_pass_keys(lo, count, s, cap=cap, b=self.b)
        else:
            lo, hi, count, _ = _filter_pass_keys2(lo, hi, count, s, cap=cap,
                                                  b=self.b)
        return lo, hi, count

    def host_fixpoint(self, r: int, lo, hi, count: int, cap: int,
                      it_max: int):
        """The host-row executor's closure fixpoint for row r at ``cap``
        (the fused rung's dispatch): :meth:`host_pass` until a pass
        changes nothing, a dedup overflows, or ``it_max`` passes ran; when
        converged, the return filter. Returns (lo, hi, converged, dedup
        overflow, passes, count, peak), the count after the filter and the
        peak the largest settled count of a pass (at least the entry
        count)."""
        tbl, dom = self.row_tables(r), self.row_dom(r)
        it, changed, ovf, peak = 0, True, False, count
        while changed and not ovf and it < it_max:
            supervise.check_stop()
            lo, hi, count, changed, o2 = self.host_pass(r, lo, hi, count,
                                                        cap, tbl, dom)
            it += 1
            ovf, peak = ovf or o2, max(peak, count)
        conv = not changed and not ovf
        if conv:
            lo, hi, count = self.host_filter(r, lo, hi, count, cap)
        return lo, hi, conv, ovf, it, count, peak

    def run_row(self, r: int, lo, hi, count: int, row_tiers: bool):
        cap = lo.shape[0]
        # The crash-dom bands' tiers stop at max_tier, below the cap.
        top = cap if self.max_tier is None else min(cap, self.max_tier)
        tiers = (tuple(t for t in ROW_TIERS if t < top) + (top,)
                 if row_tiers else (cap,))
        if tiers[-1] < cap and count > tiers[-1]:
            # An entry frontier past the top tier cannot run in-chunk
            # (cutting it to the tier would drop live configs): overflow,
            # untouched, and the host-row executor takes the row.
            return lo, hi, count, False, True
        # Spike mini-chunks (untiered) keep the unfused pass chain, as in
        # the reference.
        fused = row_tiers
        if len(tiers) == 1:
            return self.row_at_tier(tiers[0], r, lo, hi, count, fused)
        # Smallest tier holding TIER_MARGIN x the live count; an overflow
        # retries the row at the top tier (rows are functions of their
        # entry frontier, so the retry is exact).
        idx = sum(count * TIER_MARGIN > t for t in tiers[:-1])
        out = self.row_at_tier(tiers[idx], r, lo, hi, count, fused)
        if out[4] and idx < len(tiers) - 1:
            self.stats["retries"] += 1
            out = self.row_at_tier(tiers[-1], r, lo, hi, count, fused)
        return out

    def chunk(self, base: int, n_rows: int, rows: int, lo, hi, count: int,
              row_tiers: bool = True) -> ChunkOut:
        """Up to ``n_rows`` return events from row ``base`` (tables of
        ``rows`` rows), stopping at a death or an overflow."""
        self.load_chunk(base, rows)
        pre = (lo, hi, count)
        for r in range(n_rows):
            supervise.check_stop()
            pre = (lo, hi, count)
            lo, hi, count, dead, ovf = self.run_row(r, lo, hi, count,
                                                    row_tiers)
            if dead or ovf:
                return ChunkOut(lo, hi, count, r + 1, dead and not ovf, ovf,
                                *pre)
        return ChunkOut(lo, hi, count, n_rows, False, False, *pre)

    def spike_chunk(self, base: int, n_rows: int, rows: int, lo, hi,
                    count: int) -> ChunkOut:
        """A spike mini-chunk: :meth:`chunk` with untiered rows and the
        unfused pass chain, as in the reference."""
        return self.chunk(base, n_rows, rows, lo, hi, count,
                          row_tiers=False)


class _GenericEngine(_Engine):
    """The generic packed band: single u32 keys of any one-word packed
    kernel outside the compact band. Each closure pass steps every slot
    of the window (:func:`_closure_pass_keys`, no groups, no fused
    fixpoint); crashed ops need no dominance and run the ordinary loop."""

    band = "generic"

    def _init_band(self, pred_bit) -> None:
        self.pred_h = pred_bit[..., 0]
        self.M = self.W
        self.crash_dom = False

    def cap_schedule(self, device) -> tuple:
        return DEFAULT_CAP_SCHEDULE

    def load_chunk(self, base: int, rows: int) -> None:
        """Device tables for rows [base, base + rows)."""
        if self._chunk_key == (base, rows):
            return
        p = self.p

        def put(a, dtype=np.int64):
            return torch.from_numpy(np.ascontiguousarray(
                _chunk_slice(a, base, rows), dtype)).to(self.dev)

        self.ret = _chunk_slice(np.asarray(p.ret_slot), base, rows).tolist()
        self.gen = (put(np.asarray(p.active), bool), put(np.asarray(p.slot_f)),
                    put(np.asarray(p.slot_v)), put(self.pure_h, bool),
                    put(self.pred_h))
        self._chunk_key = (base, rows)

    def _closure(self, lo, hi, count: int, r: int, tier: int, fused: bool):
        """Row r's closure fixpoint on ``tier`` single keys: passes until
        one changes nothing, within ``W + 12`` passes; one fetch per
        pass. Returns (lo, None, count, overflow, None)."""
        del hi, fused
        row = tuple(t[r] for t in self.gen)
        it_max = self.W + 12
        it, changed, ovf = 0, True, False
        while changed and not ovf:
            supervise.check_stop()
            lo, n2, changed, o2 = _closure_pass_keys(
                lo, count, *row, cap=tier, b=self.b, nil_id=self.nil_id,
                step_fn=self.step_fn)
            count, changed, o2 = self._pass_done(tier, n2, changed, o2)
            # Converging exactly at the budget is convergence, not
            # overflow.
            ovf = bool(o2) or (it + 1 >= it_max and bool(changed))
            it += 1
        return lo, None, count, ovf, None


def _host_stats() -> dict:
    return {"episodes": 0, "rows": 0, "dispatches": 0, "passes": 0,
            "wasted_passes": 0, "sticky_hits": 0, "sticky_misses": 0,
            "watchdog_trips": 0, "faults": 0, "quarantine_skips": 0,
            "cpu_rows": 0}


def _fresh_stats(stats: dict) -> dict:
    """A zeroed stats dict of the same shape (nested dicts empty)."""
    return {k: {} if isinstance(v, dict) else 0 for k, v in stats.items()}


def _merge_stats(into: dict, add: dict) -> None:
    for k, v in add.items():
        if isinstance(v, dict):
            d = into.setdefault(k, {})
            for kk, vv in v.items():
                d[kk] = d.get(kk, 0) + vv
        else:
            into[k] = into.get(k, 0) + v


def _guarded(eng, site: str, key: str, run, *, scale: float = 1.0):
    """One supervised dispatch of ``run(attempt)`` on a copy of the engine
    (:meth:`_Engine.attempt`), ended on the host: the thunk waits for the
    device's stream before it returns, so the deadline covers device time.
    Returns ``(outcome, value)`` as :func:`supervise.run_guarded`; on
    ``"ok"`` the harvested attempt's stats are merged into the engine's.
    The tables ``run`` reads must be loaded on the engine before the call.
    """
    def thunk():
        a = eng.attempt()
        out = run(a)
        if eng.dev.type == "cuda":
            torch.cuda.current_stream(eng.dev).synchronize()
        return out, a.stats

    outcome, val = supervise.run_guarded(site, key, thunk, scale=scale,
                                         stats=eng.host_stats)
    if outcome != "ok":
        return outcome, val
    out, stats = val
    eng.harvest(stats)
    return "ok", out


def _shape_key(eng, site: str, cap: int, rows: int = 1) -> str:
    return supervise.shape_key(site, rows=rows, cap=cap, window=eng.W,
                               kernel=eng.p.kernel.name)


def _spike_rows(eng: _Engine, r0: int, lo, hi, count: int, *, caps,
                dropback, cancel, snapshots):
    """Spike mode: SPIKE_CHUNK-row mini-chunks at the spike capacities,
    with the same rows as normal chunks (untiered), each a supervised
    dispatch at site ``spike``. Processes mini-chunks from ``r0`` until
    death, cancel, overflow of the last cap, a wedge or fault of a
    mini-chunk, the history's end, or (after at least
    :data:`SPIKE_MIN_ROWS` rows) the frontier shrinking to ``dropback``.
    ``snapshots`` (a list) receives each mini-chunk's entry frontier, and
    on a death the dead row's own entry. Returns (lo, hi, count, next_row,
    dead, overflowed, cancelled, top_cap_used), ``overflowed`` False,
    True, or "wedged" / "fault"."""
    p = eng.p
    lvl = 0
    top_used = caps[0]
    lo, hi = eng.resize(lo, hi, caps[0])
    r = r0
    while r < p.R:
        if cancel is not None and cancel.is_set():
            return lo, hi, count, r, False, False, True, top_used
        if snapshots is not None:
            snapshots[:] = [(r, lo, hi, count)]
        m_n = min(SPIKE_CHUNK, p.R - r)
        eng.load_chunk(r, SPIKE_CHUNK)
        while True:
            outcome, out = _guarded(
                eng, "spike", _shape_key(eng, "spike", caps[lvl],
                                         SPIKE_CHUNK),
                lambda a, r=r, m_n=m_n, lo=lo, hi=hi, count=count:
                a.spike_chunk(r, m_n, SPIKE_CHUNK, lo, hi, count))
            if outcome != "ok":
                return (lo, hi, count, r, False,
                        "wedged" if outcome == "wedge" else "fault", False,
                        top_used)
            if not out.ovf:
                break
            if lvl + 1 >= len(caps):
                return lo, hi, count, r, False, True, False, top_used
            lvl += 1
            lo, hi = eng.resize(lo, hi, caps[lvl])
            top_used = caps[lvl]
        if out.dead:
            if snapshots is not None and out.rows_done > 1:
                # Anchor the explain replay at the dead row's entry, so
                # the CPU replay spans one row of a spike-sized frontier.
                snapshots[:] = [(r + out.rows_done - 1, out.pre_lo,
                                 out.pre_hi, out.pre_count)]
            return (out.lo, out.hi, out.count, r + out.rows_done, True,
                    False, False, top_used)
        lo, hi, count = out.lo, out.hi, out.count
        r += m_n
        if r - r0 >= SPIKE_MIN_ROWS and count <= dropback:
            break
    return lo, hi, count, r, False, False, False, top_used


def _host_row_cpu(p: PackedHistory, r: int, lo_h, hi_h, count: int, *,
                  b: int, nil_id: int, key_hi: bool, nw: int,
                  crash_dom: bool = False, cancel=None):
    """The last rung of the host-row ladder: row r's whole closure and
    return filter on the CPU oracle (``cpu.search_rows`` with
    ``reduce=True``), from the row's entry frontier as host key arrays
    (numpy u32, the first ``count`` live), decoded and re-encoded by the
    numpy codec: it touches no device. With ``crash_dom`` the survivors
    run the exact dominance prune of the dedups (crashed subset, read
    superset, in the same group) on the host. Raises ``cpu.Cancelled``
    through. Returns (lo, hi or None, count, dead): numpy u32 arrays of
    max(len(lo_h), survivors) keys, ascending, KEY_FILL padded."""
    from jepsen_tpu_torch.lin import cpu

    cap = int(lo_h.shape[0])
    bits, state = supervise.np_unpack_keys(lo_h, hi_h, count, b, nil_id, nw,
                                           key_hi, int(NIL))
    packed = bits[:, 0].astype(object)
    for w in range(1, bits.shape[1]):
        packed = packed | (bits[:, w].astype(object) << (32 * w))
    configs = set(zip((int(x) for x in packed), map(tuple, state.tolist())))
    try:
        configs, _ = cpu.search_rows(p, configs, None, r, r + 1,
                                     cancel=cancel, reduce=True)
    except cpu.Dead:
        return lo_h, hi_h, 0, True
    if crash_dom:
        pure_tbl, _pred = reduction_tables(p)
        act = np.asarray(p.active)[r]
        crashed = np.asarray(p.crashed)[r]
        cmask = rmask = 0
        for j in range(p.window):
            if act[j] and crashed[j]:
                cmask |= 1 << j
            elif act[j] and pure_tbl[r, j]:
                rmask |= 1 << j
        if cmask or rmask:
            # Group by (other bits, state); within a group X dominates Y
            # iff X's dominance word (crashed bits as they are, read bits
            # complemented) is a subset of Y's. A popcount-ascending scan
            # keeps the antichain: a dominator has fewer bits than its
            # victims.
            groups: dict = {}
            for bset, st in configs:
                w = (bset & cmask) | (~bset & rmask)
                groups.setdefault((bset & ~(cmask | rmask), st), []).append(
                    (bin(w).count("1"), w, bset))
            pruned = []
            for (_gbits, st), lst in groups.items():
                lst.sort()
                kept: list[int] = []
                for _pc, w, bset in lst:
                    if any((kw & ~w) == 0 for kw in kept):
                        continue
                    kept.append(w)
                    pruned.append((bset, st))
            configs = pruned
    n2 = len(configs)

    def enc(bset, st):
        sid = nil_id if st[0] == int(NIL) else st[0]
        return (bset << b) | sid

    ordered = sorted(configs, key=lambda c: enc(*c))
    bits2 = np.zeros((n2, nw), np.uint32)
    state2 = np.zeros((n2, 1), np.int32)
    for i, (bset, st) in enumerate(ordered):
        for w in range(nw):
            bits2[i, w] = (bset >> (32 * w)) & 0xFFFFFFFF
        state2[i, 0] = st[0]
    lo2, hi2 = supervise.np_pack_keys(bits2, state2, b, nil_id, key_hi,
                                      int(NIL), max(cap, n2))
    return lo2, hi2, n2, False


def _host_rows(eng: _Engine, r0: int, lo, hi, count: int, *, caps,
               dropback, cancel, snapshots, min_rows: int = 2, ckpt=None,
               sticky0=None):
    """The host-row executor of the crash-dom bands (the reference's
    per-row path with its fault ladder): rows one at a time from ``r0``,
    each a closure fixpoint with the return filter at a capacity of
    ``caps``, from the smallest holding TIER_MARGIN x the entry count or
    the sticky level, whichever is higher; an overflow or an exhausted
    pass budget re-runs the row from its entry frontier at the next
    capacity. The sticky level follows the capacity the last row needed
    and decays one level per row whose peak fits a lower one; ``sticky0``
    (a host-kind checkpoint's) raises the first row's.

    Each capacity's closure is one supervised dispatch of the fused
    fixpoint (:meth:`_Engine.host_fixpoint`, site ``host-fixpoint``,
    3 x the base deadline); a wedged, faulted or quarantined one falls to
    the per-pass rung (one :meth:`_Engine.host_pass` a dispatch, site
    ``host-pass``, the return filter after it unsupervised, as the
    reference's). The per-pass rung runs the same launches in smaller
    dispatches, so it carries a row that is slow, not one that is stuck
    or faulted. A wedged, faulted or quarantined pass ends the episode
    on the card with an honest "wedged" or "fault"; on the CPU
    (:func:`supervise.host_rungs`) the CPU oracle takes the row
    (:func:`_host_row_cpu`) from its entry frontier, and past
    ``supervise.cpu_row_max()`` the row gives up honestly ("wedged").
    ``ckpt`` (a :class:`supervise.Checkpointer`) saves the committed
    frontier after each row, with the sticky level and the host stats.

    Stops at a death, a cancel, an overflow of the last capacity, the
    history's end, or (after ``min_rows`` rows) a frontier of at most
    ``dropback``. ``snapshots`` receives each row's entry frontier.
    Returns (lo, hi, count, next_row, dead, overflow, cancelled,
    top_cap_used), ``overflow`` False or the reason: "capacity",
    "budget", "wedged" or "fault"."""
    p = eng.p
    st = eng.host_stats
    it_max = _host_it_max(eng.W)
    top_used = caps[0]

    def lvl_for(c):
        return next((i for i, cc in enumerate(caps) if c * TIER_MARGIN <= cc),
                    len(caps) - 1)

    def host_keys(lo, hi, n):
        # The first n key words as numpy u32 (a copy when on the card).
        return (lo[:n].cpu().numpy().view(np.uint32),
                None if hi is None else hi[:n].cpu().numpy().view(np.uint32))

    def save_ckpt(at_r, lo, hi, cnt):
        # Committed row boundary: the resumed run re-runs the same
        # dispatch sequence from here, so its verdict is this run's.
        if ckpt is None or not ckpt.due():
            return
        t0 = time.perf_counter()
        lo_h, hi_h = host_keys(lo, hi, cnt)
        arrays = {"lo": lo_h}
        if hi_h is not None:
            arrays["hi"] = hi_h
        ckpt.save("host", at_r, cnt, arrays,
                  {"key_hi": eng.pair, "b": eng.b, "nil_id": eng.nil_id,
                   "nw": eng.nw, "sticky_lvl": sticky_lvl,
                   "host_stats": util.round_stats(st)})
        ckpt.seconds += time.perf_counter() - t0

    if count > caps[-1]:
        return lo, hi, count, r0, False, "capacity", False, top_used
    sticky_lvl = lvl_for(count)
    if sticky0 is not None:
        sticky_lvl = max(sticky_lvl, min(int(sticky0), len(caps) - 1))
    r = r0
    while r < p.R:
        if cancel is not None and cancel.is_set():
            return lo, hi, count, r, False, False, True, top_used
        natural = lvl_for(count)
        lvl = max(natural, sticky_lvl)
        raised = lvl > natural
        if snapshots is not None:
            snapshots[:] = [(r, lo, hi, count)]
        eng.load_chunk(r, 1)
        st["rows"] += 1
        escalated = filtered = False
        # The reason every device rung of this row failed, else None.
        failed = None
        row_fused = True
        peak_row = count
        while True:
            cap = caps[lvl]
            top_used = max(top_used, cap)
            run_fused = row_fused
            if run_fused and supervise.quarantined(
                    _shape_key(eng, "host-fixpoint", cap)):
                # A quarantined fused shape runs on the per-pass rung.
                supervise.note_skip(st)
                run_fused = False
            if run_fused:
                outcome, val = _guarded(
                    eng, "host-fixpoint",
                    _shape_key(eng, "host-fixpoint", cap),
                    lambda a, cap=cap, lo=lo, hi=hi, count=count:
                    a.host_fixpoint(0, *_resize(lo, hi, cap), count, cap,
                                    it_max), scale=3.0)
                if outcome != "ok":
                    # The row falls to the per-pass rung at this capacity,
                    # from its entry frontier.
                    row_fused = False
                    continue
                l2, h2, conv, ov, it, cnt, pk = val
                st["dispatches"] += 1
                st["passes"] += it
                ovf, budget_out, filtered = not conv, not conv and not ov, \
                    conv
                if conv:
                    peak_row = max(peak_row, pk)
            else:
                if supervise.quarantined(_shape_key(eng, "host-pass", cap)):
                    # Even the per-pass shape is quarantined.
                    supervise.note_skip(st)
                    failed = "wedged"
                    break
                it, ovf, budget_out, filtered, pk = 0, False, False, False, \
                    count
                cur = None
                while True:
                    outcome, val = _guarded(
                        eng, "host-pass", _shape_key(eng, "host-pass", cap),
                        lambda a, cap=cap, cur=cur, lo=lo, hi=hi, count=count:
                        a.host_pass(0, *(cur or (*_resize(lo, hi, cap),
                                                 count)), cap))
                    if outcome != "ok":
                        failed = "fault" if outcome == "fault" else "wedged"
                        break
                    l2, h2, cnt, ch, ov = val
                    cur = (l2, h2, cnt)
                    it += 1
                    st["dispatches"] += 1
                    st["passes"] += 1
                    pk = max(pk, cnt)
                    if ov:
                        ovf = True
                        break
                    # Converging exactly at the budget is convergence.
                    if not ch:
                        break
                    if it >= it_max:
                        ovf = budget_out = True
                        break
                if failed:
                    break
                if not ovf:
                    peak_row = max(peak_row, pk)
            if not ovf:
                break
            st["wasted_passes"] += it
            if lvl + 1 >= len(caps):
                # Hand back the row's entry frontier, with the reason.
                return (lo, hi, count, r, False,
                        "budget" if budget_out else "capacity", False,
                        top_used)
            lvl += 1
            escalated = True
        if failed:
            # Every device rung of this row wedged, faulted or is
            # quarantined. On the card the episode ends there, honestly;
            # on the CPU the CPU oracle runs the row from its entry.
            if not supervise.host_rungs(eng.dev):
                return lo, hi, count, r, False, failed, False, top_used
            if count > supervise.cpu_row_max():
                return lo, hi, count, r, False, "wedged", False, top_used
            from jepsen_tpu_torch.lin import cpu

            try:
                lo_n, hi_n, n2, dead_cpu = _host_row_cpu(
                    p, r, *host_keys(lo, hi, count), count, b=eng.b,
                    nil_id=eng.nil_id, key_hi=eng.pair, nw=eng.nw,
                    crash_dom=eng.crash_dom, cancel=cancel)
            except cpu.Cancelled:
                return lo, hi, count, r, False, False, True, top_used
            st["cpu_rows"] += 1
            r += 1
            lo = torch.from_numpy(lo_n.view(np.int32))
            hi = None if hi_n is None else torch.from_numpy(
                hi_n.view(np.int32))
            if dead_cpu or n2 == 0:
                return lo, hi, 0, r, True, False, False, top_used
            if n2 > caps[-1]:
                # The unbounded CPU closure outgrew the ladder: handing it
                # on would cut live configs at the next row.
                return lo, hi, n2, r, False, "capacity", False, top_used
            count = n2
            save_ckpt(r, lo, hi, count)
            if r - r0 >= min_rows and count <= dropback:
                break
            continue
        if raised:
            st["sticky_misses" if escalated else "sticky_hits"] += 1
        if lvl > sticky_lvl:
            sticky_lvl = lvl
        elif lvl_for(peak_row) < sticky_lvl:
            sticky_lvl -= 1
        if filtered:
            lo, hi, count = l2, h2, cnt
        else:
            lo, hi, count = eng.host_filter(0, *cur[:2], cur[2], cap)
        r += 1
        if count == 0:
            return lo, hi, 0, r, True, False, False, top_used
        save_ckpt(r, lo, hi, count)
        if r - r0 >= min_rows and count <= dropback:
            break
    return lo, hi, count, r, False, False, False, top_used


def _resume_source(p: PackedHistory, eng, checkpoint, resume):
    """The checkpoint wiring of :func:`check_packed`: (Checkpointer or
    None, the loaded checkpoint or None)."""
    ckpt = None
    if checkpoint is not None and not isinstance(checkpoint, (str, bool)):
        ckpt = checkpoint                       # a prebuilt Checkpointer
        ckpt_file = ckpt.path
    else:
        ckpt_file = checkpoint if isinstance(checkpoint, str) \
            else supervise.ckpt_path()
        if ckpt_file:
            ckpt = supervise.Checkpointer(ckpt_file,
                                          supervise.history_fingerprint(p))
    rd = None
    if resume is not False:
        rpath = resume if isinstance(resume, str) else ckpt_file
        if rpath and os.path.exists(rpath):
            fp = ckpt.fingerprint if ckpt is not None \
                else supervise.history_fingerprint(p)
            rd = supervise.load_checkpoint(rpath, fp)
    return ckpt, rd


def check_packed(p: PackedHistory, cap_schedule=None, chunk: int = CHUNK,
                 cancel=None, explain: bool = False,
                 spike_caps=SPIKE_CAP_SCHEDULE, host_caps=HOST_ROW_CAPS,
                 packed_keys: bool | None = None, device=None,
                 checkpoint=None, resume=None, frontier=None,
                 frontier_row: int = 0, partial: bool = False) -> dict:
    """Decide linearizability of a packed history with the sparse engine.

    Chunks of ``chunk`` rows; capacity adapts per chunk: an overflow
    re-runs the chunk from its entry frontier at the next cap level of
    ``cap_schedule``, the frontier past the last level goes to spike
    mode at ``spike_caps`` (the multiword band: those within its memory
    budget, :func:`_mw_spike_caps`), and a clean chunk whose frontier
    shrank drops back a level. The default schedule is
    :data:`DEFAULT_CAP_SCHEDULE`, and for the compact band
    :data:`PACKED_CAP_SCHEDULE` (its top level alone on the card); in the
    crash-dom bands it is one level of TIER_MARGIN x
    :data:`CHUNK_TIER_CAP`, and a row past the in-chunk tiers goes to the
    host-row executor (:func:`_host_rows`) at ``host_caps`` instead of
    spike mode; the result then carries its ``host-stats``.
    ``packed_keys=False`` forces the multiword band (:func:`key_band`).
    ``cancel`` (threading.Event) stops between chunks. ``explain=True``
    keeps the chunk-entry frontier and, on an invalid verdict, replays
    the failing tail on the CPU oracle for configs and final paths
    (:mod:`jepsen_tpu_torch.lin.witness`). ``device`` is where the search
    runs (see :func:`jepsen_tpu_torch.resolve_device`).

    The search is supervised (:mod:`jepsen_tpu_torch.lin.supervise`):
    each chunk is one dispatch at site ``chunk``, whose wedge or fault is
    an honest ``overflow: wedge`` / ``fault`` unknown, and so is one that
    ends the host-row ladder; the trips, faults, quarantine skips and
    CPU-oracle rows are in ``host-stats``.
    ``checkpoint`` (a path, a prebuilt Checkpointer, or the
    ``JEPSEN_TPU_CKPT`` env) saves the frontier at committed row
    boundaries: after a clean chunk (kind ``chunk``, the multiword
    layout) and after each host row (kind ``host``, packed keys with the
    sticky level and host stats). ``resume`` (a path, by default the
    checkpoint file when it exists; ``False`` disables) continues from
    one, in the multiword layout of either package; the result then
    carries ``resumed-from-row``. A definite verdict deletes the
    checkpoint; an unknown, a cancel or a wedge keeps it.

    The incremental entry: ``frontier`` — a carried committed frontier
    ``(bits u32[n, nw], state i32[n, S], count)`` in the multiword layout
    — re-enters the row loop at ``frontier_row`` as a resume does (and
    takes precedence over one); with ``partial=True`` a clean walk to the
    end returns the committed frontier as ``stream-frontier`` (numpy
    ``bits``, ``state``, ``count``, ``row``) beside the verdict, so that
    the caller can extend the history and re-enter. A carried frontier
    reads no checkpoint (``resume`` is ignored); ``checkpoint`` still
    saves.

    Returns the reference's result shape: ``valid?``, ``dead-row``,
    ``op``, ``final-frontier-size``, ``max-cap``, ``overflow`` (with an
    unknown: ``capacity``, ``budget``, ``wedge`` or ``fault``), and
    ``band``, the band the search ran in (``compact``, ``crash-dom``,
    their ``pair-`` forms, ``generic`` or ``multiword``)."""
    device = resolve_device(device)
    err = band_error(p)
    if err is not None:
        return {"valid?": "unknown", "analyzer": ANALYZER, "error": err}
    if p.R == 0:
        out = {"valid?": True, "analyzer": ANALYZER, "configs": []}
        if partial:
            out["stream-frontier"] = {
                "bits": np.zeros((1, (p.window + 31) // 32), np.uint32),
                "state": np.asarray(p.init_state, np.int32)[None, :],
                "count": 1, "row": 0}
        return out
    eng = {"compact": _Engine, "generic": _GenericEngine,
           "multiword": _MWEngine}[key_band(p, packed_keys)](p, device)
    if cap_schedule is None or cap_schedule is DEFAULT_CAP_SCHEDULE:
        cap_schedule = eng.cap_schedule(device)
    if eng.max_tier is not None and tuple(cap_schedule) in (
            PACKED_CAP_SCHEDULE, PACKED_CAP_SCHEDULE[-1:]):
        # Counts never pass the tier cap in-chunk, so the chunk cap needs
        # only the selection margin over it.
        cap_schedule = (TIER_MARGIN * eng.max_tier,)
    backend = "cuda" if device.type == "cuda" else "plain"
    hs = eng.host_stats
    # The host-row executor's dropback: the hand-back must fit the top
    # chunk cap as well as the tiers (the resume keeps only cap keys).
    hdrop = min(SPIKE_DROPBACK, (eng.max_tier or cap_schedule[-1])
                // TIER_MARGIN, cap_schedule[-1])

    level = 0
    cap = cap_schedule[level]
    lo, hi = eng.init_keys(cap)
    count = 1
    max_cap_used = cap
    snapshots: list | None = [] if explain else None

    def place(fb, fs, fc):
        # A multiword-layout frontier at the first level that holds it.
        nonlocal level, cap, max_cap_used
        level = next(i for i, c in enumerate(cap_schedule) if fc <= c)
        cap = cap_schedule[level]
        max_cap_used = max(max_cap_used, cap)
        return eng.from_frontier(fb, fs, fc, cap)

    # A carried frontier takes precedence: no checkpoint is read for it.
    ckpt, rd = _resume_source(p, eng, checkpoint,
                              False if frontier is not None else resume)
    resume_host = None
    resumed_from = None
    start_row = 0
    if rd is not None:
        rcount = rd["count"]
        if rd["kind"] == "host":
            m = rd["meta"]
            if eng.crash_dom and (m.get("b"), m.get("key_hi"),
                                  m.get("nw")) == (eng.b, eng.pair, eng.nw):
                rbits, rstate = supervise.np_unpack_keys(
                    rd["lo"], rd.get("hi"), rcount, eng.b, eng.nil_id,
                    eng.nw, eng.pair, int(NIL))
                resume_host = (rbits, rstate, rcount, m.get("sticky_lvl"))
                start_row = resumed_from = rd["row"]
                for k, v in (m.get("host_stats") or {}).items():
                    if k in hs and not isinstance(v, (dict, list)):
                        hs[k] = v
        elif rcount <= cap_schedule[-1]:
            lo, hi = place(rd["bits"], rd["state"], rcount)
            count = rcount
            start_row = resumed_from = rd["row"]

    if frontier is not None:
        fb = np.asarray(frontier[0], dtype=np.uint32)
        fs = np.asarray(frontier[1], dtype=np.int32)
        fc = int(frontier[2])
        if fb.ndim == 1:
            fb = fb[:, None]
        if fs.ndim == 1:
            fs = fs[:, None]
        S = np.asarray(p.init_state).shape[0]
        if fs.shape[1] != S:
            return {"valid?": "unknown", "analyzer": ANALYZER,
                    "error": f"carried frontier state width {fs.shape[1]} "
                             f"!= kernel width {S}"}
        if fc <= 0:
            # An empty committed frontier follows only a death row, which
            # would have ended the stream already.
            return {"valid?": "unknown", "analyzer": ANALYZER,
                    "error": "carried stream frontier is empty"}
        if fb.shape[1] < eng.nw:
            # The window crossed a 32-slot word boundary between
            # increments; the high words are zero.
            fb = np.pad(fb, ((0, 0), (0, eng.nw - fb.shape[1])))
        resume_host = resumed_from = None
        start_row = int(frontier_row)
        if fc <= cap_schedule[-1]:
            lo, hi = place(fb, fs, fc)
            count = fc
        elif eng.crash_dom:
            # Past the chunked top cap: the host-row executor re-enters
            # directly (the host-kind resume path).
            resume_host = (fb, fs, fc, None)
        else:
            return {"valid?": "unknown", "analyzer": ANALYZER,
                    "overflow": "capacity",
                    "error": f"carried stream frontier {fc} exceeds chunk "
                             f"capacity {cap_schedule[-1]}"}

    def with_stats(out: dict) -> dict:
        out["band"] = eng.band
        if hs["episodes"] or any(hs.get(k) for k in (
                "watchdog_trips", "faults", "quarantine_skips", "cpu_rows")):
            out["host-stats"] = util.round_stats(hs)
        if resumed_from is not None:
            out["resumed-from-row"] = resumed_from
        if ckpt is not None and not partial \
                and out.get("valid?") in (True, False):
            # A finished search must not be resumed by a later run.
            ckpt.clear()
        return out

    def unknown(**kw) -> dict:
        return with_stats({"valid?": "unknown", "analyzer": ANALYZER,
                           "backend": backend, **kw})

    def final_valid(lo, hi, count: int) -> dict:
        out = {"valid?": True, "analyzer": ANALYZER, "backend": backend,
               "configs": [], "final-frontier-size": int(count),
               "max-cap": max_cap_used, "engine-stats": eng.stats}
        if partial:
            bits, state = eng.to_frontier(lo, hi, int(count))
            out["stream-frontier"] = {"bits": bits, "state": state,
                                      "count": int(count), "row": int(p.R)}
        return with_stats(out)

    def dead_verdict(dead_row: int) -> dict:
        ret = p.ops[int(p.ret_op[dead_row])]
        out = {"valid?": False, "analyzer": ANALYZER, "backend": backend,
               "dead-row": dead_row,
               "op": {"process": ret.process, "f": ret.f,
                      "value": ret.value, "index": ret.op_index,
                      "ok": ret.ok},
               "configs": [], "final-paths": []}
        if snapshots and not (cancel is not None and cancel.is_set()):
            from jepsen_tpu_torch.lin import witness

            out.update(witness.tail_replay_sparse(
                p, _materialize(snapshots, eng), dead_row, cancel=cancel))
        return with_stats(out)

    def consume(spiked, spike_top):
        """Fold a host-row or spike run back into the chunk loop: ("return",
        verdict), ("dead", next_row) or ("continue", None)."""
        nonlocal lo, hi, count, base, level, cap, max_cap_used
        (s_lo, s_hi, s_count, next_r, dead_h, ovf_h, cancelled,
         top_used) = spiked
        max_cap_used = max(max_cap_used, top_used)
        if cancelled:
            return "return", unknown(error="cancelled")
        if ovf_h == "budget":
            return "return", unknown(
                overflow="budget",
                error=f"closure pass budget exceeded at capacity "
                      f"{spike_top}")
        if ovf_h in ("wedged", "fault"):
            return "return", unknown(
                overflow="wedge" if ovf_h == "wedged" else "fault",
                error=f"wedged/faulted dispatch survived the fallback "
                      f"ladder near row {next_r}")
        if ovf_h:
            return "return", unknown(
                overflow="capacity",
                error=f"frontier exceeded capacity {spike_top}")
        if dead_h:
            return "dead", next_r
        if next_r >= p.R:
            return "return", final_valid(s_lo, s_hi, s_count)
        # Resume full-size chunks at the top chunk level; the shrink
        # below drops back once chunks run clean.
        level = len(cap_schedule) - 1
        cap = cap_schedule[level]
        (lo, hi), count = eng.resize(s_lo, s_hi, cap), s_count
        base = next_r
        return "continue", None

    def save_chunk(at_r: int) -> None:
        if ckpt is None or not ckpt.due():
            return
        t0 = time.perf_counter()
        bits, state = eng.to_frontier(lo, hi, max(count, 1))
        ckpt.save("chunk", at_r, count, {"bits": bits, "state": state}, {})
        ckpt.seconds += time.perf_counter() - t0

    base = start_row
    while base < p.R:
        if resume_host is not None:
            # A host-kind checkpoint or a carried frontier past the top
            # chunk cap: the host-row executor continues from it.
            rbits, rstate, rcount, rsticky = resume_host
            resume_host = None
            hs["episodes"] += 1
            r_lo, r_hi = eng.from_frontier(rbits, rstate, rcount,
                                           max(rcount, 1))
            act, payload = consume(_host_rows(
                eng, base, r_lo, r_hi, rcount, caps=host_caps,
                dropback=hdrop, cancel=cancel, snapshots=snapshots,
                ckpt=ckpt, sticky0=rsticky), host_caps[-1])
            if act == "return":
                return payload
            if act == "dead":
                return dead_verdict(payload - 1)
            continue
        if snapshots is not None:
            # Only the last snapshot is ever replayed: the dead row is
            # always inside the current chunk.
            snapshots[:] = [(base, lo, hi, count)]
        if cancel is not None and cancel.is_set():
            return unknown(error="cancelled")
        n = min(chunk, p.R - base)
        spiked = None
        eng.load_chunk(base, chunk)
        while True:
            outcome, out = _guarded(
                eng, "chunk", _shape_key(eng, "chunk", cap_schedule[level],
                                         chunk),
                lambda a, base=base, n=n, lo=lo, hi=hi, count=count:
                a.chunk(base, n, chunk, lo, hi, count))
            if outcome == "wedge":
                return unknown(overflow="wedge", error=str(out))
            if outcome == "fault":
                return unknown(overflow="fault",
                               error=f"dispatch fault near row {base}: "
                                     f"{out!r}")
            if not out.ovf:
                break
            # With capped tiers a larger chunk cap whose tiers stop at the
            # same top cannot help: past the chunked engine at once.
            no_grow = eng.max_tier is not None \
                and level + 1 < len(cap_schedule) \
                and min(cap_schedule[level + 1], eng.max_tier) \
                == min(cap_schedule[level], eng.max_tier)
            if level + 1 >= len(cap_schedule) or no_grow:
                # The overflowing row starts spike mode or the host-row
                # executor, from the frontier the rows before it left.
                n_pre = out.rows_done - 1
                if eng.crash_dom:
                    hs["episodes"] += 1
                    spiked = _host_rows(
                        eng, base + n_pre, out.pre_lo, out.pre_hi,
                        out.pre_count, caps=host_caps, dropback=hdrop,
                        cancel=cancel, snapshots=snapshots, ckpt=ckpt)
                    spike_top = host_caps[-1]
                    break
                # Spike caps strictly exceed the chunked top cap: a
                # smaller one would drop live configs.
                sp_caps = eng.spike_levels(cap_schedule[-1], spike_caps)
                if sp_caps is None:
                    return unknown(overflow="capacity",
                                   error=("frontier exceeded capacity "
                                          f"{cap_schedule[-1]}"))
                spiked = _spike_rows(
                    eng, base + n_pre, out.pre_lo, out.pre_hi,
                    out.pre_count, caps=sp_caps,
                    dropback=min(SPIKE_DROPBACK, cap_schedule[-1]),
                    cancel=cancel, snapshots=snapshots)
                spike_top = sp_caps[-1]
                break
            # Retry this chunk from its entry frontier at the next cap.
            level += 1
            cap = cap_schedule[level]
            max_cap_used = max(max_cap_used, cap)
            lo, hi = eng.resize(lo, hi, cap)
        if spiked is not None:
            act, payload = consume(spiked, spike_top)
            if act == "return":
                return payload
            if act == "dead":
                return dead_verdict(payload - 1)
            continue
        if out.dead:
            return dead_verdict(base + out.rows_done - 1)
        lo, hi, count = out.lo, out.hi, out.count
        base += n
        save_chunk(base)
        # The frontier is compacted to the front, so a shrunken frontier
        # drops back to a smaller level by slicing.
        while level > 0 and count * 4 <= cap_schedule[level - 1]:
            level -= 1
            cap = cap_schedule[level]
            lo, hi = eng.resize(lo, hi, cap)

    return final_valid(lo, hi, count)


def _materialize(snapshots, eng):
    """Snapshots as the ``(base, bits[cap, nw], state[cap, S], count)``
    numpy tuples the witness replay takes (either engine's frontier,
    decoded by its ``unpack``)."""
    out = []
    for base, lo, hi, count in snapshots:
        bits, state = eng.unpack(lo, hi, count)
        out.append((base, bits.cpu().numpy(), state.cpu().numpy(), count))
    return out


def _mw_spike_caps(W: int, nw: int, S: int, chunk_top: int, spike_caps):
    """The multiword band's spike ladder: the levels of ``spike_caps``
    above the chunked top cap whose closure passes fit
    :data:`_MW_SPIKE_BUDGET_BYTES` (wide windows and fat states get
    shorter ladders), as :func:`jepsen_tpu.lin.bfs._mw_spike_caps`; None
    when none do."""
    per_cand = 4 * 3 * (W + 1) * (1 + nw + S)
    max_cap = _MW_SPIKE_BUDGET_BYTES // max(per_cand, 1)
    caps = tuple(sorted(c for c in spike_caps if chunk_top < c <= max_cap))
    return caps or None


class _MWEngine:
    """The multiword band for one history: the key-axis search
    (:func:`_search_chunk`) with K = 1, one row a call, behind the same
    chunk interface as :class:`_Engine`, so that the chunk, escalation and
    spike loops are shared. A frontier is ``lo`` = bits int64[1, cap, NW]
    (u32 words) and ``hi`` = state int64[1, cap, S], zero past the
    count."""

    band = "multiword"
    crash_dom = False
    max_tier = None

    def __init__(self, p: PackedHistory, device):
        self.p = p
        self.dev = device
        self.W = p.window
        self.nw = (p.window + 31) // 32
        self.S = p.state_width
        self.step_fn = p.kernel.step
        self.pure_h, self.pred_bit_h = reduction_bit_tables(p, self.nw)
        self._chunk_key = None
        # Rows run (one search call each), closure passes, and blocking
        # device-to-host fetches (one a pass, three a row).
        self.stats = {"rows": 0, "passes": 0, "fetches": 0}
        self.host_stats = {"episodes": 0}

    attempt = _Engine.attempt
    harvest = _Engine.harvest

    def from_frontier(self, bits, state, count: int, cap: int):
        """A multiword-layout frontier (numpy, see
        :meth:`_Engine.from_frontier`) as (bits, state) tensors of ``cap``
        configs."""
        n = int(count)
        fb = np.zeros((1, cap, self.nw), np.int64)
        src = np.asarray(bits)[:n, :self.nw]
        fb[0, :n, :src.shape[1]] = src
        fs = np.zeros((1, cap, self.S), np.int64)
        fs[0, :n] = np.asarray(state)[:n]
        return (torch.from_numpy(fb).to(self.dev),
                torch.from_numpy(fs).to(self.dev))

    def to_frontier(self, lo, hi, n: int):
        return (lo[0, :n].cpu().numpy().astype(np.uint32),
                hi[0, :n].cpu().numpy().astype(np.int32))

    def cap_schedule(self, device) -> tuple:
        return DEFAULT_CAP_SCHEDULE

    def init_keys(self, cap: int):
        bits = torch.zeros((1, cap, self.nw), dtype=torch.int64,
                           device=self.dev)
        state = torch.zeros((1, cap, self.S), dtype=torch.int64,
                            device=self.dev)
        state[0, 0] = torch.as_tensor(np.asarray(self.p.init_state,
                                                 np.int64), device=self.dev)
        return bits, state

    def unpack(self, lo, hi, count: int):
        return lo[0], hi[0]

    @staticmethod
    def resize(lo, hi, cap: int):
        """The frontier cut or zero-padded to ``cap`` configs."""
        def fit(t):
            if t.shape[1] >= cap:
                return t[:, :cap]
            pad = torch.zeros((1, cap - t.shape[1], t.shape[2]),
                              dtype=t.dtype, device=t.device)
            return torch.cat([t, pad], 1)

        return fit(lo), fit(hi)

    def spike_levels(self, top: int, spike_caps):
        return _mw_spike_caps(self.W, self.nw, self.S, top, spike_caps)

    def load_chunk(self, base: int, rows: int) -> None:
        """Device tables for rows [base, base + rows), key axis 1."""
        if self._chunk_key == (base, rows):
            return
        p, dev = self.p, self.dev

        def put(a, dtype=torch.int64):
            a = _chunk_slice(np.asarray(a), base, rows)[None]
            if a.dtype == np.uint32:
                return _u32.widen(torch.from_numpy(
                    np.ascontiguousarray(a).view(np.int32)).to(dev))
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.tables = (put(p.ret_slot), put(p.active, torch.bool),
                       put(p.slot_f), put(p.slot_v), put(self.pure_h,
                                                         torch.bool),
                       put(self.pred_bit_h))
        self._chunk_key = (base, rows)

    def chunk(self, base: int, n_rows: int, rows: int, lo, hi,
              count: int) -> ChunkOut:
        """Up to ``n_rows`` return events from row ``base`` (tables of
        ``rows`` rows) at the frontier's capacity, stopping at a death or
        an overflow (the reference's closure ceiling 4 W + 16 passes
        included)."""
        self.load_chunk(base, rows)
        cap = lo.shape[1]
        pre = (lo, hi, count)
        for r in range(n_rows):
            supervise.check_stop()
            pre = (lo, hi, count)
            row = tuple(t[:, r:r + 1] for t in self.tables)
            b2, s2, c2, _, dead, ovf = _search_chunk(
                1, *row, lo, hi,
                torch.tensor([count], dtype=torch.int64, device=self.dev),
                cap=cap, step_fn=self.step_fn, stats=self.stats)
            c2, dead, ovf = torch.stack(
                (c2[0], dead[0].long(), ovf[0].long())).tolist()
            self.stats["rows"] += 1
            self.stats["fetches"] += 1
            if ovf:
                return ChunkOut(lo, hi, count, r + 1, False, True, *pre)
            lo, hi, count = b2, s2, c2
            if dead:
                return ChunkOut(lo, hi, 0, r + 1, True, False, *pre)
        return ChunkOut(lo, hi, count, n_rows, False, False, *pre)

    # Spike mini-chunks run the same rows: the band has no row tiers.
    spike_chunk = chunk


# --- the multiword engine, with a leading key axis ---------------------------
#
# The reference's general formulation (jepsen_tpu/lin/bfs.py:783-828): a
# config is a bitset of NW u32 words and a state vector of S ints, kept
# as int64 tensors (bits wide, :mod:`jepsen_tpu_torch._u32`; state
# signed), with a leading key axis K. The batch of independent keys
# (:mod:`jepsen_tpu_torch.lin.batched`) runs it for every key of a
# group at once, where the reference vmaps it; K = 1 is the solo case.
# Per lane it is the vmapped lax.while_loop: a lane whose loop condition
# is false keeps its frontier, rows done, dead and overflow flags while
# the others go on. The loops are driven from the host, with one
# blocking fetch per row and one per closure pass for the whole batch.


def _slot_bits(W: int, nw: int, device=None) -> torch.Tensor:
    """int64[W, NW] (u32 words): row j has bit j % 32 set in word j // 32."""
    tbl = torch.zeros((W, nw), dtype=torch.int64, device=device)
    j = torch.arange(W, device=device)
    tbl[j, j // 32] = torch.ones_like(j) << (j % 32)
    return tbl


def _dedup(bits, state, valid, cap: int):
    """Sort-dedup-compact of multiword configs, per key: ``bits``
    int64[K, n, NW] (u32 words), ``state`` int64[K, n, S], ``valid``
    bool[K, n]. Returns (bits[K, cap, NW], state[K, cap, S], count[K],
    overflow[K]): the distinct valid configs of each key in the
    reference's order, lexicographic on (invalid flag, the bit words as
    unsigned, the state words as signed), zero past the count; overflow
    where more than ``cap`` survive (the first ``cap`` are kept), as
    :func:`jepsen_tpu.lin.bfs._dedup`.

    The 32-bit columns, state words shifted into unsigned order, pair up
    into int64 sort keys (``hi - 2**31``, ``lo``), whose signed order is
    the pair's unsigned order; a chain of stable sorts runs from the least
    significant key, and a stable partition puts the valid rows first (the
    flag is the most significant column)."""
    K, n, nw = bits.shape
    S = state.shape[2]
    dev = bits.device
    cols = [bits[..., i] for i in range(nw)] \
        + [state[..., i] + (1 << 31) for i in range(S)]
    if len(cols) % 2:
        cols.insert(0, torch.zeros_like(cols[0]))
    keys = [(cols[i] - (1 << 31)) * (1 << 32) + cols[i + 1]
            for i in range(0, len(cols), 2)]
    perm = torch.arange(n, device=dev).expand(K, n)
    for key in reversed(keys):
        order = torch.sort(key.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    v = valid.gather(1, perm)
    n_valid = v.sum(1, keepdim=True)
    dest = torch.where(v, torch.cumsum(v, 1) - 1,
                       n_valid + torch.cumsum(~v, 1) - 1)
    perm = torch.empty_like(perm).scatter_(1, dest, perm)
    bits_s = bits.gather(1, perm.unsqueeze(-1).expand(K, n, nw))
    state_s = state.gather(1, perm.unsqueeze(-1).expand(K, n, S))
    differs = (bits_s[:, 1:] != bits_s[:, :-1]).any(-1) \
        | (state_s[:, 1:] != state_s[:, :-1]).any(-1)
    first = torch.ones((K, 1), dtype=torch.bool, device=dev)
    mask = (torch.arange(n, device=dev) < n_valid) \
        & torch.cat([first, differs], dim=1)
    total = mask.sum(1)
    # Survivors to their rank, in order; the rest to a dropped slot cap.
    pos = torch.where(mask, torch.cumsum(mask, 1) - 1, cap).clamp(max=cap)
    out_bits = torch.zeros((K, cap + 1, nw), dtype=torch.int64, device=dev)
    out_state = torch.zeros((K, cap + 1, S), dtype=torch.int64, device=dev)
    out_bits.scatter_(1, pos.unsqueeze(-1).expand(K, n, nw), bits_s)
    out_state.scatter_(1, pos.unsqueeze(-1).expand(K, n, S), state_s)
    return (out_bits[:, :cap], out_state[:, :cap],
            total.clamp(max=cap), total > cap)


def _closure_pass_mw(bits_in, state_in, count, act, f_row, v_row,
                     pure_row, pred_row, *, cap: int, W: int, nw: int,
                     step_fn, slot_bit, rows: int):
    """ONE closure pass over each key's multiword configs (``bits_in``
    [K, cap, NW], ``state_in`` [K, cap, S], ``count`` [K]) on that key's
    row (``act``/``f_row``/``pure_row`` [K, W], ``v_row`` [K, W, VW],
    ``pred_row`` [K, W, NW]): carried configs absorb their legal pure
    slots in place, non-pure legal slots expand under the canonical-chain
    gate, and the candidates (carried and expanded) sort-dedup.
    Returns (bits, state, count, changed, overflow), each per key, as
    :func:`jepsen_tpu.lin.bfs._closure_pass_mw`. ``slot_bit`` is
    :func:`_slot_bits` (W, nw); ``rows`` (at least every key's count)
    expands only that prefix of the frontier: the configs past the count
    are invalid, so the result is that of the whole arrays."""
    K = bits_in.shape[0]
    S = state_in.shape[2]
    dev = bits_in.device
    bits, state = bits_in[:, :rows], state_in[:, :rows]
    cfg_valid = torch.arange(rows, device=dev) < count[:, None]
    ok, new_state = step_fn(state[:, :, None, :], f_row[:, None, :],
                            v_row[:, None])
    already = ((bits[:, :, None, :] & slot_bit) != 0).any(-1)
    fresh = ok & act[:, None, :] & ~already & cfg_valid[..., None]
    # Saturation: distinct slot bits, so their sum is their OR.
    sat = ((fresh & pure_row[:, None, :]).to(torch.int64).unsqueeze(-1)
           * slot_bit).sum(2)
    bits = torch.where(cfg_valid[..., None], bits | sat, bits)
    pred = pred_row[:, None]
    chain_ok = ((bits[:, :, None, :] & pred) == pred).all(-1)
    legal = fresh & ~pure_row[:, None, :] & chain_ok
    new_bits = bits[:, :, None, :] | slot_bit
    cand_bits = torch.cat([bits, new_bits.reshape(K, rows * W, nw)], 1)
    cand_state = torch.cat(
        [state, new_state.to(torch.int64).reshape(K, rows * W, S)], 1)
    cand_valid = torch.cat([cfg_valid, legal.reshape(K, rows * W)], 1)
    b2, s2, n2, o2 = _dedup(cand_bits, cand_state, cand_valid, cap)
    # Fixpoint test against the pass input (see the reference).
    changed = (b2 != bits_in).flatten(1).any(1) \
        | (s2 != state_in).flatten(1).any(1) | (n2 != count)
    return b2, s2, n2, changed, o2


def _filter_pass_mw(bits, state, count, s, *, cap: int, W: int,
                    slot_bit, rows: int):
    """Return-event filter of each key's configs for its returning slot
    ``s`` [K]: keep the configs holding the slot's bit, then clear it.
    Returns (bits, state, count, dead), each per key. ``slot_bit`` and
    ``rows`` as in :func:`_closure_pass_mw`."""
    dev = bits.device
    bits, state = bits[:, :rows], state[:, :rows]
    s_mask = slot_bit[s.clamp(0, W - 1)][:, None, :]      # [K, 1, NW]
    cfg_valid = torch.arange(rows, device=dev) < count[:, None]
    keep = cfg_valid & ((bits & s_mask) != 0).any(-1)
    bits, state, count, _ = _dedup(bits & ~s_mask, state, keep, cap)
    return bits, state, count, count == 0


def _search_chunk(n_rows, ret_slot, active, slot_f, slot_v, pure, pred_bit,
                  bits, state, count, *, cap: int, step_fn,
                  stats: dict | None = None):
    """The multiword branch of :func:`jepsen_tpu.lin.bfs._search_chunk`
    for K keys at once: key k processes up to ``n_rows[k]`` return events
    of its tables (``ret_slot`` [K, C], ``active``/``slot_f``/``pure``
    [K, C, W], ``slot_v`` [K, C, W, VW], ``pred_bit`` [K, C, W, NW]) from
    its carried frontier (``bits`` int64[K, cap, NW] u32 words, ``state``
    int64[K, cap, S], ``count`` [K]), all int64 or bool tensors on one
    device. Each closure keeps the reference's ceiling ``4 W + 16``
    passes; reaching it with changes pending sets the key's overflow.
    Returns (bits, state, count, rows_done, dead, overflow), each per
    key; rows_done counts the dead or overflowing row itself. ``stats``
    (a dict with ``passes`` and ``fetches``), when given, counts the
    closure passes and the blocking fetches.

    Each pass expands only the prefix of the frontier arrays that holds
    every key's live configs (a power of two from 16 up to ``cap``, from
    the largest count, which rides the pass's one fetch); the rest are
    invalid configs, so the results are those of the whole arrays."""
    K, C, W = active.shape
    nw = bits.shape[2]
    dev = bits.device
    it_max = 4 * W + 16
    slot_bit = _slot_bits(W, nw, dev)
    lane = torch.arange(K, device=dev)
    zeros = torch.zeros(K, dtype=torch.int64, device=dev)
    r, dead, ovf = zeros, zeros.bool(), zeros.bool()
    n_rows = torch.as_tensor(n_rows, dtype=torch.int64, device=dev) \
        .expand(K)

    def keep(mask, new, old):
        return torch.where(mask.view((K,) + (1,) * (old.dim() - 1)), new,
                           old)

    def prefix(n: int) -> int:
        return min(cap, 1 << max(4, (n - 1).bit_length()))

    st = {"passes": 0, "fetches": 0} if stats is None else stats
    while True:
        run = (r < n_rows) & ~dead & ~ovf
        any_run, most = torch.stack(
            [run.any().long(), count.max()]).tolist()   # one fetch a row
        st["fetches"] += 1
        if not any_run:
            break
        rr = r.clamp(max=C - 1)
        row = (active[lane, rr], slot_f[lane, rr], slot_v[lane, rr],
               pure[lane, rr], pred_bit[lane, rr])
        c_bits, c_state, c_count, c_ovf = bits, state, count, ovf
        it = zeros
        go = run
        while True:                             # do-while to fixpoint
            supervise.check_stop()
            b2, s2, n2, changed, o2 = _closure_pass_mw(
                c_bits, c_state, c_count, *row, cap=cap, W=W, nw=nw,
                step_fn=step_fn, slot_bit=slot_bit, rows=prefix(most))
            o2 = c_ovf | o2 | ((it + 1 >= it_max) & changed)
            c_bits = keep(go, b2, c_bits)
            c_state = keep(go, s2, c_state)
            c_count = keep(go, n2, c_count)
            c_ovf = keep(go, o2, c_ovf)
            it = keep(go, it + 1, it)
            go = go & changed & ~c_ovf & (it < it_max)
            any_go, most = torch.stack(
                [go.any().long(), c_count.max()]).tolist()  # one a pass
            st["passes"] += 1
            st["fetches"] += 1
            if not any_go:
                break
        fb, fs, fc, fd = _filter_pass_mw(c_bits, c_state, c_count,
                                         ret_slot[lane, rr], cap=cap, W=W,
                                         slot_bit=slot_bit,
                                         rows=prefix(most))
        bits = keep(run, fb, bits)
        state = keep(run, fs, state)
        count = keep(run, fc, count)
        dead = keep(run, fd, dead)
        ovf = keep(run, c_ovf, ovf)
        r = keep(run, r + 1, r)
    return bits, state, count, r, dead, ovf
