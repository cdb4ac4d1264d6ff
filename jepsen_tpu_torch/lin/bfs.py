"""The sparse frontier engine for wide windows, single-key register band.

The port of the part of :mod:`jepsen_tpu.lin.bfs` that decides
crash-free, read-value-match register histories (cas-register,
register) whose window plus state bits fit one u32 key: windows 21-28
with a few interned values, the cockroach-class concurrency the dense
bitmap engine (windows <= 20) cannot hold.

A config (linearized-slot bitset B, model state s) is ONE u32 key
``B << b | s`` (state id NIL remapped to ``nil_id``); the frontier is an
ascending, deduplicated array of keys padded with ``KEY_FILL``, carried
on the device as raw int32 (:mod:`jepsen_tpu_torch._u32`). Per return
event (row):

1. the just-in-time closure to fixpoint: saturate each config with the
   legal pure reads, expand it by the row's mutator columns
   (:func:`expansion_tables`: chain and JIT gates), sort-dedup; one
   launch of :func:`jepsen_tpu_torch.lin.psort_fused.fixpoint` where
   :func:`jepsen_tpu_torch.lin.psort_fused.fits` holds, else a host-
   driven chain of :func:`_closure_pass_keys_compact` passes, each one
   :func:`jepsen_tpu_torch.lin.psort.dedup_keys`, grouped by G column
   groups as in the reference;
2. the return filter: configs must hold the returner's bit, which is
   then dropped; :func:`jepsen_tpu_torch.lin.psort.compact_keys` packs
   the survivors when any config was dropped.

Rows run on a count-tiered prefix of the frontier (:data:`ROW_TIERS`),
with a retry at the top tier on overflow; chunks of :data:`CHUNK` rows
escalate through the cap schedule from their entry frontier, and a
frontier past the last chunk cap hands off to spike mode
(:func:`_spike_rows`). The row loop is driven from the host: one
blocking fetch per row (count, converged, overflow, survivors of the
filter) picks the next row's tier, where the reference switches tiers on
the device.

Left out, each an honest ``unknown`` naming it (:func:`band_error`):
pair keys (windows past 31 - b bits), the crash-dom band (any crashed
slot) with its host-row executor, the generic packed band (mutex), the
multiword formulation, supervision, checkpoint/resume and the
incremental entry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jepsen_tpu_torch import _u32, resolve_device
from jepsen_tpu_torch.lin import psort, psort_fused
from jepsen_tpu_torch.lin.prepare import PackedHistory, reduction_tables
from jepsen_tpu_torch.models.kernels import (F_CAS, F_WRITE, NIL,
                                             PACKED_STATE_KERNELS,
                                             READ_VALUE_MATCH_KERNELS,
                                             packed_state_bound)

# The reference's values, kept until a measurement on the H100 sets them.
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

KEY_FILL = psort.KEY_FILL
ANALYZER = "gpu-bfs"


def _dedup_keys(key, valid, cap):
    """Single-u32-key sort-dedup (invalid flag in bit 31), survivors
    ascending with KEY_FILL padding. Within
    :func:`jepsen_tpu_torch.lin.psort.available` it is
    :func:`jepsen_tpu_torch.lin.psort.dedup_keys` (the kernel on the
    card); above it :func:`_dedup_keys_sort`, as the reference takes
    lax.sort there. Returns (keys[cap], count, overflow) as tensors."""
    if psort.available(key.numel()):
        return psort.dedup_keys(key, valid, cap)
    return _dedup_keys_sort(key, valid, cap)


def _dedup_keys_sort(key, valid, cap):
    """The reference's lax.sort dedup in torch.sort, for candidate spaces
    past the kernels' size gate (spike caps 524288 and 1048576): sort the
    flag-folded keys, turn the invalid and repeated ones into KEY_FILL,
    and sort again to pack the survivors."""
    n = key.numel()
    w = _u32.widen(key) | ((~valid).to(torch.int64) << 31)
    s, _ = torch.sort(w)
    first = torch.arange(n, device=s.device) == 0
    mask = ((s >> 31) == 0) & (first | (s != torch.roll(s, 1)))
    total = mask.sum()
    out, _ = torch.sort(torch.where(mask, s, KEY_FILL))
    return (_u32.narrow(out[:cap]), torch.clamp(total, max=cap)
            .to(torch.int32), total > cap)


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
    words): the mutator columns and the saturation table."""

    exp_lo: torch.Tensor        # [M]
    exp_f: torch.Tensor         # [M]
    exp_v: torch.Tensor         # [M, VW]
    exp_act: torch.Tensor       # [M] bool
    exp_pred_lo: torch.Tensor   # [M]
    exp_jit: torch.Tensor       # [M] bool
    exp_rv_lo: torch.Tensor     # [M]
    sat_lo: torch.Tensor        # [2^b]

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

        return RowTables(*(cut(t) for t in self[:-1]), self.sat_lo)


def _expand_keys_compact(lo_in, count, tbl: RowTables, *, cap, b, nil_id,
                         step_fn):
    """The candidate half of :func:`_closure_pass_keys_compact`: in-place
    saturation of the carried keys and their expansion by the mutator
    columns with the chain and JIT gates. ``lo_in`` raw int32[cap],
    ``count`` the carried count. Returns (cand raw int32[cap*(1+M)],
    cand_valid bool)."""
    dev = lo_in.device
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
    nsat_lo = torch.where(in_range, tbl.sat_lo[pns.clamp(0, n_sid - 1)], 0)
    lo1 = torch.where(cfg_valid, x | tbl.sat_lo[sv], x)

    l1 = lo1.unsqueeze(1)
    already = (l1 & tbl.exp_lo) != 0
    chain_ok = (l1 & tbl.exp_pred_lo) == tbl.exp_pred_lo
    jit_ok = tbl.exp_jit | ((tbl.exp_rv_lo & ~l1) != 0)
    fresh = ok & tbl.exp_act & ~already & cfg_valid.unsqueeze(1)
    legal = fresh & chain_ok & jit_ok
    new_lo = ((l1 & ~smask) | tbl.exp_lo | nsat_lo | pns) & _u32.MASK32
    cand = torch.cat([torch.where(cfg_valid, lo1, 0), new_lo.reshape(-1)])
    cand_valid = torch.cat([cfg_valid, legal.reshape(-1)])
    return _u32.narrow(cand), cand_valid


def _closure_pass_keys_compact(lo_in, count, tbl: RowTables, *, cap, b,
                               nil_id, step_fn):
    """ONE closure pass over packed keys with mutator-compacted expansion
    columns (the reference's non-dominance single-key branch): expand,
    sort-dedup, and test the fixpoint against the pass INPUT. Returns
    (lo, count, changed, overflow) as tensors."""
    cand, valid = _expand_keys_compact(lo_in, count, tbl, cap=cap, b=b,
                                       nil_id=nil_id, step_fn=step_fn)
    l2, n2, o2 = _dedup_keys(cand, valid, cap)
    changed = torch.any(l2 != lo_in) | (n2 != count)
    return l2, n2, changed, o2


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


def _resize(lo: torch.Tensor, cap: int) -> torch.Tensor:
    """The frontier array cut or KEY_FILL-padded to ``cap`` (live keys
    are a prefix, so cutting past the count drops nothing)."""
    if lo.shape[0] >= cap:
        return lo[:cap]
    return torch.cat([lo, _fill(cap - lo.shape[0], lo.device)])


def band_error(p: PackedHistory) -> str | None:
    """None when this engine takes the history, else the reason naming
    the band left out of the port."""
    if p.kernel is None:
        return f"no device kernel for {type(p.model).__name__}"
    if p.window > MAX_DEVICE_WINDOW:
        return (f"concurrency window {p.window} exceeds device bitset "
                f"width {MAX_DEVICE_WINDOW}")
    name = p.kernel.name
    if p.state_width != 1 or name not in PACKED_STATE_KERNELS:
        return f"multiword band ({name}) not yet ported"
    rvm = name in READ_VALUE_MATCH_KERNELS
    b = packed_state_bound(p.kernel, len(p.unintern)).bit_length()
    if p.window + b > 31:
        if rvm and b <= 6 and p.window + b <= 60:
            return (f"pair-key band (window {p.window} + {b} state bits "
                    "> 31) not yet ported")
        return (f"multiword band (window {p.window} + {b} state bits) not "
                "yet ported")
    if not rvm or b > 6:
        return f"generic packed band ({name}) not yet ported"
    if np.asarray(p.crashed).any():
        return "crash-dom band (crashed ops) not yet ported"
    return None


class ChunkOut(NamedTuple):
    """A chunk's result. ``rows_done`` counts the dead or overflowing row
    itself; ``pre_lo``/``pre_count`` are the frontier before the last row
    run (the spike hand-off and its explain snapshot start there)."""

    lo: torch.Tensor
    count: int
    rows_done: int
    dead: bool
    ovf: bool
    pre_lo: torch.Tensor
    pre_count: int


class _Engine:
    """One history's sparse search state: host tables, their per-chunk
    device copies, and the row and chunk loops."""

    def __init__(self, p: PackedHistory, device):
        self.p = p
        self.dev = device
        self.nil_id = packed_state_bound(p.kernel, len(p.unintern))
        self.b = self.nil_id.bit_length()
        self.W = p.window
        self.step_fn = p.kernel.step
        self.pure_h, _ = reduction_bit_tables(p, (p.window + 31) // 32)
        self.exp_h = expansion_tables(p, self.b)
        self.M = int(self.exp_h[0].shape[-1])
        self._chunk_key = None
        # Work counters: rows run per tier, fused rows, unfused closure
        # passes (per tier), top-tier retries, and blocking
        # device-to-host fetches.
        self.stats = {"rows": 0, "tiers": {}, "fused_rows": 0,
                      "unfused_passes": 0, "unfused_tiers": {},
                      "retries": 0, "fetches": 0}

    def init_keys(self, cap: int) -> torch.Tensor:
        bits = torch.zeros((1, 1), dtype=torch.int64, device=self.dev)
        state = torch.as_tensor(np.asarray(self.p.init_state, np.int64),
                                device=self.dev).view(1, 1)
        return _pack_frontier_keys(bits, state, 1, cap, self.b,
                                   self.nil_id)

    def load_chunk(self, base: int, rows: int) -> None:
        """Device tables for rows [base, base + rows)."""
        if self._chunk_key == (base, rows):
            return
        p, dev = self.p, self.dev
        sl = [_chunk_slice(t, base, rows) for t in self.exp_h]
        act = _chunk_slice(np.asarray(p.active), base, rows)
        v_row = _chunk_slice(np.asarray(p.slot_v), base, rows)
        pure = _chunk_slice(self.pure_h, base, rows)
        cols, sats = _fused_row_tables(tuple(sl), act, v_row, pure, W=self.W,
                                       b=self.b, nil_id=self.nil_id)

        def put(a, dtype=np.int64):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        self.cols = _u32.bitmap_from_numpy(cols, dev)
        self.sats = _u32.bitmap_from_numpy(sats, dev)
        (exp_lo, _eh, exp_f, exp_v, exp_act, exp_pred_lo, _ph, _cl, _ch,
         _rl, _rh, exp_jit, exp_rv_lo, _rvh) = sl
        self.rows = RowTables(
            put(exp_lo), put(exp_f), put(exp_v), put(exp_act, bool),
            put(exp_pred_lo), put(exp_jit, bool), put(exp_rv_lo),
            put(sats[:, 0]))
        self.ret = _chunk_slice(np.asarray(p.ret_slot), base, rows).tolist()
        self._chunk_key = (base, rows)

    def row_tables(self, r: int) -> RowTables:
        return RowTables(*(t[r] for t in self.rows))

    def row_at_tier(self, tier: int, r: int, lo, count: int, fused: bool):
        """One full row (closure fixpoint + return filter) on the first
        ``tier`` entries of the frontier; ``fused`` allows the fused
        fixpoint where it fits. Returns (lo[cap], count, dead, overflow)
        with host ints and flags."""
        cap = lo.shape[0]
        l_t = lo[:tier] if tier < cap else lo
        M = self.M
        Mg = max(1, _GROUP_BOUND // tier - 1)
        G = -(-M // Mg) if Mg < M else 1
        Mg = min(Mg, M)
        # Convergence needs O(G * window) passes; exhaustion flags
        # overflow, which retries at the top tier or escalates.
        it_max = G * (self.W + 4) + 8
        s = self.ret[r]
        st = self.stats
        st["rows"] += 1
        st["tiers"][tier] = st["tiers"].get(tier, 0) + 1
        if fused and psort_fused.fits(tier, M, self.b):
            l_t, flags = psort_fused.fixpoint_flags(
                l_t, count, self.cols[r], self.sats[r], cap=tier, b=self.b,
                it_max=it_max)
            bit = _u32.raw_word(1 << (self.b + s))
            keep = (torch.arange(tier, device=self.dev) < flags[3]) \
                & ((l_t & bit) != 0)
            # The row's one blocking fetch: the flags and the survivors
            # of the return filter.
            st["fused_rows"] += 1
            st["fetches"] += 1
            conv, o2, _, cnt, n_keep = torch.cat(
                (flags, keep.sum().to(torch.int32).view(1))).tolist()
            ovf = bool(o2) or not conv
            if ovf:
                return lo, cnt, False, True
            l_t, count, dead = _filter_pass_keys(l_t, cnt, s, cap=tier,
                                                 b=self.b, n_keep=n_keep)
        else:
            l_t, count, ovf = self._closure_unfused(l_t, count, r, tier, G,
                                                    Mg, it_max)
            if ovf:
                return lo, count, False, True
            st["fetches"] += 1
            l_t, count, dead = _filter_pass_keys(l_t, count, s, cap=tier,
                                                 b=self.b)
        if tier < cap:
            l_t = torch.cat([l_t, _fill(cap - tier, self.dev)])
        return l_t, count, dead, False

    def _closure_unfused(self, lo, count: int, r: int, tier: int, G: int,
                         Mg: int, it_max: int):
        """The grouped pass chain: columns Mg at a time, ending after G
        consecutive unchanged passes; one fetch per pass. Returns (lo,
        count, overflow)."""
        tbl = self.row_tables(r)
        groups = [tbl.columns(g * Mg, (g + 1) * Mg) for g in range(G)] \
            if G > 1 else [tbl]
        g = since = it = 0
        ovf = False
        while since < G and not ovf:
            l2, n2, changed, o2 = _closure_pass_keys_compact(
                lo, count, groups[g], cap=tier, b=self.b,
                nil_id=self.nil_id, step_fn=self.step_fn)
            n2, changed, o2 = torch.stack(
                (n2.to(torch.int32), changed.to(torch.int32),
                 o2.to(torch.int32))).tolist()
            st = self.stats
            st["unfused_passes"] += 1
            st["unfused_tiers"][tier] = st["unfused_tiers"].get(tier, 0) + 1
            st["fetches"] += 1
            g = 0 if g + 1 >= G else g + 1
            since = 0 if changed else since + 1
            # Converging exactly at the budget is convergence, not
            # overflow.
            ovf = ovf or bool(o2) or (it + 1 >= it_max and since < G)
            it += 1
            lo, count = l2, n2
        return lo, count, ovf

    def run_row(self, r: int, lo, count: int, row_tiers: bool):
        cap = lo.shape[0]
        tiers = (tuple(t for t in ROW_TIERS if t < cap) + (cap,)
                 if row_tiers else (cap,))
        # Spike mini-chunks (untiered) keep the unfused pass chain, as in
        # the reference.
        fused = row_tiers
        if len(tiers) == 1:
            return self.row_at_tier(tiers[0], r, lo, count, fused)
        # Smallest tier holding TIER_MARGIN x the live count; an overflow
        # retries the row at the top tier (rows are functions of their
        # entry frontier, so the retry is exact).
        idx = sum(count * TIER_MARGIN > t for t in tiers[:-1])
        out = self.row_at_tier(tiers[idx], r, lo, count, fused)
        if out[3] and idx < len(tiers) - 1:
            self.stats["retries"] += 1
            out = self.row_at_tier(tiers[-1], r, lo, count, fused)
        return out

    def chunk(self, base: int, n_rows: int, rows: int, lo, count: int,
              row_tiers: bool = True) -> ChunkOut:
        """Up to ``n_rows`` return events from row ``base`` (tables of
        ``rows`` rows), stopping at a death or an overflow."""
        self.load_chunk(base, rows)
        pre_lo, pre_count = lo, count
        for r in range(n_rows):
            pre_lo, pre_count = lo, count
            lo, count, dead, ovf = self.run_row(r, lo, count, row_tiers)
            if dead or ovf:
                return ChunkOut(lo, count, r + 1, dead and not ovf, ovf,
                                pre_lo, pre_count)
        return ChunkOut(lo, count, n_rows, False, False, pre_lo, pre_count)


def _spike_rows(eng: _Engine, r0: int, lo, count: int, *, caps, dropback,
                cancel, snapshots):
    """Spike mode: SPIKE_CHUNK-row mini-chunks at the spike capacities,
    with the same rows as normal chunks (untiered). Processes
    mini-chunks from ``r0`` until death, cancel, overflow of the last
    cap, the history's end, or (after at least :data:`SPIKE_MIN_ROWS`
    rows) the frontier shrinking to ``dropback``. ``snapshots`` (a list)
    receives each mini-chunk's entry frontier, and on a death the dead
    row's own entry. Returns (lo, count, next_row, dead, overflowed, cancelled,
    top_cap_used)."""
    p = eng.p
    lvl = 0
    top_used = caps[0]
    lo = _resize(lo, caps[0])
    r = r0
    while r < p.R:
        if cancel is not None and cancel.is_set():
            return lo, count, r, False, False, True, top_used
        if snapshots is not None:
            snapshots[:] = [(r, lo, count)]
        m_n = min(SPIKE_CHUNK, p.R - r)
        while True:
            out = eng.chunk(r, m_n, SPIKE_CHUNK, lo, count, row_tiers=False)
            if not out.ovf:
                break
            if lvl + 1 >= len(caps):
                return lo, count, r, False, True, False, top_used
            lvl += 1
            lo = _resize(lo, caps[lvl])
            top_used = caps[lvl]
        if out.dead:
            if snapshots is not None and out.rows_done > 1:
                # Anchor the explain replay at the dead row's entry, so
                # the CPU replay spans one row of a spike-sized frontier.
                snapshots[:] = [(r + out.rows_done - 1, out.pre_lo,
                                 out.pre_count)]
            return (out.lo, out.count, r + out.rows_done, True, False,
                    False, top_used)
        lo, count = out.lo, out.count
        r += m_n
        if r - r0 >= SPIKE_MIN_ROWS and count <= dropback:
            break
    return lo, count, r, False, False, False, top_used


def check_packed(p: PackedHistory, cap_schedule=None, chunk: int = CHUNK,
                 cancel=None, explain: bool = False,
                 spike_caps=SPIKE_CAP_SCHEDULE, device=None) -> dict:
    """Decide linearizability of a packed history with the sparse engine.

    Chunks of ``chunk`` rows; capacity adapts per chunk: an overflow
    re-runs the chunk from its entry frontier at the next cap level of
    ``cap_schedule`` (default :data:`PACKED_CAP_SCHEDULE`, its top level
    alone on the card), the frontier past the last level goes to spike
    mode at ``spike_caps``, and a clean chunk whose frontier shrank drops
    back a level. ``cancel`` (threading.Event) stops between chunks.
    ``explain=True`` keeps the chunk-entry frontier and, on an invalid
    verdict, replays the failing tail on the CPU oracle for configs and
    final paths (:mod:`jepsen_tpu_torch.lin.witness`). ``device`` is where
    the search runs (see :func:`jepsen_tpu_torch.resolve_device`).

    Returns the reference's result shape: ``valid?``, ``dead-row``,
    ``op``, ``final-frontier-size``, ``max-cap``, ``overflow``."""
    device = resolve_device(device)
    err = band_error(p)
    if err is not None:
        return {"valid?": "unknown", "analyzer": ANALYZER, "error": err}
    if p.R == 0:
        return {"valid?": True, "analyzer": ANALYZER, "configs": []}
    if cap_schedule is None:
        # Row tiers make small frontiers cheap at any cap, so on the card
        # the band runs top-cap from the start; the CPU keeps a small
        # first level.
        cap_schedule = PACKED_CAP_SCHEDULE[-1:] if device.type == "cuda" \
            else PACKED_CAP_SCHEDULE
    eng = _Engine(p, device)
    backend = "cuda" if device.type == "cuda" else "plain"

    level = 0
    cap = cap_schedule[level]
    lo = eng.init_keys(cap)
    count = 1
    max_cap_used = cap
    snapshots: list | None = [] if explain else None

    def unknown(**kw) -> dict:
        return {"valid?": "unknown", "analyzer": ANALYZER,
                "backend": backend, **kw}

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
        return out

    base = 0
    while base < p.R:
        if snapshots is not None:
            # Only the last snapshot is ever replayed: the dead row is
            # always inside the current chunk.
            snapshots[:] = [(base, lo, count)]
        if cancel is not None and cancel.is_set():
            return unknown(error="cancelled")
        n = min(chunk, p.R - base)
        spiked = None
        while True:
            out = eng.chunk(base, n, chunk, lo, count)
            if not out.ovf:
                break
            if level + 1 >= len(cap_schedule):
                sp_caps = tuple(sorted(c for c in spike_caps
                                       if c > cap_schedule[-1])) or None
                if sp_caps is None:
                    return unknown(overflow="capacity",
                                   error=("frontier exceeded capacity "
                                          f"{cap_schedule[-1]}"))
                # Spike mode starts at the overflowing row, from the
                # frontier the rows before it left.
                n_pre = out.rows_done - 1
                lo, count = out.pre_lo, out.pre_count
                spiked = _spike_rows(
                    eng, base + n_pre, lo, count, caps=sp_caps,
                    dropback=min(SPIKE_DROPBACK, cap_schedule[-1]),
                    cancel=cancel, snapshots=snapshots)
                spike_top = sp_caps[-1]
                break
            # Retry this chunk from its entry frontier at the next cap.
            level += 1
            cap = cap_schedule[level]
            max_cap_used = max(max_cap_used, cap)
            lo = _resize(lo, cap)
        if spiked is not None:
            (s_lo, s_count, next_r, dead_h, ovf_h, cancelled,
             top_used) = spiked
            max_cap_used = max(max_cap_used, top_used)
            if cancelled:
                return unknown(error="cancelled")
            if ovf_h:
                return unknown(overflow="capacity",
                               error=f"frontier exceeded capacity "
                                     f"{spike_top}")
            if dead_h:
                return dead_verdict(next_r - 1)
            if next_r >= p.R:
                lo, count = s_lo, s_count
                break
            # Resume full-size chunks at the top chunk level; the shrink
            # below drops back once chunks run clean.
            level = len(cap_schedule) - 1
            cap = cap_schedule[level]
            lo, count = _resize(s_lo, cap), s_count
            base = next_r
            continue
        if out.dead:
            return dead_verdict(base + out.rows_done - 1)
        lo, count = out.lo, out.count
        base += n
        # The frontier is compacted to the front, so a shrunken frontier
        # drops back to a smaller level by slicing.
        while level > 0 and count * 4 <= cap_schedule[level - 1]:
            level -= 1
            cap = cap_schedule[level]
            lo = lo[:cap]

    return {"valid?": True, "analyzer": ANALYZER, "backend": backend,
            "configs": [], "final-frontier-size": int(count),
            "max-cap": max_cap_used, "engine-stats": eng.stats}


def _materialize(snapshots, eng: _Engine):
    """Snapshots as the ``(base, bits[cap, 1], state[cap, 1], count)``
    numpy tuples the witness replay takes."""
    out = []
    for base, lo, count in snapshots:
        bits, state = _unpack_frontier_keys(lo, count, lo.shape[0], eng.b,
                                            eng.nil_id)
        out.append((base, bits.cpu().numpy(), state.cpu().numpy(), count))
    return out
