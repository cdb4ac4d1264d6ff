"""The device packer: the slot walk and the table paint on the card.

The host packer (:func:`jepsen_tpu_torch.lin.prepare.prepare`) does
pairing and interning (Python-object work by nature) and then three
numeric column passes: the endpoint slot walk, the R x W snapshot paint
and the canonical-chain tables. In the vectorised walk those passes are
integer sort / cumsum / searchsorted / scatter algebra already
(``prepare._pack_events_vec``, ``prepare._chain_tables_vec``). This module
splits the pack at that boundary:

- :func:`prepack` does the host half (pairing, kernelizing, interning
  and the window scan) into a :class:`PrePacked` column bundle that
  already answers a scheduler's questions (shape, fingerprint, window,
  R) without painting the grids. It raises the ``UnsupportedHistory``
  errors ``prepare`` raises.
- :func:`materialize` / :func:`materialize_batch` finish the pack on a
  device with one torch program (:func:`_pack_program`): the event sort,
  the running-minimum fresh-slot scan, the level-sorted bracket pairing,
  pointer-doubling slot propagation, the interval paint, the snapshot
  gathers, the crashed table and the chain tables. The program has a
  leading lane axis, so one call packs a wave of same-bucket histories.
  Its tables are the host pack's, bit for bit.

Padding (a few shape buckets): ops pad to a power-of-two ``n_pad`` with
inert ops at positions past every real event. The first ``R_pad - R``
pads invoke and return as sequential non-overlapping pairs (filling the
return-event axis; their rows land in ``[R, R_pad)`` and are sliced
off), the rest invoke and never return (their paint interval is empty).
Pad events sort after every real event, so the real prefix of every scan
(depth, running minimum, bracket levels) is untouched; a pad that
reuses a real return's slot paints only rows that are sliced off. Pads
past the real window paint into a dump column, also sliced off.

The routing is the JAX package's: a history with no kernel, no return or
no op, and a wave of fewer than :data:`MIN_BATCH_K` lanes, packs on
the host. Each wave's device call runs under the dispatch watchdog (site
``pack-dev``, :mod:`jepsen_tpu_torch.lin.supervise`): a quarantined
shape, a wedge or a fault is counted in :func:`dev_stats`. On the card
it raises (``supervise.Quarantined``, ``WedgedDispatch`` or the fault):
the card's work does not move to the host. On the CPU the wave's lanes
pack on the host instead, the bit-identical pack, as in the JAX package.
The one-shot checkers do not call :func:`materialize`: on the card it
does not beat the host pack (``chip_smoke.py`` phase 22). The service's
admission (as in the JAX package's daemon) is to call it.

:func:`paint_tables_dev` is the stream packer's caller here
(:mod:`jepsen_tpu_torch.stream.incr`): a settle of at least
``paint_min_rows`` new rows (default :data:`STREAM_MIN_ROWS`) paints its
grid, gathers and crashed table on the stream's device with one torch
program (:func:`_paint_program`), supervised at site ``pack-dev``
(shape key ``paint-<kernel>``, band ``stream``), with the same routing
on a non-ok outcome as a wave: the numpy paint on the CPU, a raise on
the card.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from jepsen_tpu_torch import resolve_device
from jepsen_tpu_torch.lin import prepare, supervise
from jepsen_tpu_torch.lin.prepare import PackedHistory, UnsupportedHistory
from jepsen_tpu_torch.models.kernels import F_IDS, NIL


# In materialize_batch, a same-bucket wave of fewer eligible histories
# packs on the host (the JAX package's default).
MIN_BATCH_K = 4

# The stream packer paints a settle of fewer new rows with numpy, and one
# of at least this many on its device (the packer's ``paint_min_rows``).
# Set from chip_smoke.py's [stream-paint] measurement on the H100, where
# both paints cost host time (the card's is a dozen launches and two
# copies): on one host the card's matched numpy's from settles of 1,495
# rows (0.97x its time), on another only at 5,797 (0.87x; 1.13x at
# 2,992); PERF.md.
STREAM_MIN_ROWS = 4096

# Device-pack accounting: dispatches, lanes and wall seconds on the
# device; lanes packed on the host, and of those the eligible ones that a
# wave below MIN_BATCH_K kept there; and the supervision's: lanes that
# fell back to the host, waves routed past a quarantined shape, wedged
# and faulted waves.
_dev_stats = {"dev_packs": 0, "dev_lanes": 0, "dev_pack_s": 0.0,
              "host_lanes": 0, "host_eligible": 0, "host_fallbacks": 0,
              "quarantine_skips": 0, "wedges": 0, "faults": 0}


def dev_stats() -> dict:
    return dict(_dev_stats)


def reset_dev_stats() -> None:
    for k in _dev_stats:
        _dev_stats[k] = 0.0 if k.endswith("_s") else 0


@dataclass
class PrePacked:
    """The host half of a pack: pairing and interning done, numeric
    columns ready, grids not painted. Carries what ``dense.plan`` and a
    scheduler read (kernel, window, R, state_width, unintern,
    init_state)."""

    model: Any
    kernel: Any                  # KernelModel | None
    ops: list                    # LinOp list (reporting / witnesses)
    window: int                  # W_used (exact, from the depth scan)
    R: int
    n: int
    invoke_pos: np.ndarray       # i32[n]
    return_pos: np.ndarray       # i32[n]  (-1 = crashed)
    op_f: np.ndarray             # i32[n]
    op_v: np.ndarray             # i32[n, vw]
    ok_col: np.ndarray | None    # bool[n] (None on the spec pairing)
    init_state: np.ndarray
    intern: dict
    unintern: list
    crashed_ops: list

    @property
    def state_width(self) -> int:
        return len(self.init_state)


def prepack(model, history,
            max_window: int = prepare.MAX_WINDOW) -> PrePacked:
    """Pairing, kernelizing and the window scan: everything
    ``prepare.prepare`` does before the grid paint, raising the same
    ``UnsupportedHistory`` errors (double invoke, unknown f, cas pair,
    window overflow)."""
    t0 = time.perf_counter()
    (ops, kernel, init_state, op_f, op_v, intern, invoke_pos, return_pos,
     R, crashed, ok_col) = prepare._columns(model, list(history))
    W_used = _window_scan(invoke_pos, return_pos, max_window)
    prepare._pack_stats["prepare_s"] += time.perf_counter() - t0
    return PrePacked(
        model=model, kernel=kernel, ops=ops, window=max(1, W_used),
        R=R, n=len(ops),
        invoke_pos=np.asarray(invoke_pos, np.int32),
        return_pos=np.asarray(return_pos, np.int32),
        op_f=np.asarray(op_f, np.int32),
        op_v=np.asarray(op_v, np.int32),
        ok_col=ok_col, init_state=init_state, intern=intern.ids,
        unintern=intern.values, crashed_ops=crashed)


def _window_scan(invoke_pos, return_pos, max_window: int) -> int:
    """The exact W_used and the overflow check: the depth scan of
    ``prepare._pack_events_vec`` alone (the device program never sees an
    overflowing history)."""
    n = len(invoke_pos)
    if n == 0:
        return 0
    ret_ids = np.flatnonzero(np.asarray(return_pos) >= 0)
    ev_pos = np.concatenate([np.asarray(invoke_pos, np.int64),
                             np.asarray(return_pos, np.int64)[ret_ids]])
    order = np.argsort(ev_pos, kind="stable")
    delta = np.where(order >= n, -1, 1)
    depth = np.cumsum(delta)
    W_used = int(depth.max(initial=0))
    if W_used > max_window:
        t = int(np.flatnonzero(depth > max_window)[0])
        raise UnsupportedHistory(
            f"concurrency window exceeds {max_window} pending ops "
            f"at history position {int(ev_pos[order[t]])}",
            kind="window")
    return W_used


def prepack_fingerprint(pre: PrePacked) -> str:
    """The history's identity over the pre-pack columns (the grids are a
    function of them): a sha256 hex digest, the JAX package's
    ``pack_dev.prepack_fingerprint`` of the same history, which is its
    service-wire fingerprint."""
    h = hashlib.sha256()
    h.update(
        f"{pre.kernel.name if pre.kernel else None}|{pre.window}|"
        f"{pre.R}|{len(pre.unintern)}".encode())
    for a in (pre.invoke_pos, pre.return_pos, pre.op_f, pre.op_v,
              pre.init_state):
        arr = np.ascontiguousarray(np.asarray(a))
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


# --- the device program ------------------------------------------------------


def _pow2(x: int, floor: int = 1) -> int:
    return max(floor, 1 << max(0, (int(x) - 1).bit_length()))


def pad_shape(n: int, R: int, W: int, vw: int) -> tuple:
    """The shape bucket one history packs in: power-of-two R and W axes,
    and an op axis with room for the ``R_pad - R`` returning pads."""
    r_pad = _pow2(R, 4)
    w_pad = _pow2(W, 4)
    n_pad = _pow2(n + r_pad - R, 8)
    return n_pad, r_pad, w_pad, vw


def _pad_columns(pre: PrePacked, shape: tuple):
    """The host-side pad to the bucket: inert ops at sequential positions
    past every real event (module docstring). Returns one lane's device
    inputs as numpy arrays."""
    n_pad, r_pad, w_pad, vw = shape
    n, R = pre.n, pre.R
    inv = np.zeros(n_pad, np.int32)
    ret = np.full(n_pad, -1, np.int32)
    inv[:n] = pre.invoke_pos
    ret[:n] = pre.return_pos
    big = np.int32(0)
    if n:
        big = max(int(pre.invoke_pos.max(initial=0)),
                  int(pre.return_pos.max(initial=0))) + 1
    p_ret = r_pad - R                    # returning pads (fill the R axis)
    j = np.arange(n_pad - n, dtype=np.int32)
    inv[n:] = big + 2 * j
    ret[n:n + p_ret] = big + 2 * j[:p_ret] + 1
    op_f = np.zeros(n_pad + 1, np.int32)
    op_v = np.full((n_pad + 1, vw), int(NIL), np.int32)
    op_f[:n] = pre.op_f
    op_v[:n] = pre.op_v
    # The return-event column (R_pad returns): real returns in op order,
    # then the returning pads.
    ret_ids = np.flatnonzero(pre.return_pos >= 0).astype(np.int32)
    ev_rop = np.concatenate([ret_ids,
                             n + j[:p_ret]]).astype(np.int32)
    ev_rpos = ret[ev_rop]
    # Per-op chain ranks (``prepare._chain_tables_vec``'s host half):
    # the class rank, lexicographic over (f << 1 | crashed, value words),
    # and the order-key rank over (return row | R + 2 + invoke position);
    # the per-row stable sort runs on the device.
    cls_rank = np.zeros(n_pad + 1, np.int32)
    ord_rank = np.zeros(n_pad + 1, np.int32)
    if n:
        ret_row = np.full(n, -1, np.int64)
        order_r = np.argsort(pre.return_pos[ret_ids], kind="stable")
        ret_row[ret_ids[order_r]] = np.arange(R)
        crashed_op = ret_row < 0
        ordkey = np.where(crashed_op,
                          np.int64(R + 2)
                          + pre.invoke_pos.astype(np.int64), ret_row)
        cls_cols = [pre.op_v[:, k].astype(np.int64)
                    for k in range(vw - 1, -1, -1)]
        cls_cols.append((pre.op_f.astype(np.int64) << 1) | crashed_op)
        o_ops = np.lexsort(tuple(cls_cols))
        chg = np.zeros(n, bool)
        if n > 1:
            for c in cls_cols:
                cs = c[o_ops]
                chg[1:] |= cs[1:] != cs[:-1]
        cls_rank[:n][o_ops] = np.cumsum(chg, dtype=np.int32)
        ord_rank[:n][np.argsort(ordkey, kind="stable")] = \
            np.arange(n, dtype=np.int32)
    return (inv, ret, ev_rop, ev_rpos, op_f, op_v, cls_rank, ord_rank)


def _shift(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` moved one step right along its last axis, ``fill`` first."""
    head = torch.full_like(x[..., :1], fill)
    return torch.cat([head, x[..., :-1]], -1)


def _pack_program(shape: tuple, inv, ret, ev_rop, ev_rpos, op_f, op_v,
                  cls_rank, ord_rank):
    """The pack of L same-bucket lanes (every input has a leading lane
    axis, int64 on one device): event sort, fresh detection, bracket
    pairing, pointer-doubling slot propagation, interval paint, snapshot
    gathers, crashed table, chain tables. Returns ``(ret_slot, ret_op,
    active, slot_f, slot_v, slot_op, crashed, pure, pred)`` at the padded
    shape, each with the lane axis first.

    The JAX package's ``mode="drop"`` scatters become scatters into one
    extra trash column that is sliced off; gathers clamp their indices
    to the table, as JAX's do."""
    n_pad, r_pad, w_pad, vw = shape
    L = inv.shape[0]
    dev = inv.device
    e_tot = n_pad + r_pad
    doublings = max(1, (n_pad - 1).bit_length())

    def ar(n, start=0):
        return torch.arange(start, start + n, device=dev,
                            dtype=torch.int64).expand(L, n)

    # Endpoint events: invokes [0, n_pad) and returns [n_pad, e_tot),
    # sorted by position (positions are distinct).
    ev_pos = torch.cat([inv, ev_rpos], 1)
    ev_op = torch.cat([ar(n_pad), ev_rop], 1)
    pos_s, perm = torch.sort(ev_pos, dim=1, stable=True)
    op_s = ev_op.gather(1, perm)
    kind_ret = perm >= n_pad
    # Fresh invokes: new running minima of the return-minus-invoke sum
    # take virgin slots 0, 1, 2 ... in order.
    sigma = torch.cumsum(torch.where(kind_ret, 1, -1), 1)
    runmin = torch.cummin(sigma.clamp(max=0), 1).values
    fresh = ~kind_ret & (sigma < _shift(runmin, 0))
    fresh_rank = torch.cumsum(fresh.long(), 1) - 1
    slot_root = torch.full((L, n_pad + 1), -1, dtype=torch.int64,
                           device=dev)
    slot_root.scatter_(1, torch.where(fresh, op_s, n_pad),
                       torch.where(fresh, fresh_rank, -1))
    # Bracket-match the reusing invokes (closes) to the returns whose
    # slots they reuse (opens): a stable sort by level; odd ranks within
    # a level's run match their predecessor.
    sub = kind_ret | ~fresh
    lev = sigma - runmin
    lv = torch.where(kind_ret, lev, lev + 1)
    lv_key = torch.where(sub, lv, e_tot + w_pad + 2)
    lvs, ss = torch.sort(lv_key, dim=1, stable=True)
    subs_s = sub.gather(1, ss)
    idx = ar(e_tot)
    run_first = torch.ones_like(subs_s)
    run_first[:, 1:] = lvs[:, 1:] != lvs[:, :-1]
    base = torch.cummax(torch.where(run_first, idx, 0), 1).values
    rank = idx - base
    op_ss = op_s.gather(1, ss)
    mpair = (rank % 2 == 1) & subs_s
    parent = ar(n_pad + 1).clone()
    parent.scatter_(1, torch.where(mpair, op_ss, n_pad),
                    torch.where(mpair, _shift(op_ss, 0), n_pad))
    for _ in range(doublings):           # fixed-trip pointer doubling
        parent = parent.gather(1, parent)
    slot = slot_root.gather(1, parent[:, :n_pad])
    # Return-event tables, in sorted event order.
    ret_rank = torch.cumsum(kind_ret.long(), 1) - 1
    tgt = torch.where(kind_ret, ret_rank, r_pad)
    zeros_r = torch.zeros((L, r_pad + 1), dtype=torch.int64, device=dev)
    ret_op = zeros_r.scatter(1, tgt, op_s)[:, :r_pad]
    ret_pos_sorted = zeros_r.scatter(1, tgt, pos_s)[:, :r_pad]
    ret_slot = slot.gather(1, ret_op)
    # Row intervals: op i is active in rows [r0, r1) at column slot[i];
    # paint op id + 1 by endpoint deltas and a cumsum.
    r0 = torch.searchsorted(ret_pos_sorted.contiguous(), inv.contiguous())
    r1 = torch.full((L, n_pad), r_pad, dtype=torch.int64, device=dev)
    r1.scatter_(1, ret_op, ar(r_pad, 1))
    col = torch.where((slot < 0) | (slot >= w_pad), w_pad, slot)
    ids1 = ar(n_pad, 1)
    occ = torch.zeros((L, (w_pad + 1) * (r_pad + 1)), dtype=torch.int64,
                      device=dev)
    occ.scatter_add_(1, col * (r_pad + 1) + r0, ids1)
    occ.scatter_add_(1, col * (r_pad + 1) + r1, -ids1)
    occ = torch.cumsum(occ.view(L, w_pad + 1, r_pad + 1), 2)
    grid = occ[:, :w_pad, :r_pad].transpose(1, 2)   # [L, r_pad, w_pad]
    active = grid != 0
    slot_op = grid - 1                    # -1 at inactive cells
    gidx = torch.where(active, slot_op, n_pad).clamp(0, n_pad) \
        .reshape(L, r_pad * w_pad)

    def take(col_tbl):
        return col_tbl.gather(1, gidx).view(L, r_pad, w_pad)

    slot_f = take(op_f)
    slot_v = op_v.gather(1, gidx[:, :, None].expand(L, r_pad * w_pad, vw)) \
        .view(L, r_pad, w_pad, vw)
    ret_ext = torch.cat([ret, torch.zeros_like(ret[:, :1])], 1)
    crashed = (take(ret_ext) < 0) & active
    # Chain tables (``prepare._chain_tables_vec``'s per-row half): the
    # class and order-key ranks came from the host's sorts; the row-wise
    # canonical sort runs here on (class, order-key rank) with a
    # sentinel per column below every chainable class.
    pure = active & (slot_f == int(F_IDS["read"]))
    chainable = active & ~pure & (slot_op >= 0)
    sent = (w_pad - 1 - torch.arange(w_pad, device=dev,
                                     dtype=torch.int64)).view(1, 1, w_pad)
    key_hi = torch.where(chainable, take(cls_rank) + w_pad, sent)
    key_lo = torch.where(chainable, take(ord_rank), 0)
    _, order = torch.sort((key_hi << 32) | key_lo, dim=2, stable=True)
    cs = key_hi.gather(2, order)
    same = cs[..., 1:] == cs[..., :-1]
    pred = torch.full((L, r_pad, w_pad), -1, dtype=torch.int64, device=dev)
    pred.scatter_(2, order[..., 1:], torch.where(same, order[..., :-1], -1))
    return (ret_slot, ret_op, active, slot_f, slot_v, slot_op, crashed,
            pure, pred)


def _run_wave(wave: list, shape: tuple, dev: torch.device) -> list:
    """One device dispatch over a wave of same-bucket lanes: the host
    pad, the program, one copy back. Returns each lane's outputs as numpy
    arrays at the padded shape."""
    cols = [_pad_columns(p, shape) for p in wave]
    args = [torch.from_numpy(np.stack([c[k] for c in cols])).to(dev)
            .long() for k in range(8)]
    out = _pack_program(shape, *args)
    host = [a.to(torch.int32 if a.dtype == torch.int64 else a.dtype)
            .cpu().numpy() for a in out]
    return [tuple(a[i] for a in host) for i in range(len(wave))]


# --- materialization ---------------------------------------------------------


def _host_materialize(pre: PrePacked) -> PackedHistory:
    """The host pack of the prepack columns (the walk ``prepare`` would
    take): ``prepare.prepare``'s grid half, byte for byte."""
    t0 = time.perf_counter()
    packed, mode = prepare.pack_events(
        pre.invoke_pos, pre.return_pos, pre.op_f, pre.op_v,
        prepare.MAX_WINDOW, pre.kernel is not None, pre.R)
    out = _assemble(pre, *packed[:6])
    st = prepare._pack_stats
    st["prepare_s"] += time.perf_counter() - t0
    st["prepare_calls"] += 1
    st["mode"] = mode
    _dev_stats["host_lanes"] += 1
    return out


def _assemble(pre: PrePacked, ret_slot, ret_op, active, slot_f,
              slot_v, slot_op) -> PackedHistory:
    """A PackedHistory from grid tables at a width of at least W: the
    construction of ``prepare.prepare`` (its crashed sentinel
    included)."""
    W = pre.window
    ret_ext = np.concatenate(
        [pre.return_pos.astype(np.int32, copy=False),
         np.zeros(1, np.int32)])
    crashed_tbl = (ret_ext[slot_op] < 0) & active
    out = PackedHistory(
        model=pre.model, kernel=pre.kernel, ops=pre.ops, window=W,
        R=pre.R, ret_slot=ret_slot, ret_op=ret_op,
        active=active[:, :W], slot_f=slot_f[:, :W],
        slot_v=slot_v[:, :W], slot_op=slot_op[:, :W],
        crashed=crashed_tbl[:, :W], init_state=pre.init_state,
        intern=pre.intern, unintern=pre.unintern,
        crashed_ops=pre.crashed_ops)
    out._op_fv = (pre.op_f, pre.op_v, pre.invoke_pos)
    return out


def _assemble_dev(pre: PrePacked, lane) -> PackedHistory:
    """A PackedHistory from one lane's fetched outputs, sliced to the
    real R x W region in the host pack's dtypes, with its reduction
    tables."""
    R, W = pre.R, pre.window
    (ret_slot, ret_op, active, slot_f, slot_v, slot_op, crashed,
     pure, pred) = lane
    out = PackedHistory(
        model=pre.model, kernel=pre.kernel, ops=pre.ops, window=W,
        R=R,
        ret_slot=np.ascontiguousarray(ret_slot[:R], np.int32),
        ret_op=np.ascontiguousarray(ret_op[:R], np.int32),
        active=np.ascontiguousarray(active[:R, :W]),
        slot_f=np.ascontiguousarray(slot_f[:R, :W], np.int32),
        slot_v=np.ascontiguousarray(slot_v[:R, :W], np.int32),
        slot_op=np.ascontiguousarray(slot_op[:R, :W], np.int32),
        crashed=np.ascontiguousarray(crashed[:R, :W]),
        init_state=pre.init_state, intern=pre.intern,
        unintern=pre.unintern, crashed_ops=pre.crashed_ops)
    out._op_fv = (pre.op_f, pre.op_v, pre.invoke_pos)
    out._reduction_tables = (
        np.ascontiguousarray(pure[:R, :W]),
        np.ascontiguousarray(pred[:R, :W], np.int32))
    return out


def _device_eligible(pre: PrePacked) -> bool:
    # A history with no kernel goes to the generic CPU search, and one
    # with R == 0 or no op has no grid worth a dispatch.
    return pre.kernel is not None and pre.R > 0 and pre.n > 0


def materialize(pre: PrePacked, *, device=None) -> PackedHistory:
    """Finish one pack: the device program on ``device`` (the card when
    None; raises without one) when the history is eligible, else the host
    pack. Both give the same PackedHistory, with its reduction tables
    from the device."""
    dev = resolve_device(device)
    if not _device_eligible(pre):
        return _host_materialize(pre)
    return _materialize_wave([pre], dev)[0]


def materialize_batch(pres: list, *, device=None) -> list:
    """Pack K histories in order. Same-bucket eligible lanes ride one
    device call on ``device`` (the card when None; raises without one);
    the rest, and a bucket of fewer than :data:`MIN_BATCH_K` lanes, pack
    on the host."""
    dev = resolve_device(device)
    out: list = [None] * len(pres)
    groups: dict = {}
    for i, pre in enumerate(pres):
        if not _device_eligible(pre):
            out[i] = _host_materialize(pre)
        else:
            shape = pad_shape(pre.n, pre.R, pre.window,
                              pre.op_v.shape[1])
            groups.setdefault(shape, []).append(i)
    for ix in groups.values():
        wave = [pres[i] for i in ix]
        if len(wave) < max(1, MIN_BATCH_K):
            _dev_stats["host_eligible"] += len(wave)
            packs = [_host_materialize(p) for p in wave]
        else:
            packs = _materialize_wave(wave, dev)
        for i, p in zip(ix, packs):
            out[i] = p
    return out


def _shape_key(shape: tuple, lanes: int) -> str:
    n_pad, r_pad, w_pad, vw = shape
    return supervise.shape_key("pack-dev", cap=n_pad, window=w_pad,
                               kernel=f"pack-vw{vw}", rows=max(1, lanes),
                               band=f"r{r_pad}")


def _materialize_wave(wave: list, dev: torch.device) -> list:
    """One supervised device call over same-bucket lanes. On any outcome
    but ``ok`` it raises on the card and packs every lane on the host on
    the CPU."""
    pre0 = wave[0]
    shape = pad_shape(pre0.n, pre0.R, pre0.window, pre0.op_v.shape[1])
    key = _shape_key(shape, len(wave))
    if supervise.quarantined(key) is not None:
        supervise.note_skip(None)
        _dev_stats["quarantine_skips"] += 1
        if not supervise.host_rungs(dev):
            raise supervise.Quarantined(
                f"pack-dev shape {key} is quarantined "
                f"({supervise.ledger_path()})")
        _dev_stats["host_fallbacks"] += len(wave)
        return [_host_materialize(p) for p in wave]
    t0 = time.perf_counter()
    outcome, lanes = supervise.run_guarded(
        "pack-dev", key, lambda: _run_wave(wave, shape, dev))
    if outcome != "ok":
        _dev_stats["wedges" if outcome == "wedge" else "faults"] += 1
        if not supervise.host_rungs(dev):
            raise lanes
        _dev_stats["host_fallbacks"] += len(wave)
        return [_host_materialize(p) for p in wave]
    dt = time.perf_counter() - t0
    _dev_stats["dev_packs"] += 1
    _dev_stats["dev_lanes"] += len(wave)
    _dev_stats["dev_pack_s"] += dt
    st = prepare._pack_stats
    st["prepare_s"] += dt
    st["prepare_calls"] += len(wave)
    st["mode"] = "dev"
    return [_assemble_dev(p, lane) for p, lane in zip(wave, lanes)]


# --- the streaming paint (stream/incr.py's settled-row increments) ----------


def _paint_program(W: int, n_new: int, p_slot, r0, r1, ids1, opf, opv,
                   op_crash, n1: int):
    """The stream settle's grid half on one device: the interval paint of
    the carried painters (op id + 1 added at row ``r0``, taken away at
    ``r1``, a cumsum along the rows) and the snapshot gathers. The settle
    computed painters, slots and intervals on the host with its carried
    walk state; the O(rows x W) tail runs here. A painter outside the
    window paints into column ``W``, which is dropped; an inactive cell
    gathers the pad op at ``n1`` (f 0, value NIL, not crashed), as the
    numpy paint's ``-1`` index reads the sentinel slot. ``op_crash`` is a
    bool column the host computed (the stream's never-returns sentinel
    is an int64 the int32 tables never hold). Returns (grid, slot_f,
    slot_v, crashed); ``active`` and ``slot_op`` are ``grid != 0`` and
    ``grid - 1``."""
    col = torch.where((p_slot < 0) | (p_slot >= W), W, p_slot)
    occ = torch.zeros((W + 1) * (n_new + 1), dtype=torch.int32,
                      device=p_slot.device)
    occ.scatter_add_(0, col * (n_new + 1) + r0, ids1)
    occ.scatter_add_(0, col * (n_new + 1) + r1, -ids1)
    occ = torch.cumsum(occ.view(W + 1, n_new + 1), 1, dtype=torch.int32)
    grid = occ[:W, :n_new].t()
    active = grid != 0
    gidx = torch.where(active, grid.long() - 1, n1)
    return grid, opf[gidx], opv[gidx], op_crash[gidx] & active


def paint_tables_dev(p_slot, r0, r1, ids1, op_f, op_v, op_crashed,
                     n1: int, n_new: int, W: int, *, kernel: str,
                     device=None, stats: dict | None = None):
    """One stream settle's paint on ``device`` (the card when None;
    raises without one), supervised at site ``pack-dev``. Returns the
    (grid, active, slot_f, slot_v, slot_op, crashed) numpy tables of the
    ``n_new`` new rows, the numpy paint's bit for bit. On a quarantined
    shape, a wedge or a fault (counted in :func:`dev_stats`) it returns
    None on the CPU, and the caller paints with numpy, as in the JAX
    package; on the card it raises (``supervise.Quarantined``,
    ``WedgedDispatch`` or the fault): the card's work does not move to the
    host."""
    dev = resolve_device(device)
    key = supervise.shape_key("pack-dev", cap=_pow2(len(p_slot), 8),
                              window=W, kernel=f"paint-{kernel}",
                              rows=_pow2(n_new, 8), band="stream")
    if supervise.quarantined(key) is not None:
        supervise.note_skip(stats)
        _dev_stats["quarantine_skips"] += 1
        if not supervise.host_rungs(dev):
            raise supervise.Quarantined(
                f"pack-dev shape {key} is quarantined "
                f"({supervise.ledger_path()})")
        _dev_stats["host_fallbacks"] += 1
        return None
    vw = op_v.shape[1]
    # The op tables with the pad op at n1 (the numpy paint's sentinel).
    opf = np.zeros(n1 + 1, np.int32)
    opf[:n1] = op_f[:n1]
    opv = np.full((n1 + 1, vw), int(NIL), np.int32)
    opv[:n1] = op_v[:n1]
    opc = np.zeros(n1 + 1, bool)
    opc[:n1] = op_crashed[:n1]
    host = (np.asarray(p_slot, np.int64), np.asarray(r0, np.int64),
            np.asarray(r1, np.int64), np.asarray(ids1, np.int32),
            opf, opv, opc)

    def thunk():
        args = [torch.from_numpy(a).to(dev) for a in host]
        grid, slot_f, slot_v, crashed = _paint_program(W, n_new, *args,
                                                       n1=n1)
        # One copy back: the four tables side by side as int32 columns.
        out = torch.cat([grid, slot_f, slot_v.reshape(n_new, W * vw),
                         crashed.to(torch.int32)], 1).cpu().numpy()
        return out

    t0 = time.perf_counter()
    outcome, res = supervise.run_guarded("pack-dev", key, thunk,
                                         stats=stats)
    if outcome != "ok":
        _dev_stats["wedges" if outcome == "wedge" else "faults"] += 1
        if not supervise.host_rungs(dev):
            raise res
        _dev_stats["host_fallbacks"] += 1
        return None
    _dev_stats["dev_packs"] += 1
    _dev_stats["dev_lanes"] += 1
    _dev_stats["dev_pack_s"] += time.perf_counter() - t0
    grid = np.ascontiguousarray(res[:, :W])
    slot_f = np.ascontiguousarray(res[:, W:2 * W])
    slot_v = np.ascontiguousarray(
        res[:, 2 * W:(2 + vw) * W].reshape(n_new, W, vw))
    crashed = res[:, (2 + vw) * W:] != 0
    return grid, grid != 0, slot_f, slot_v, grid - 1, crashed
