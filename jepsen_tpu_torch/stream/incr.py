"""Incremental history packing: ``prepare``'s walk in settled-row steps.

The port's copy of the JAX package's ``stream/incr.py``. A one-shot
:func:`jepsen_tpu_torch.lin.prepare.prepare` is a function of the whole
history: the slot walk sees every endpoint event, the crashed flags need
to know which ops never return, and failed ops are gone before the walk.
A stream cannot wait for the end, and need not re-pack from op 0, because
every row is fixed by a finite prefix of events:

**Settled rows.** A return-event row ``r`` (at event position ``pos_r``)
depends on the ops invoked before ``pos_r``: which are active, their
interned ``(f, value)``, and whether each returns (the ``crashed`` flag
the exact reductions and the dominance prune read) or fails (removed
from the history). So row ``r`` is *settled*, never to be revised, once
every op invoked before ``pos_r`` has a completion (ok / fail / info).
With ``q_min`` the smallest invoke position of an unresolved op, the
settled prefix is the rows with ``pos_r < q_min``; at finalize the
dangling invokes become crashed and everything settles.

The packer keeps the slot walk's state (free slots, active map, interner)
across settles and replays the endpoint events in position order, never
past ``q_min``. The walk and the interner see the one-shot pack's events
in its order, so the final tables are ``prepare.prepare``'s bit for bit,
which is what makes the streamed verdict equal the one-shot one.

**Reduction tables.** ``prepare.reduction_tables`` orders canonical
chains by return row, which an op whose return lies past ``q_min`` does
not have yet. Return rows are monotone in return positions, which every
resolved op has, so the chains here key on positions and give the same
``pred`` table. Settled rows' tables are final: they are computed once a
block and injected into each :meth:`IncrementalPacker.packed` view.

**The paint.** The vectorised settle (the default; the per-event spec
walk under ``JEPSEN_TPU_FAST_PACK=0``) paints the new rows' R x W tables
from painter intervals. A settle of at least ``paint_min_rows`` new rows
(default :data:`jepsen_tpu_torch.lin.pack_dev.STREAM_MIN_ROWS`) paints
on the packer's device (:func:`jepsen_tpu_torch.lin.pack_dev.
paint_tables_dev`, supervised at site ``pack-dev``); a smaller one with
numpy. A failed device paint takes the numpy paint on the CPU and raises
on the card.

Incremental packing works for the fixed-state-layout kernels (register,
cas-register, mutex). A set or queue kernel is sized from the history,
so its state layout, and a carried frontier, would change between
increments: those models run in buffer mode (events accumulate and the
session runs one post-hoc check at finalize).
"""

from __future__ import annotations

import hashlib
import heapq
import time

import numpy as np

from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch import resolve_device
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.lin import pack_dev, prepare
from jepsen_tpu_torch.lin.prepare import (LinOp, PackedHistory,
                                          UnsupportedHistory)

# Chain-order sentinel for ops that never return, far past any event
# position (positions are per-session counters, bounded by fed events).
_NEVER = np.int64(1) << 40


class IncrementalPacker:
    """Grow a :class:`PackedHistory` in settled-row increments.

    ``feed`` raw history events (invoke / ok / fail / info, any
    interleaving, nemesis lines ignored); ``settle`` extends the packed
    row tables to the current settled prefix; ``packed`` returns a
    PackedHistory view of the settled rows with the reduction-table
    cache injected. ``incremental`` is False in buffer mode (module
    docstring): then only ``history`` accumulates.

    ``device`` is where a settle's paint runs (the card when None; raises
    without one); ``paint_min_rows`` the smallest settle painted there
    (default :data:`pack_dev.STREAM_MIN_ROWS`). ``paint_stats`` counts
    the settles painted on the device and with numpy, with their wall
    seconds.
    """

    def __init__(self, model, max_window: int = prepare.MAX_WINDOW, *,
                 device=None, paint_min_rows: int | None = None):
        self.model = model
        self.max_window = max_window
        self.device = resolve_device(device)
        self.paint_min_rows = pack_dev.STREAM_MIN_ROWS \
            if paint_min_rows is None else paint_min_rows
        self.paint_stats = {"dev_paints": 0, "dev_paint_s": 0.0,
                            "host_paints": 0, "host_paint_s": 0.0}
        self.intern = prepare._Interner()
        self.kernel, self.init_state = self._stream_kernel(model)
        self.incremental = self.kernel is not None
        self.broken: str | None = None  # feed-time UnsupportedHistory
        self.history: list[Op] = []     # every fed event, in feed order
        self.ops: list[LinOp] = []      # resolved ops, invoke order
        self.R = 0                      # settled return-event rows
        self.events_processed = 0       # endpoint events walked
        self.finalized = False

        self._pos = 0                   # next event position
        self._pending: dict = {}        # process -> (pos, invoke Op)
        self._heap: list = []           # (pos, kind, seq, LinOp)
        self._seq = 0
        # The slot walk's state, carried across settles.
        self._free = list(range(max_window))[::-1]
        self._slot_of: dict[int, int] = {}     # op id -> slot
        self._cur_active: dict[int, int] = {}  # slot -> op id
        self.max_used = 0
        # Per-op interned tables (grow in op order).
        self._op_f: list[int] = []
        self._op_v: list[list[int]] = []
        self._vw = self.kernel.value_width if self.kernel is not None \
            else int(prepare.VALUE_WIDTH)
        # Growing per-op arrays for the vectorised settle, with one
        # sentinel slot past the live count, so that slot_op = -1 indexes
        # the inactive fill values (the one-shot walk's idiom).
        self._n_arr = 0
        self._op_f_a = np.zeros(0, np.int32)
        self._op_v_a = np.zeros((0, self._vw), np.int32)
        self._inv_pos_a = np.zeros(0, np.int64)
        self._ret_pos_a = np.zeros(0, np.int64)
        # Row blocks at the full width (sliced to the live window in
        # packed()); block lists amortise the concatenation.
        self._blocks: dict[str, list[np.ndarray]] = {
            k: [] for k in ("ret_slot", "ret_op", "active", "slot_f",
                            "slot_v", "slot_op", "crashed")}
        self._tables: dict[str, np.ndarray] | None = None
        self._red_blocks: list[tuple[np.ndarray, np.ndarray]] = []
        self._red_cache: tuple | None = None

    # --- kernel selection ---------------------------------------------------

    def _stream_kernel(self, model):
        """Fixed-state-layout kernels only: a set or queue kernel is sized
        from the history, so its packed state, and a carried frontier,
        would change layout between increments (buffer mode)."""
        from jepsen_tpu_torch.models.kernels import kernel_for

        if isinstance(model, (model_ns.CASRegister, model_ns.Register)):
            kernel = kernel_for(model)
            return kernel, np.array([self.intern(model.value)], np.int32)
        if isinstance(model, model_ns.Mutex):
            kernel = kernel_for(model)
            return kernel, kernel.init_state()
        return None, None

    # --- feeding ------------------------------------------------------------

    def feed(self, op: Op) -> None:
        """Record one history event. The endpoint bookkeeping is
        ``prepare.pair_ops``'s: failed ops are dropped, crashed reads
        elided, an info completion stays concurrent forever.

        An unpackable event (a double invoke) turns the packer to buffer
        mode instead of raising: the history keeps accumulating, the
        session stops incrementing, and its post-hoc check at finalize
        reports what the one-shot pack would (an exception here would
        drop the rest of the caller's batch)."""
        self.history.append(op)
        pos = self._pos
        self._pos += 1
        if not self.incremental:
            return
        try:
            self._feed_endpoint(op, pos)
        except UnsupportedHistory as e:
            self.broken = str(e)
            self.incremental = False

    def _feed_endpoint(self, op: Op, pos: int) -> None:
        if op.process == "nemesis" or op.f in ("start", "stop"):
            return
        if op.is_invoke:
            if op.process in self._pending:
                raise UnsupportedHistory(
                    f"process {op.process} invoked twice without "
                    f"completing (positions "
                    f"{self._pending[op.process][0]} and {pos})")
            self._pending[op.process] = (pos, op)
        elif op.process in self._pending:
            ipos, inv = self._pending.pop(op.process)
            if op.is_fail:
                return            # failed ops did not happen
            ok = op.is_ok
            if not ok and inv.f == "read":
                return            # crashed reads constrain nothing
            self._resolve(inv, ipos, op, pos if ok else None)

    def feed_many(self, events) -> int:
        n = 0
        for op in events:
            self.feed(op)
            n += 1
        return n

    def _resolve(self, inv: Op, ipos: int, completion: Op | None,
                 return_pos: int | None) -> None:
        o = LinOp(op_index=inv.index if inv.index is not None else ipos,
                  process=inv.process, f=inv.f,
                  value=prepare._semantic_value(inv.f, inv, completion),
                  ok=return_pos is not None, invoke_pos=ipos,
                  return_pos=return_pos)
        heapq.heappush(self._heap, (ipos, 0, self._seq, o))
        self._seq += 1
        if return_pos is not None:
            heapq.heappush(self._heap, (return_pos, 1, self._seq, o))
            self._seq += 1

    @property
    def unresolved(self) -> int:
        return len(self._pending)

    # --- the settled-prefix walk --------------------------------------------

    def settle(self, final: bool = False) -> int:
        """Walk every endpoint event of the settled prefix (position
        < q_min; everything once ``final``), extending the row tables.
        Returns the number of new return-event rows.

        By default the batch takes the vectorised walk (prepare's
        sort / cumsum bracket passes with the carried free stack as the
        virgin slot region), O(new events + new rows x W) a settle; under
        ``JEPSEN_TPU_FAST_PACK=0`` the per-event spec walk, which gives
        the same tables. A batch that would overflow the window takes the
        spec walk, which raises mid-walk as the one-shot pack does."""
        if not self.incremental:
            return 0
        if final and not self.finalized:
            self.finalized = True
            # Dangling invokes are crashed (info); crashed reads elide.
            for proc, (ipos, inv) in list(self._pending.items()):
                if inv.f != "read":
                    self._resolve(inv, ipos, None, None)
            self._pending.clear()
        q_min = _NEVER if not self._pending else \
            min(pos for pos, _ in self._pending.values())
        evs = []
        heap = self._heap
        while heap and heap[0][0] < q_min:
            evs.append(heapq.heappop(heap))
        if not evs:
            return 0
        t0 = time.perf_counter()
        if prepare.fast_pack_enabled() and not self._overflows(evs):
            n_new = self._settle_vec(evs)
        else:
            n_new = self._settle_spec(evs)
        st = prepare._pack_stats
        st["incr_s"] += time.perf_counter() - t0
        st["incr_calls"] += 1
        return n_new

    def _overflows(self, evs) -> bool:
        d = np.fromiter((1 - 2 * e[1] for e in evs), np.int64, len(evs))
        return len(self._cur_active) + int(
            np.cumsum(d).max(initial=0)) > self.max_window

    def _settle_spec(self, evs) -> int:
        """The per-event walk (``JEPSEN_TPU_FAST_PACK=0``):
        ``prepare._pack_events_py``'s loop with carried state."""
        rows = {k: [] for k in self._blocks}
        W = self.max_window
        vw = self._vw
        for pos, kind, _, o in evs:
            self.events_processed += 1
            if kind == 0:                                   # invoke
                if not self._free:
                    raise UnsupportedHistory(
                        f"concurrency window exceeds {W} pending ops "
                        f"at history position {pos}", kind="window")
                i = len(self.ops)
                o._id = i
                self.ops.append(o)
                f_id, v = prepare._op_f_and_values(o, self.intern)
                self._op_f.append(f_id)
                self._op_v.append(v[:vw] + [0] * (vw - len(v)))
                s = self._free.pop()
                self._slot_of[i] = s
                self._cur_active[s] = i
                self.max_used = max(self.max_used, s + 1)
            else:                                           # ok return
                i = o._id
                s = self._slot_of[i]
                active = np.zeros(W, bool)
                slot_f = np.zeros(W, np.int32)
                slot_v = np.full((W, vw), int(prepare.NIL), np.int32)
                slot_op = np.full(W, -1, np.int32)
                crashed = np.zeros(W, bool)
                for slot, op_id in self._cur_active.items():
                    active[slot] = True
                    slot_op[slot] = op_id
                    slot_f[slot] = self._op_f[op_id]
                    slot_v[slot] = self._op_v[op_id]
                    # Every op active at a settled row is resolved, so
                    # its crashed flag is final.
                    crashed[slot] = self.ops[op_id].return_pos is None
                rows["ret_slot"].append(np.int32(s))
                rows["ret_op"].append(np.int32(i))
                rows["active"].append(active)
                rows["slot_f"].append(slot_f)
                rows["slot_v"].append(slot_v)
                rows["slot_op"].append(slot_op)
                rows["crashed"].append(crashed)
                self.R += 1
                del self._cur_active[s]
                del self._slot_of[i]
                self._free.append(s)
        n_new = len(rows["ret_slot"])
        if n_new:
            for k, items in rows.items():
                self._blocks[k].append(np.stack(items) if items[0].ndim
                                       else np.asarray(items))
            self._tables = None
            block = self._tables_concat()
            lo = self.R - n_new
            self._red_blocks.append(self._reduce_rows(block, lo, self.R))
            self._red_cache = None
        return n_new

    # --- the vectorised settle ----------------------------------------------

    def _ensure_op_capacity(self, need: int) -> None:
        cap = self._op_f_a.shape[0]
        if need <= cap:
            return
        new_cap = max(need, 2 * cap, 256)
        pad = new_cap - cap
        self._op_f_a = np.concatenate(
            [self._op_f_a, np.zeros(pad, np.int32)])
        self._op_v_a = np.concatenate(
            [self._op_v_a, np.zeros((pad, self._vw), np.int32)])
        self._inv_pos_a = np.concatenate(
            [self._inv_pos_a, np.zeros(pad, np.int64)])
        self._ret_pos_a = np.concatenate(
            [self._ret_pos_a, np.zeros(pad, np.int64)])

    def _materialize_ops(self, n0, n1, new_f, new_v, new_ip, new_rp):
        """Append the new ops' interned tables and endpoint positions to
        the growing arrays (and the sentinel slot at n1). Backfills ops
        packed by earlier spec-walk settles, so that switching
        ``JEPSEN_TPU_FAST_PACK`` mid-stream stays correct."""
        self._ensure_op_capacity(n1 + 1)
        if self._n_arr < n0:
            lo = self._n_arr
            self._op_f_a[lo:n0] = np.asarray(self._op_f[lo:n0], np.int32)
            self._op_v_a[lo:n0] = np.asarray(self._op_v[lo:n0], np.int32)
            self._inv_pos_a[lo:n0] = np.fromiter(
                (o.invoke_pos for o in self.ops[lo:n0]),
                np.int64, n0 - lo)
            self._ret_pos_a[lo:n0] = np.fromiter(
                (int(_NEVER) if o.return_pos is None else o.return_pos
                 for o in self.ops[lo:n0]), np.int64, n0 - lo)
        if n1 > n0:
            self._op_f_a[n0:n1] = np.asarray(new_f, np.int32)
            self._op_v_a[n0:n1] = np.asarray(new_v, np.int32)
            self._inv_pos_a[n0:n1] = np.asarray(new_ip, np.int64)
            self._ret_pos_a[n0:n1] = np.asarray(new_rp, np.int64)
        self._n_arr = n1
        self._op_f_a[n1] = 0
        self._op_v_a[n1] = int(prepare.NIL)
        self._inv_pos_a[n1] = 0
        self._ret_pos_a[n1] = 0

    def _settle_vec(self, evs) -> int:
        """One batched pass over the settled events: the bracket walk of
        ``prepare._pack_events_vec`` (returns open, invokes close) with
        two carry twists: fresh invokes (running minima of the
        return-minus-invoke sum) pop the carried free stack top-down
        instead of the virgin 0, 1, 2 ... region, and the carried actives
        paint as row intervals from batch row 0. The spec walk's tables,
        bit for bit."""
        E = len(evs)
        self.events_processed += E
        W = self.max_window
        vw = self._vw
        n0 = len(self.ops)
        kind_ret = np.empty(E, bool)
        ev_pos = np.empty(E, np.int64)
        ev_gid = np.empty(E, np.int64)
        new_f, new_v, new_ip, new_rp = [], [], [], []
        for e, (pos, kind, _, o) in enumerate(evs):
            ev_pos[e] = pos
            if kind == 0:                                   # invoke
                o._id = len(self.ops)
                self.ops.append(o)
                f_id, v = prepare._op_f_and_values(o, self.intern)
                vv = v[:vw] + [0] * (vw - len(v))
                self._op_f.append(f_id)
                self._op_v.append(vv)
                new_f.append(f_id)
                new_v.append(vv)
                new_ip.append(o.invoke_pos)
                new_rp.append(int(_NEVER) if o.return_pos is None
                              else o.return_pos)
                kind_ret[e] = False
            else:                                           # ok return
                kind_ret[e] = True
            ev_gid[e] = o._id
        k = len(new_f)
        n1 = n0 + k
        self._materialize_ops(n0, n1, new_f, new_v, new_ip, new_rp)

        # Fresh invokes: the batch's recycle stack is empty exactly when
        # the return-minus-invoke running sum hits a new minimum; they
        # take the carried free stack's slots top-down, in order.
        sigma = np.cumsum(np.where(kind_ret, 1, -1))
        runmin = np.minimum.accumulate(np.minimum(sigma, 0))
        prev_runmin = np.empty_like(runmin)
        prev_runmin[0] = 0
        prev_runmin[1:] = runmin[:-1]
        fresh = (~kind_ret) & (sigma < prev_runmin)
        n_fresh = int(fresh.sum())

        # Local op table: the batch's invoked ops [0, k) in invoke order,
        # then the carried ops that return in this batch.
        ret_gids = ev_gid[kind_ret]
        carried = ret_gids < n0
        carried_gids = ret_gids[carried]
        n_car = len(carried_gids)
        L = k + n_car
        lop = np.empty(E, np.int64)
        lop[~kind_ret] = ev_gid[~kind_ret] - n0
        c_idx = np.cumsum(carried) - 1
        lop[np.flatnonzero(kind_ret)] = np.where(
            carried, k + c_idx, ret_gids - n0)
        slot_root = np.full(max(1, L), -1, np.int32)
        if n_fresh:
            reserve = np.asarray(self._free[::-1][:n_fresh], np.int32)
            slot_root[ev_gid[fresh] - n0] = reserve
            self.max_used = max(self.max_used, int(reserve.max()) + 1)
        if n_car:
            slot_root[k:L] = [self._slot_of[int(g)]
                              for g in carried_gids.tolist()]
        # Bracket-match recycled invokes to the return they reuse, then
        # propagate slots along reuse chains by pointer doubling (roots:
        # the batch's fresh ops and the carried ops).
        sub = kind_ret | ((~kind_ret) & ~fresh)
        si = np.flatnonzero(sub)
        lev = sigma - runmin
        lv = np.where(kind_ret[si], lev[si], lev[si] + 1)
        so = np.argsort(lv, kind="stable")
        ss = si[so]
        lvs = lv[so]
        parent = np.arange(max(1, L), dtype=np.int64)
        if len(ss):
            run_first = np.empty(len(ss), bool)
            run_first[0] = True
            run_first[1:] = lvs[1:] != lvs[:-1]
            base = np.maximum.accumulate(
                np.where(run_first, np.arange(len(ss)), 0))
            rank = np.arange(len(ss)) - base
            mpair = rank % 2 == 1
            parent[lop[ss[mpair]]] = lop[ss[np.flatnonzero(mpair) - 1]]
            while True:
                pp = parent[parent]
                if np.array_equal(pp, parent):
                    break
                parent = pp
        slot_l = slot_root[parent]

        n_new = int(kind_ret.sum())
        if n_new:
            rlop = lop[kind_ret]
            # Row intervals in batch-row space: carried actives from row
            # 0, batch ops from their invoke; still-active ops paint
            # through the last row (the next batch paints them from 0).
            n_car0 = len(self._cur_active)
            ca_slots = np.fromiter(self._cur_active.keys(), np.int64,
                                   n_car0)
            ca_gids = np.fromiter(self._cur_active.values(), np.int64,
                                  n_car0)
            p_gid = np.concatenate([ca_gids, np.arange(n0, n1)])
            p_slot = np.concatenate(
                [ca_slots, slot_l[:k].astype(np.int64, copy=False)])
            ret_pos_sorted = ev_pos[kind_ret]
            r0 = np.concatenate([
                np.zeros(n_car0, np.int64),
                np.searchsorted(ret_pos_sorted, self._inv_pos_a[n0:n1])])
            r1 = np.full(n_car0 + k, n_new, np.int64)
            rows_idx = np.arange(n_new, dtype=np.int64)
            bm = ~carried
            r1[n_car0 + (ret_gids[bm] - n0)] = rows_idx[bm] + 1
            if n_car:
                ca_pos = {int(g): j for j, g in
                          enumerate(ca_gids.tolist())}
                for rr, g in zip(rows_idx[carried].tolist(),
                                 carried_gids.tolist()):
                    r1[ca_pos[g]] = rr + 1
            grid, active, slot_f, slot_v, slot_op, crashed = self._paint(
                p_slot, r0, r1, (p_gid + 1).astype(np.int32), n1, n_new)
            b = self._blocks
            b["ret_slot"].append(slot_l[rlop].astype(np.int32,
                                                     copy=False))
            b["ret_op"].append(ret_gids.astype(np.int32, copy=False))
            b["active"].append(active)
            b["slot_f"].append(slot_f)
            b["slot_v"].append(slot_v)
            b["slot_op"].append(slot_op)
            b["crashed"].append(crashed)
            self._tables = None
            self.R += n_new
            self._red_blocks.append(self._reduce_rows_vec(
                active, slot_f, slot_v, slot_op, grid))
            self._red_cache = None

        # Replay the walk state's bookkeeping (dicts and the LIFO free
        # list): O(new events) Python, no per-row numpy.
        free = self._free
        sl = slot_l[lop].tolist()
        kl = kind_ret.tolist()
        gl = ev_gid.tolist()
        for e in range(E):
            g = gl[e]
            s = sl[e]
            if kl[e]:
                del self._cur_active[s]
                del self._slot_of[g]
                free.append(s)
            else:
                free.pop()
                self._slot_of[g] = s
                self._cur_active[s] = g
        return n_new

    def _paint(self, p_slot, r0, r1, ids1, n1: int, n_new: int):
        """The new rows' (grid, active, slot_f, slot_v, slot_op, crashed):
        op id + 1 painted over each painter's rows [r0, r1) in its slot's
        column, then the snapshot gathers. A settle of at least
        ``paint_min_rows`` rows paints on the packer's device; the crashed
        flag crosses as a bool column, because the int64 never-returns
        sentinel never fits the int32 tables. On the CPU a non-ok device
        paint (wedge, fault, quarantined shape) returns None and numpy
        paints instead, the same tables; on the card it raises."""
        W = self.max_window
        t0 = time.perf_counter()
        if n_new >= self.paint_min_rows:
            dev = pack_dev.paint_tables_dev(
                p_slot, r0, r1, ids1, self._op_f_a[:n1], self._op_v_a[:n1],
                self._ret_pos_a[:n1] >= _NEVER, n1, n_new, W,
                kernel=self.kernel.name, device=self.device)
            if dev is not None:
                self.paint_stats["dev_paints"] += 1
                self.paint_stats["dev_paint_s"] += time.perf_counter() - t0
                return dev
        # Column-major paint (cumsum along the contiguous axis), as in
        # the one-shot walk.
        occ = np.zeros((W, n_new + 1), np.int32)
        flat = occ.reshape(-1)
        np.add.at(flat, p_slot * (n_new + 1) + r0, ids1)
        np.subtract.at(flat, p_slot * (n_new + 1) + r1, ids1)
        np.cumsum(occ, axis=1, out=occ)
        grid = np.ascontiguousarray(occ[:, :n_new].T)
        active = grid != 0
        slot_op = grid - 1
        slot_f = self._op_f_a[:n1 + 1][slot_op]
        slot_v = self._op_v_a[:n1 + 1][slot_op]
        crashed = (self._ret_pos_a[:n1 + 1][slot_op] >= _NEVER) & active
        self.paint_stats["host_paints"] += 1
        self.paint_stats["host_paint_s"] += time.perf_counter() - t0
        return grid, active, slot_f, slot_v, slot_op, crashed

    def _reduce_rows_vec(self, active, slot_f, slot_v, slot_op, grid):
        """(pure, pred) of a new block through the shared vectorised
        chain core (``prepare._chain_tables_vec``) with position order
        keys, restricted to the ops the block references: O(block), no
        re-scan of the settled ops. The restriction keeps class equality
        (per-op values) and the order keys' pairwise order, so the result
        is :meth:`_reduce_rows`'s."""
        part = np.unique(grid)
        part_g = part[part > 0].astype(np.int64) - 1
        pr = self._ret_pos_a[part_g]
        pi = self._inv_pos_a[part_g]
        p_crashed = pr >= _NEVER
        p_ord = np.where(p_crashed, _NEVER + 2 + pi, pr)
        loc = np.searchsorted(part_g, np.clip(slot_op, 0, None))
        slot_op_l = np.where(slot_op >= 0, loc, -1).astype(np.int32)
        return prepare._chain_tables_vec(
            active, slot_f, slot_v, slot_op_l, p_ord, p_crashed,
            op_f_ops=self._op_f_a[part_g],
            op_v_ops=self._op_v_a[part_g])

    def _tables_concat(self) -> dict[str, np.ndarray]:
        if self._tables is None:
            out = {}
            for k, blocks in self._blocks.items():
                if blocks:
                    out[k] = np.concatenate(blocks, axis=0)
                else:
                    shape = {"ret_slot": (0,), "ret_op": (0,),
                             "active": (0, self.max_window),
                             "slot_f": (0, self.max_window),
                             "slot_v": (0, self.max_window, self._vw),
                             "slot_op": (0, self.max_window),
                             "crashed": (0, self.max_window)}[k]
                    dt = bool if k in ("active", "crashed") else np.int32
                    out[k] = np.zeros(shape, dt)
            self._tables = out
        return self._tables

    # --- reduction tables on return positions -------------------------------

    def _reduce_rows(self, t: dict, lo: int, hi: int):
        """(pure, pred) of rows [lo, hi): ``prepare.reduction_tables``
        with return-position order keys (positions are order-isomorphic
        to return rows, and order is all the chain lexsort reads).
        Settled rows' inputs are final, so the result is."""
        from jepsen_tpu_torch.models import kernels as K

        active = t["active"][lo:hi]
        slot_f = t["slot_f"][lo:hi]
        slot_op = t["slot_op"][lo:hi]
        n_rows, W = active.shape
        if n_rows == 0:
            return (np.zeros((0, W), bool), np.full((0, W), -1, np.int32))
        pure = active & (slot_f == np.int32(K.F_READ))

        n_ops = len(self.ops)
        ret_pos = np.fromiter(
            (_NEVER if o.return_pos is None else o.return_pos
             for o in self.ops), np.int64, n_ops)
        inv_pos = np.fromiter((o.invoke_pos for o in self.ops),
                              np.int64, n_ops)
        slot_ret = np.where(slot_op >= 0,
                            ret_pos[np.clip(slot_op, 0, None)], _NEVER)
        slot_inv = np.where(slot_op >= 0,
                            inv_pos[np.clip(slot_op, 0, None)], 0)
        is_crashed = slot_ret >= _NEVER
        ordkey = np.where(is_crashed, _NEVER + 2 + slot_inv, slot_ret)

        slot_v = t["slot_v"][lo:hi]
        chainable = active & ~pure & (slot_op >= 0)
        sent = -1 - np.arange(W, dtype=np.int64)
        f_key = np.where(chainable,
                         (slot_f.astype(np.int64) << 1) | is_crashed,
                         sent[None, :])
        v_keys = [slot_v[:, :, k].astype(np.int64)
                  for k in range(slot_v.shape[2])]
        order = np.lexsort(tuple([ordkey] + v_keys[::-1] + [f_key]),
                           axis=1)
        f_s = np.take_along_axis(f_key, order, axis=1)
        same = f_s[:, 1:] == f_s[:, :-1]
        for vk in v_keys:
            v_s = np.take_along_axis(vk, order, axis=1)
            same &= v_s[:, 1:] == v_s[:, :-1]
        pred = np.full((n_rows, W), -1, np.int32)
        np.put_along_axis(pred, order[:, 1:],
                          np.where(same, order[:, :-1], -1).astype(np.int32),
                          axis=1)
        return pure, pred

    def reduction_tables(self):
        if self._red_cache is None:
            W = max(1, self.max_used)
            if self._red_blocks:
                pure = np.concatenate(
                    [b[0][:, :W] for b in self._red_blocks], axis=0)
                pred = np.concatenate(
                    [b[1][:, :W] for b in self._red_blocks], axis=0)
            else:
                pure = np.zeros((0, W), bool)
                pred = np.full((0, W), -1, np.int32)
            self._red_cache = (pure, pred)
        return self._red_cache

    # --- views --------------------------------------------------------------

    def packed(self) -> PackedHistory:
        """A PackedHistory of the settled prefix: a fresh object (per-
        object caches rebuild against the grown window and interner) with
        the reduction-table cache injected."""
        if not self.incremental:
            raise UnsupportedHistory(
                f"model {type(self.model).__name__} has no streaming "
                f"kernel formulation (buffer mode)")
        t = self._tables_concat()
        W = max(1, self.max_used)
        p = PackedHistory(
            model=self.model, kernel=self.kernel, ops=self.ops,
            window=W, R=self.R, ret_slot=t["ret_slot"],
            ret_op=t["ret_op"], active=t["active"][:, :W],
            slot_f=t["slot_f"][:, :W], slot_v=t["slot_v"][:, :W],
            slot_op=t["slot_op"][:, :W], crashed=t["crashed"][:, :W],
            init_state=self.init_state, intern=self.intern.ids,
            unintern=self.intern.values,
            crashed_ops=[o for o in self.ops if o.return_pos is None])
        # Recomputing with prepare.reduction_tables here would take a
        # resolved op whose return row is not assigned yet for a crashed
        # one, and corrupt the canonical chains.
        p._reduction_tables = self.reduction_tables()
        return p

    def prefix_fingerprint(self, row: int) -> str:
        """The identity of the settled row prefix [0, row) for a stream
        checkpoint: the same for any session fed the same events in the
        same order, wherever its settles fell (rows are hashed at the
        full width, which a later window never rewrites), and the JAX
        package's digest of the same events."""
        t = self._tables_concat()
        h = hashlib.sha256()
        kname = self.kernel.name if self.kernel is not None else None
        h.update(f"stream|{kname}|{row}".encode())
        h.update(np.ascontiguousarray(self.init_state).tobytes())
        for k in ("ret_slot", "ret_op", "active", "slot_f", "slot_v",
                  "crashed"):
            arr = np.ascontiguousarray(t[k][:row])
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        return h.hexdigest()
