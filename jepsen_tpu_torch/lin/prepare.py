"""Host-side history packing for the linearizability search.

Converts a history (invoke/ok/fail/info ops) into the int-array form the
CPU oracle and the device engine consume:

1. **Pairing** — each invocation is matched with the next completion by
   the same process. ``fail`` ops are removed (they did not happen);
   ``info`` ops (crashed) stay concurrent with everything after them and
   may linearize at any later point, or never.
2. **Crashed-read elision** — a crashed read constrains nothing.
3. **Slot assignment** — the linearized-op bitset only needs bits for
   pending ops. Slots are recycled when an op returns, so the bitset
   width is the concurrency window, not the history length.
4. **Value interning** — op values become dense int ids shared with model
   states; ``None`` maps to NIL.
5. **Return-event table** — the frontier only changes at completions, so
   the search iterates over R = #ok-ops rows, each carrying the
   returning slot and the snapshot of active slots with their (f, value).

Three walks compute the same tables, bit for bit, and the JAX
package's :func:`jepsen_tpu.lin.prepare.prepare` gives them too. The
history picks the walk; ``JEPSEN_TPU_FAST_PACK`` (the JAX package's knob,
read per call, default on) picks the spec path:

- ``native`` (default for two value words: every register, cas-register
  and mutex kernel, and kernel-less histories): the vectorised pairing
  and interning (:func:`_pair_ops_vec_arrays`, :func:`_kernelize_vec`),
  then the slot walk in C++ (``csrc/history_pack.cc`` through
  :mod:`jepsen_tpu_torch.native_ext`, built with the host compiler at
  first use; a failed build raises), the faster walk there
  (``chip_smoke.py``'s phase 22 times both);
- ``vec`` (default for other value widths): the same columns, then the
  slot walk as numpy sort / cumsum / searchsorted passes
  (:func:`_pack_events_vec`);
- ``py`` (``JEPSEN_TPU_FAST_PACK=0``): the Python spec walk
  (:func:`pair_ops`, :func:`_kernelize`, :func:`_pack_events_py`), the
  executable reference.

With the knob on, :func:`reduction_tables` builds the canonical chains on
one rank-compressed key a slot (:func:`_chain_tables_vec`).
:func:`pack_stats` says which walk ran last.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from operator import attrgetter
from typing import Any, Callable

import numpy as np

from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch.history import FAIL as H_FAIL
from jepsen_tpu_torch.history import INFO, INVOKE, OK, Op
from jepsen_tpu_torch.models import kernels as K
from jepsen_tpu_torch.models.kernels import (F_IDS, NIL, VALUE_WIDTH,
                                             KernelModel, kernel_for)


def fast_pack_enabled() -> bool:
    """``JEPSEN_TPU_FAST_PACK``: the vectorised columns and the native or
    numpy slot walk (default on; ``=0`` takes the Python spec walk). Read
    per call."""
    return os.environ.get("JEPSEN_TPU_FAST_PACK", "") != "0"


# The pack meter: cumulative wall seconds and calls this process (one-shot
# packs, reduction tables, and the stream packer's settles,
# ``jepsen_tpu_torch.stream.incr``), and the walk the last pack took
# ("vec", "native", "py"; "dev" after the device packer).
_pack_stats = {"prepare_s": 0.0, "prepare_calls": 0,
               "reduction_s": 0.0, "reduction_calls": 0,
               "incr_s": 0.0, "incr_calls": 0, "mode": ""}


def pack_stats() -> dict:
    """A snapshot of the pack meter."""
    return dict(_pack_stats)


def reset_pack_stats() -> None:
    for k in _pack_stats:
        _pack_stats[k] = "" if k == "mode" else (0.0 if k.endswith("_s")
                                                 else 0)


class UnsupportedHistory(Exception):
    """Raised when a history cannot be packed. ``kind`` is "window" for a
    concurrency-window overflow, "other" otherwise; callers branch on it,
    never on the message."""

    def __init__(self, message: str, kind: str = "other"):
        super().__init__(message)
        self.kind = kind


@dataclass
class LinOp:
    """One logical operation (invocation + optional completion)."""

    op_index: int           # index of the invocation in the history
    process: Any
    f: str
    value: Any              # semantic value: completion value for ok reads
    ok: bool                # True if completed ok; False if crashed (info)
    invoke_pos: int         # position of invocation event
    return_pos: int | None  # position of ok completion event, None if crashed


@dataclass
class PackedHistory:
    """Dense arrays driving the frontier search; see module docstring."""

    model: Any                   # the Python model (semantic reference)
    kernel: KernelModel | None   # step kernel, None if model unsupported
    ops: list[LinOp]             # logical ops (reporting / witnesses)
    window: int                  # W = bitset width in use
    R: int                       # number of return events
    ret_slot: np.ndarray         # i32[R]   slot of the returning op
    ret_op: np.ndarray           # i32[R]   index into ops of the returner
    active: np.ndarray           # bool[R,W] slots invoked & unreturned
    slot_f: np.ndarray           # i32[R,W] function id per active slot
    slot_v: np.ndarray           # i32[R,W,VALUE_WIDTH] interned values
    slot_op: np.ndarray          # i32[R,W] index into ops per active slot
    crashed: np.ndarray          # bool[R,W] active slot holds a crashed op
    init_state: np.ndarray       # i32[S]
    intern: dict                 # value -> id
    unintern: list               # id -> value
    crashed_ops: list[LinOp]     # info ops pending at end (never linearized)

    @property
    def state_width(self) -> int:
        return len(self.init_state)


MAX_WINDOW = 64


def _semantic_value(f: str, invoke: Op, completion: Op | None) -> Any:
    """Reads (and dequeues) are checked against what they observed;
    mutations against what they requested."""
    if f == "read":
        return completion.value if (completion is not None
                                    and completion.is_ok) else None
    if f == "dequeue" and completion is not None and completion.is_ok \
            and completion.value is not None:
        return completion.value
    return invoke.value


def pair_ops(history: list[Op]) -> list[LinOp]:
    """Match invocations with completions; drop failed ops and crashed
    reads. Dangling invocations at the end of history count as crashed."""
    ops: list[LinOp] = []
    pending: dict[Any, tuple[int, Op]] = {}
    for pos, op in enumerate(history):
        if op.process == "nemesis" or op.f in ("start", "stop"):
            continue
        if op.is_invoke:
            if op.process in pending:
                raise UnsupportedHistory(
                    f"process {op.process} invoked twice without completing "
                    f"(positions {pending[op.process][0]} and {pos})")
            pending[op.process] = (pos, op)
        elif op.process in pending:
            ipos, inv = pending.pop(op.process)
            if op.is_fail:
                continue
            ok = op.is_ok
            ops.append(LinOp(
                op_index=inv.index if inv.index is not None else ipos,
                process=op.process, f=inv.f,
                value=_semantic_value(inv.f, inv, op),
                ok=ok, invoke_pos=ipos,
                return_pos=pos if ok else None))
    for proc, (ipos, inv) in pending.items():
        ops.append(LinOp(
            op_index=inv.index if inv.index is not None else ipos,
            process=proc, f=inv.f,
            value=_semantic_value(inv.f, inv, None),
            ok=False, invoke_pos=ipos, return_pos=None))
    ops = [o for o in ops if o.ok or o.f != "read"]
    ops.sort(key=lambda o: o.invoke_pos)
    return ops


_TYPE_CODE = {INVOKE: 0, OK: 1, H_FAIL: 2, INFO: 3}


def _pair_ops_vec_arrays(history: list[Op]):
    """The vectorised :func:`pair_ops`: the same LinOp list (same order,
    same ops, same errors). The pending-dict walk becomes a stable sort by
    (process, time): within one process the events that count alternate
    invoke / completion, so a completion pairs with its invocation exactly
    when the process's previous event is an invoke, and an invoke after an
    invoke is the double-invoke error. Returns ``(ops, invoke_pos,
    return_pos, ok)``, the last three as arrays (return_pos -1 for a
    crashed op)."""
    empty = ([], np.zeros(0, np.int32), np.zeros(0, np.int32),
             np.zeros(0, bool))
    n_ev = len(history)
    if n_ev == 0:
        return empty
    get_code = _TYPE_CODE.get
    tc = np.frombuffer(
        bytes(get_code(t, 4) for t in map(attrgetter("type"), history)),
        np.int8)
    fs = list(map(attrgetter("f"), history))
    # Processes and fs to dense ids (any hashables).
    pmap: dict = {}
    pids = np.fromiter((pmap.setdefault(op.process, len(pmap))
                        for op in history), np.int64, n_ev)
    fmap: dict = {}
    fids = np.fromiter((fmap.setdefault(f, len(fmap)) for f in fs),
                       np.int64, n_ev)
    keep = np.ones(n_ev, bool)
    nem = pmap.get("nemesis")
    if nem is not None:
        keep &= pids != nem
    for excl in ("start", "stop"):
        fe = fmap.get(excl)
        if fe is not None:
            keep &= fids != fe
    idx = np.flatnonzero(keep)
    if idx.size == 0:
        return empty
    # Grouped by process, in time order within a group (stable).
    g = idx[np.argsort(pids[idx], kind="stable")]
    pid_s = pids[g]
    tc_s = tc[g]
    first = np.empty(len(g), bool)
    first[0] = True
    first[1:] = pid_s[1:] != pid_s[:-1]
    prev_invoke = np.zeros(len(g), bool)
    prev_invoke[1:] = (tc_s[:-1] == 0) & ~first[1:]
    dbl = (tc_s == 0) & prev_invoke
    if dbl.any():
        j = np.flatnonzero(dbl)
        jj = j[np.argmin(g[j])]          # the earliest second invoke
        p1, p2 = int(g[jj - 1]), int(g[jj])
        raise UnsupportedHistory(
            f"process {history[p2].process} invoked twice without "
            f"completing (positions {p1} and {p2})")
    paired = (tc_s != 0) & prev_invoke & (tc_s != 2)   # fails drop
    last = np.empty(len(g), bool)
    last[-1] = True
    last[:-1] = first[1:]
    dangling = (tc_s == 0) & last                      # pending at end
    pj = np.flatnonzero(paired)
    ipos = np.concatenate([g[pj - 1], g[np.flatnonzero(dangling)]])
    cpos = np.concatenate([g[pj], np.full(int(dangling.sum()), -1,
                                          g.dtype)])
    okc = np.concatenate([tc_s[pj] == 1,               # ok completions
                          np.zeros(int(dangling.sum()), bool)])
    # Crashed reads constrain nothing: dropped here, so the loop below
    # is one op per array entry.
    rf = fmap.get("read")
    if rf is not None:
        keep2 = okc | (fids[ipos] != rf)
        ipos, cpos, okc = ipos[keep2], cpos[keep2], okc[keep2]
    order = np.argsort(ipos, kind="stable")
    ipos, cpos, okc = ipos[order], cpos[order], okc[order]
    ops: list[LinOp] = []
    app = ops.append
    H = history
    new = LinOp.__new__
    for ip, cp, ok in zip(ipos.tolist(), cpos.tolist(), okc.tolist()):
        inv = H[ip]
        f = inv.f
        if f == "read":                  # ok is always True here
            value = H[cp].value
        elif f == "dequeue" and ok:
            cv = H[cp].value
            value = cv if cv is not None else inv.value
        else:
            value = inv.value
        o = new(LinOp)
        o.__dict__ = {
            "op_index": inv.index if inv.index is not None else ip,
            "process": inv.process, "f": f, "value": value, "ok": ok,
            "invoke_pos": ip, "return_pos": cp if ok else None}
        app(o)
    return (ops, ipos.astype(np.int32, copy=False),
            np.where(okc, cpos, -1).astype(np.int32, copy=False), okc)


class _Interner:
    def __init__(self):
        self.ids: dict = {}
        self.values: list = []

    def __call__(self, v) -> int:
        if v is None:
            return int(NIL)
        try:
            key = v
            hash(key)
        except TypeError:
            key = repr(v)
        if key not in self.ids:
            self.ids[key] = len(self.values)
            self.values.append(v)
        return self.ids[key]


def _op_f_and_values(o: LinOp, intern: _Interner) -> tuple[int, list[int]]:
    if o.f not in F_IDS:
        raise UnsupportedHistory(f"unknown op f={o.f!r} for device packing")
    f_id = F_IDS[o.f]
    v = [int(NIL)] * VALUE_WIDTH
    if o.f == "cas":
        if not isinstance(o.value, (list, tuple)) or len(o.value) != 2:
            raise UnsupportedHistory(f"cas value must be a pair: {o.value!r}")
        v[0] = intern(o.value[0])
        v[1] = intern(o.value[1])
    elif o.f in ("read", "write"):
        v[0] = intern(o.value)
    return f_id, v


# Device-formulation size bounds: a history past them gets no kernel
# (kernel None), and the generic CPU search decides it.
MAX_SET_WORDS = 16        # 16 x 31 = 496 distinct set elements
MAX_QUEUE_VALUES = 32     # distinct unordered-queue values (state width)
MAX_FIFO_CAP = 31         # fifo depth bound (state width 32)


def _max_queue_depth(ops: list[LinOp], n_initial: int) -> int:
    """Upper bound on FIFO depth over every possible linearization: at any
    event position t, at most the enqueues invoked by t have linearized,
    and at least the ok dequeues returned by t have."""
    events = []
    for o in ops:
        if o.f == "enqueue":
            events.append((o.invoke_pos, 1))
        elif o.f == "dequeue" and o.return_pos is not None:
            events.append((o.return_pos, -1))
    events.sort()
    depth = peak = n_initial
    for _, d in events:
        depth += d
        peak = max(peak, depth)
    return peak


def _no_kernel(n: int):
    return (None, np.array([0], np.int32), np.zeros(n, np.int32),
            np.full((n, VALUE_WIDTH), int(NIL), np.int32))


def _kernelize(model, ops: list[LinOp], intern: _Interner):
    """The step kernel sized for this history plus the per-op interned
    (f, value-words) tables: ``(kernel, init_state, op_f, op_v)``. kernel
    is None when the model, or this history, has no packed formulation;
    the generic CPU search then decides it. Set and queue kernels are
    sized from the history (element count, value count, queue depth
    bound), so their state width depends on the data."""
    n = len(ops)

    def tables(vw):
        return (np.zeros(n, np.int32),
                np.full((n, vw), int(NIL), np.int32))

    if isinstance(model, (model_ns.CASRegister, model_ns.Register,
                          model_ns.Mutex)):
        kernel = kernel_for(model)
        if isinstance(model, model_ns.Mutex):
            init_state = kernel.init_state()
        else:
            init_state = np.array([intern(model.value)], np.int32)
        op_f, op_v = tables(kernel.value_width)
        for i, o in enumerate(ops):
            f_id, v = _op_f_and_values(o, intern)
            op_f[i] = f_id
            op_v[i] = v
        return kernel, init_state, op_f, op_v

    if isinstance(model, model_ns.SetModel):
        if any(o.f not in F_IDS for o in ops) or \
                any(o.f == "add" and o.value is None for o in ops) or \
                any(e is None for e in model.s):
            return _no_kernel(n)
        # Dense element ids: initial elements first, then history order.
        initial_ids = [intern(e) for e in sorted(model.s, key=repr)]
        for o in ops:
            if o.f == "add":
                intern(o.value)
            elif o.f == "read":
                try:
                    for e in (o.value if o.value is not None else ()):
                        intern(e)
                except TypeError:
                    pass
        n_elements = max(1, len(intern.values))
        n_words = -(-n_elements // K.SET_BITS)
        if n_words > MAX_SET_WORDS:
            return _no_kernel(n)
        kernel = K.set_kernel(n_elements, initial_ids)
        op_f, op_v = tables(kernel.value_width)
        for i, o in enumerate(ops):
            op_f[i] = F_IDS[o.f]
            if o.f == "add":
                op_v[i, 0] = intern(o.value)
            elif o.f == "read":
                try:
                    elems = [intern(e) for e in o.value] \
                        if o.value is not None else None
                except TypeError:
                    elems = None
                if elems is not None and int(NIL) in elems:
                    # A None element is never in the state (nil adds were
                    # refused above), so this read never matches.
                    elems = None
                if elems is not None:
                    # The observed mask; all-NIL (never matches) when the
                    # read's value is not a collection.
                    op_v[i, :n_words] = 0
                    for e in elems:
                        op_v[i, e // K.SET_BITS] |= np.int32(
                            1 << (e % K.SET_BITS))
        return kernel, kernel.init_state(), op_f, op_v

    if isinstance(model, (model_ns.UnorderedQueue, model_ns.FIFOQueue)):
        initial = list(model.pending)
        if any(o.f not in F_IDS for o in ops) \
                or any(v is None for v in initial) \
                or any(o.f == "enqueue" and o.value is None for o in ops):
            return _no_kernel(n)
        initial_ids = [intern(v) for v in initial]
        for o in ops:
            if o.f in ("enqueue", "dequeue") and o.value is not None:
                intern(o.value)
        if isinstance(model, model_ns.FIFOQueue):
            depth = _max_queue_depth(ops, len(initial))
            if depth > MAX_FIFO_CAP:
                return _no_kernel(n)
            kernel = K.fifo_queue_kernel(max(1, depth), initial_ids)
        else:
            n_values = max(1, len(intern.values))
            enq_ids = initial_ids + [intern(o.value) for o in ops
                                     if o.f == "enqueue"]
            if len(set(enq_ids)) == len(enq_ids):
                # Every enqueued value distinct: the pending multiset is a
                # set, packed as a bitmask (31 values a word).
                n_words = -(-n_values // K.SET_BITS)
                if n_words > MAX_SET_WORDS:
                    return _no_kernel(n)
                kernel = K.unordered_unique_kernel(n_values, initial_ids)
            elif n_values <= MAX_QUEUE_VALUES:
                kernel = K.unordered_queue_kernel(n_values, initial_ids)
            else:
                return _no_kernel(n)
        op_f, op_v = tables(kernel.value_width)
        for i, o in enumerate(ops):
            op_f[i] = F_IDS[o.f]
            if o.f in ("enqueue", "dequeue"):
                # A nil dequeue interns to NIL, which is never legal: the
                # Python models' verdict too (nil enqueues were refused).
                op_v[i, 0] = intern(o.value)
        return kernel, kernel.init_state(), op_f, op_v

    return _no_kernel(n)


def _kernelize_vec(model, ops: list[LinOp], intern: _Interner):
    """The vectorised :func:`_kernelize` for register, cas-register and
    mutex over int-or-None values: the first-occurrence interner becomes
    one ``np.unique`` and an argsort. Returns what :func:`_kernelize`
    returns, or None for another model or value domain (the caller then
    takes :func:`_kernelize`)."""
    if not isinstance(model, (model_ns.CASRegister, model_ns.Register,
                              model_ns.Mutex)):
        return None
    n = len(ops)
    fs = [o.f for o in ops]
    get = F_IDS.get
    op_f = np.fromiter((get(f, -1) for f in fs), np.int64, n) \
        if n else np.zeros(0, np.int64)
    bad = np.flatnonzero(op_f < 0)
    if bad.size:
        raise UnsupportedHistory(
            f"unknown op f={fs[int(bad[0])]!r} for device packing")
    kernel = kernel_for(model)
    # The intern calls in the order the spec loop makes them: model.value
    # first (registers), then per op, by np.repeat over each op's count
    # of value words (cas 2, read / write 1, else 0), with a fix-up loop
    # over the cas ops alone.
    f_cas = F_IDS.get("cas", -9)
    f_read = F_IDS.get("read", -9)
    f_write = F_IDS.get("write", -9)
    is_cas = op_f == f_cas
    ent = is_cas * 2 + ((op_f == f_read) | (op_f == f_write))
    tgt_i_ops = np.repeat(np.arange(n, dtype=np.int64), ent)
    m_ops = len(tgt_i_ops)
    tgt_w_ops = np.zeros(m_ops, np.int64)
    starts = np.cumsum(ent) - ent        # each op's first entry
    ci = np.flatnonzero(is_cas)
    tgt_w_ops[starts[ci] + 1] = 1        # a cas's second word
    vlist = [o.value for o in ops]
    arr = np.empty(n, object)
    arr[:] = vlist
    seq = np.repeat(arr, ent).tolist()   # a cas's entries hold the pair:
    for j, i in zip(starts[ci].tolist(), ci.tolist()):
        v = vlist[i]
        if not isinstance(v, (list, tuple)) or len(v) != 2:
            raise UnsupportedHistory(
                f"cas value must be a pair: {v!r}")
        seq[j] = v[0]
        seq[j + 1] = v[1]
    if isinstance(model, model_ns.Mutex):
        tgt_i = tgt_i_ops
        tgt_w = tgt_w_ops
    else:
        seq.insert(0, model.value)
        tgt_i = np.concatenate([np.full(1, -1, np.int64), tgt_i_ops])
        tgt_w = np.concatenate([np.zeros(1, np.int64), tgt_w_ops])
    m = len(seq)
    flags = bytearray(m)                 # 1 where seq[j] is an int
    vals_list: list = []
    vapp = vals_list.append
    lo, hi = -(1 << 62), 1 << 62
    for j, v in enumerate(seq):
        if v is None:
            continue
        if type(v) is not int or v < lo or v >= hi:
            return None                  # not the int domain
        flags[j] = 1
        vapp(v)
    ids_all = np.full(m, int(NIL), np.int64)
    nn = np.frombuffer(bytes(flags), bool)
    vals = np.array(vals_list, np.int64) \
        if vals_list else np.zeros(0, np.int64)
    if vals.size:
        uniq, first, inverse = np.unique(vals, return_index=True,
                                         return_inverse=True)
        rank = np.argsort(first, kind="stable")   # first-occurrence order
        idmap = np.empty(len(uniq), np.int64)
        idmap[rank] = np.arange(len(uniq))
        ids_all[nn] = idmap[inverse]
        intern.values = uniq[rank].tolist()
        intern.ids = {v: i for i, v in enumerate(intern.values)}
    op_v = np.full((n, kernel.value_width), int(NIL), np.int32)
    ti = np.asarray(tgt_i, np.int64)
    tw = np.asarray(tgt_w, np.int64)
    opm = ti >= 0
    op_v[ti[opm], tw[opm]] = ids_all[opm].astype(np.int32)
    if isinstance(model, model_ns.Mutex):
        init_state = kernel.init_state()
    else:
        init_state = np.array([int(ids_all[0])], np.int32)
    return kernel, init_state, op_f.astype(np.int32), op_v


def _pack_events_vec(invoke_pos, return_pos, op_f, op_v, max_window,
                     fill_fv, R):
    """The vectorised packing walk. The LIFO free list becomes sort and
    cumsum passes: an invoke pops the most recently freed slot, so returns
    are opens and invokes closes, and bracket matching pairs each invoke
    that reuses a slot with the return that freed it (within one stack
    level, opens and closes alternate). Fresh invokes (those popping the
    virgin region: the new minima of the running return-minus-invoke sum)
    take slots 0, 1, 2 ... in order; slots propagate along reuse chains by
    pointer doubling, and the R x W tables are painted as per-op row
    intervals (a cumsum of endpoint deltas). Its tables are
    :func:`_pack_events_py`'s, at the used width."""
    n = len(invoke_pos)
    vw = op_v.shape[1]
    nil = int(NIL)
    has_ret = return_pos >= 0
    ret_ids = np.flatnonzero(has_ret)
    ev_pos = np.concatenate([np.asarray(invoke_pos, np.int64),
                             np.asarray(return_pos, np.int64)[ret_ids]])
    ev_op = np.concatenate([np.arange(n, dtype=np.int64), ret_ids])
    n_inv = n
    order = np.argsort(ev_pos, kind="stable")   # positions are distinct
    kind_ret = order >= n_inv
    op_s = ev_op[order]
    delta = np.where(kind_ret, -1, 1)
    depth = np.cumsum(delta)
    W_used = int(depth.max(initial=0))
    if W_used > max_window:
        t = int(np.flatnonzero(depth > max_window)[0])
        raise UnsupportedHistory(
            f"concurrency window exceeds {max_window} pending ops "
            f"at history position {int(ev_pos[order[t]])}", kind="window")
    W = max(1, W_used)
    slot = np.zeros(n, np.int32)
    if n:
        # Fresh invokes: the free stack is empty exactly when the
        # return-minus-invoke running sum reaches a new minimum.
        sigma = np.cumsum(-delta)
        runmin = np.minimum.accumulate(np.minimum(sigma, 0))
        prev_runmin = np.empty_like(runmin)
        prev_runmin[0] = 0
        prev_runmin[1:] = runmin[:-1]
        fresh = (~kind_ret) & (sigma < prev_runmin)
        fresh_ops = op_s[fresh]
        slot_root = np.full(n, -1, np.int32)
        slot_root[fresh_ops] = np.arange(len(fresh_ops), dtype=np.int32)
        # Bracket-match the reusing invokes to the returns they reuse.
        sub = kind_ret | ((~kind_ret) & ~fresh)
        si = np.flatnonzero(sub)
        lev = sigma - runmin             # stack size after the event
        lv = np.where(kind_ret[si], lev[si], lev[si] + 1)
        so = np.argsort(lv, kind="stable")
        ss = si[so]
        lvs = lv[so]
        run_first = np.empty(len(ss), bool)
        if len(ss):
            run_first[0] = True
            run_first[1:] = lvs[1:] != lvs[:-1]
        base = np.maximum.accumulate(
            np.where(run_first, np.arange(len(ss)), 0))
        rank = np.arange(len(ss)) - base
        mpair = rank % 2 == 1            # a close at odd rank matches prev
        parent = np.arange(n, dtype=np.int64)
        parent[op_s[ss[mpair]]] = op_s[ss[np.flatnonzero(mpair) - 1]]
        while True:
            pp = parent[parent]
            if np.array_equal(pp, parent):
                break
            parent = pp
        slot = slot_root[parent]
    ret_op = op_s[kind_ret].astype(np.int32)
    ret_slot = slot[ret_op]
    # Row intervals: op i is active in rows [r0, r1) at column slot[i].
    ret_pos_sorted = ev_pos[order[kind_ret]]
    r0 = np.searchsorted(ret_pos_sorted, np.asarray(invoke_pos, np.int64))
    r1 = np.full(n, R, np.int64)
    r1[ret_op] = np.arange(R) + 1
    # Column-major paint (cumsum along the contiguous axis) of op id + 1.
    occ = np.zeros((W, R + 1), np.int32)
    flat = occ.reshape(-1)
    col = slot.astype(np.int64)
    ids1 = np.arange(1, n + 1, dtype=np.int32)
    np.add.at(flat, col * (R + 1) + r0, ids1)
    np.subtract.at(flat, col * (R + 1) + r1, ids1)
    np.cumsum(occ, axis=1, out=occ)
    grid = np.ascontiguousarray(occ[:, :R].T)    # (R, W) op id + 1
    active = grid != 0
    slot_op = grid - 1
    if fill_fv:
        # slot_op is -1 at inactive cells: a sentinel row appended to the
        # per-op tables makes the plain gather land on the inactive fill
        # values there.
        op_f_ext = np.concatenate([op_f.astype(np.int32, copy=False),
                                   np.zeros(1, np.int32)])
        op_v_ext = np.concatenate([op_v.astype(np.int32, copy=False),
                                   np.full((1, vw), nil, np.int32)])
        slot_f = op_f_ext[slot_op]
        slot_v = op_v_ext[slot_op]
    else:
        slot_f = np.zeros((R, W), np.int32)
        slot_v = np.full((R, W, vw), nil, np.int32)
    return ret_slot, ret_op, active, slot_f, slot_v, slot_op, W_used


def _pack_events_native(invoke_pos, return_pos, op_f, op_v, max_window,
                        fill_fv, R):
    """The packing walk in C++ (``csrc/history_pack.cc``), two value words.
    Raises when the library does not build or load."""
    from jepsen_tpu_torch import native_ext

    try:
        return native_ext.pack_events(
            invoke_pos, return_pos, op_f, op_v[:, 0], op_v[:, 1],
            nil_value=int(NIL), max_window=max_window,
            fill_fv=fill_fv, R=R)
    except native_ext.WindowOverflow as e:
        raise UnsupportedHistory(
            f"concurrency window exceeds {max_window} pending ops "
            f"at history position {e.pos}", kind="window") from None


def pack_events(invoke_pos, return_pos, op_f, op_v, max_window, fill_fv,
                R):
    """The slot walk: ``(tables, walk)``, the tables as
    :func:`_pack_events_py` returns them (at least the used width) and
    the walk, "native" for two value words, "vec" for other widths, "py"
    with ``JEPSEN_TPU_FAST_PACK=0``."""
    args = (invoke_pos, return_pos, op_f, op_v, max_window, fill_fv, R)
    if not fast_pack_enabled():
        return _pack_events_py(*args), "py"
    if op_v.shape[1] == 2:
        return _pack_events_native(*args), "native"
    return _pack_events_vec(*args), "vec"


def _pack_events_py(invoke_pos, return_pos, op_f, op_v, max_window,
                    fill_fv, R):
    """The packing walk: slots from a LIFO free list, one table row per
    ok return."""
    n = len(invoke_pos)
    W_alloc = max_window
    vw = op_v.shape[1]
    ret_slot = np.zeros(R, np.int32)
    ret_op = np.zeros(R, np.int32)
    active = np.zeros((R, W_alloc), bool)
    slot_f = np.zeros((R, W_alloc), np.int32)
    slot_v = np.full((R, W_alloc, vw), int(NIL), np.int32)
    slot_op = np.full((R, W_alloc), -1, np.int32)

    # Event stream over op endpoints: (pos, kind, op_id); positions are
    # distinct, so an invoke and a return never tie.
    events: list[tuple[int, int, int]] = []
    for i in range(n):
        events.append((int(invoke_pos[i]), 0, i))
        if return_pos[i] >= 0:
            events.append((int(return_pos[i]), 1, i))
    events.sort()

    free = list(range(W_alloc))[::-1]
    slot_of: dict[int, int] = {}
    cur_active: dict[int, int] = {}   # slot -> op id
    max_used = 0
    r = 0
    for pos, kind, i in events:
        if kind == 0:  # invoke
            if not free:
                raise UnsupportedHistory(
                    f"concurrency window exceeds {max_window} pending ops "
                    f"at history position {pos}", kind="window")
            s = free.pop()
            slot_of[i] = s
            cur_active[s] = i
            max_used = max(max_used, s + 1)
        else:  # ok return
            s = slot_of[i]
            ret_slot[r] = s
            ret_op[r] = i
            for slot, op_id in cur_active.items():
                active[r, slot] = True
                slot_op[r, slot] = op_id
                if fill_fv:
                    slot_f[r, slot] = op_f[op_id]
                    slot_v[r, slot] = op_v[op_id]
            r += 1
            del cur_active[s]
            del slot_of[i]
            free.append(s)
    return ret_slot, ret_op, active, slot_f, slot_v, slot_op, max_used


def _columns(model, history: list):
    """Pairing and kernelizing, vectorised or spec by
    ``JEPSEN_TPU_FAST_PACK``: the columns every walk starts from,
    ``(ops, kernel, init_state, op_f, op_v, intern, invoke_pos,
    return_pos, R, crashed_ops, ok_col)`` (``ok_col`` None on the spec
    pairing)."""
    fast = fast_pack_enabled()
    ok_col = None
    if fast:
        ops, invoke_pos, return_pos, ok_col = _pair_ops_vec_arrays(history)
    else:
        ops = pair_ops(history)
    intern = _Interner()
    kv = _kernelize_vec(model, ops, intern) if fast else None
    if kv is None:
        kernel, init_state, op_f, op_v = _kernelize(model, ops, intern)
    else:
        kernel, init_state, op_f, op_v = kv
    n = len(ops)
    if ok_col is not None:
        R = int(ok_col.sum())
        crashed = [ops[i] for i in np.flatnonzero(~ok_col).tolist()]
    else:
        R = sum(1 for o in ops if o.ok)
        invoke_pos = np.fromiter((o.invoke_pos for o in ops), np.int32, n)
        return_pos = np.fromiter(
            (-1 if o.return_pos is None else o.return_pos for o in ops),
            np.int32, n)
        crashed = [o for o in ops if o.return_pos is None]
    return (ops, kernel, init_state, op_f, op_v, intern, invoke_pos,
            return_pos, R, crashed, ok_col)


def prepare(model, history, max_window: int = MAX_WINDOW) -> PackedHistory:
    """Pack a history for the frontier search. See module docstring: the
    history's value width and ``JEPSEN_TPU_FAST_PACK`` pick the walk, and
    every walk gives the same tables."""
    t_start = time.perf_counter()
    (ops, kernel, init_state, op_f, op_v, intern, invoke_pos, return_pos,
     R, crashed, _) = _columns(model, list(history))
    packed, mode = pack_events(invoke_pos, return_pos, op_f, op_v,
                               max_window, kernel is not None, R)
    ret_slot, ret_op, active, slot_f, slot_v, slot_op, max_used = packed

    # Per-slot crashed mask ("this active slot's op never returns"). The
    # sentinel append makes slot_op = -1 (inactive) index a live value;
    # the & active keeps those cells False.
    ret_ext = np.concatenate([return_pos.astype(np.int32, copy=False),
                              np.zeros(1, np.int32)])
    crashed_tbl = (ret_ext[slot_op] < 0) & active

    W = max(1, max_used)
    out = PackedHistory(
        model=model, kernel=kernel, ops=ops, window=W, R=R,
        ret_slot=ret_slot, ret_op=ret_op,
        active=active[:, :W], slot_f=slot_f[:, :W],
        slot_v=slot_v[:, :W], slot_op=slot_op[:, :W],
        crashed=crashed_tbl[:, :W],
        init_state=init_state, intern=intern.ids,
        unintern=intern.values, crashed_ops=crashed)
    # The per-op tables ride along for the vectorised chain tables
    # (reduction_tables).
    out._op_fv = (op_f, op_v, invoke_pos)
    _pack_stats["prepare_s"] += time.perf_counter() - t_start
    _pack_stats["prepare_calls"] += 1
    _pack_stats["mode"] = mode
    return out


PACKED_FIELDS = ("ret_slot", "ret_op", "active", "slot_f", "slot_v",
                 "slot_op", "crashed", "init_state", "window", "R",
                 "unintern")


def packed_from_arrays(fields: dict, ops: list[LinOp],
                       model) -> PackedHistory:
    """A :class:`PackedHistory` from packed tables given as numpy arrays
    (the :data:`PACKED_FIELDS` of a history packed elsewhere, e.g. by
    the JAX package) and this package's op list for the same history."""
    missing = [k for k in PACKED_FIELDS if k not in fields]
    if missing:
        raise ValueError(f"packed fields missing: {missing}")
    unintern = list(fields["unintern"])
    intern = {}
    for i, v in enumerate(unintern):
        try:
            hash(v)
            intern[v] = i
        except TypeError:
            intern[repr(v)] = i
    arr = {k: np.array(fields[k]) for k in PACKED_FIELDS
           if k not in ("window", "R", "unintern")}
    kernel = kernel_for(model) if isinstance(
        model, (model_ns.CASRegister, model_ns.Register,
                model_ns.Mutex)) else None
    return PackedHistory(
        model=model, kernel=kernel, ops=list(ops),
        window=int(fields["window"]), R=int(fields["R"]),
        ret_slot=arr["ret_slot"].astype(np.int32),
        ret_op=arr["ret_op"].astype(np.int32),
        active=arr["active"].astype(bool),
        slot_f=arr["slot_f"].astype(np.int32),
        slot_v=arr["slot_v"].astype(np.int32),
        slot_op=arr["slot_op"].astype(np.int32),
        crashed=arr["crashed"].astype(bool),
        init_state=arr["init_state"].astype(np.int32),
        intern=intern, unintern=unintern,
        crashed_ops=[o for o in ops if o.return_pos is None])


# --- search-space reductions -------------------------------------------------
#
# Two exact (verdict- and death-row-preserving) reductions the CPU oracle
# applies:
#
# 1. **Pure-op saturation.** A read never changes state, so it need not
#    branch the search: its bit is set the first moment the config's
#    state matches.
# 2. **Canonical chains.** Two concurrently-pending identical ops (same f,
#    same value) are exchangeable. Live ops chain by return order, crashed
#    ops among themselves by invoke order; the two families never cross.
#    Slot j with an unlinearized canonical predecessor is blocked until
#    the predecessor's bit is set.


def _chain_tables_vec(active, slot_f, slot_v, slot_op, op_ordkey,
                      op_crashed, op_f_ops=None, op_v_ops=None):
    """The canonical-chain core of :func:`reduction_tables`, vectorised:
    the per-row lexsort over (class, value words, order key) becomes one
    rank-compressed key a slot (the op's class rank, lexicographic over
    (f << 1 | crashed, value words) by one sort over the ops, in the high
    bits; its order-key rank in the low bits) and one stable argsort a
    row. The key orders slots as the spec's lexsort does, so ``pred`` is
    the same.

    ``op_ordkey`` i64[n]: the op's return row, or past every row by its
    invoke position when it crashed (unique per op). ``op_crashed``
    bool[n]. ``op_f_ops`` / ``op_v_ops``: the per-op tables, recovered
    from the slot tables when None."""
    n_rows, W = active.shape
    pure = active & (slot_f == np.int32(K.F_READ))
    if n_rows == 0:
        return pure, np.full((n_rows, W), -1, np.int32)

    n = len(op_ordkey)
    if op_f_ops is None:
        # Constant per op; every op a chain references is active in
        # some row.
        op_f_ops = np.zeros(n, np.int64)
        op_v_ops = np.full((n, slot_v.shape[2]), int(NIL), np.int64)
        lin = active.ravel()
        ops_flat = slot_op.ravel()[lin]
        op_f_ops[ops_flat] = slot_f.ravel()[lin]
        op_v_ops[ops_flat] = slot_v.reshape(-1, slot_v.shape[2])[lin]
    else:
        op_f_ops = np.asarray(op_f_ops, np.int64)
        op_v_ops = np.asarray(op_v_ops, np.int64)
    cls_cols = [op_v_ops[:, k] for k in
                range(op_v_ops.shape[1] - 1, -1, -1)]
    cls_cols.append((op_f_ops << 1) | op_crashed)
    o_ops = np.lexsort(tuple(cls_cols))
    chg = np.zeros(n, bool)
    if n > 1:
        for c in cls_cols:
            cs = c[o_ops]
            chg[1:] |= cs[1:] != cs[:-1]
    # Ranks fit int32 for any n < 2^31, and int32 gathers over the
    # (R, W) grids are faster than int64 ones.
    cid_sorted = np.cumsum(chg, dtype=np.int32)
    class_rank = np.empty(n, np.int32)
    class_rank[o_ops] = cid_sorted
    n_classes = int(cid_sorted[-1]) + 1 if n else 0
    ord_rank = np.empty(n, np.int32)
    ord_rank[np.argsort(op_ordkey, kind="stable")] = np.arange(
        n, dtype=np.int32)

    ob = max(1, n).bit_length()
    cb = max(1, W + n_classes).bit_length()
    dtype = np.int32 if (ob + cb) <= 31 else np.int64
    chainable = active & ~pure & (slot_op >= 0)
    # slot_op = -1 wraps to the last op's rank: masked by ``chainable``
    # at every use below.
    cls_slot = (class_rank[slot_op] + np.int32(W)).astype(
        dtype, copy=False)
    ord_slot = ord_rank[slot_op].astype(dtype, copy=False)
    sent_cls = (W - 1 - np.arange(W, dtype=dtype))[None, :]
    key = np.where(chainable,
                   (cls_slot << np.array(ob, dtype)) | ord_slot,
                   sent_cls << np.array(ob, dtype))
    idt = np.int32 if n_rows * W < (1 << 31) else np.int64
    order = np.argsort(key, axis=1, kind="stable").astype(
        idt, copy=False)
    cls_key = np.where(chainable, cls_slot, sent_cls).astype(
        np.int32, copy=False)
    # Flat gathers and scatters in place of take/put_along_axis; row
    # permutations never collide, so the scatter is well defined.
    flat = order + (np.arange(n_rows, dtype=idt) * idt(W))[:, None]
    cs = cls_key.ravel()[flat]
    same = cs[:, 1:] == cs[:, :-1]
    pred = np.full(n_rows * W, -1, np.int32)
    pred[flat[:, 1:]] = np.where(same, order[:, :-1], np.int32(-1))
    return pure, pred.reshape(n_rows, W)


def reduction_tables(p: PackedHistory) -> tuple[np.ndarray, np.ndarray]:
    """Per-row reduction tables ``(pure, pred)`` for a packed history.

    pure: bool[R, W] — active slot holds a pure (state-preserving) op.
    pred: i32[R, W]  — canonical-chain predecessor slot (-1 when none):
    slot j may linearize in row r only once ``pred[r, j]``'s bit is set.
    Cached on the PackedHistory after first computation. With
    ``JEPSEN_TPU_FAST_PACK`` on (the default) the chains come from
    :func:`_chain_tables_vec`, else from the per-row lexsort below; both
    give the same tables.
    """
    cached = getattr(p, "_reduction_tables", None)
    if cached is not None:
        return cached

    R, W = p.active.shape
    if p.kernel is None or R == 0:
        out = (np.zeros((R, W), bool), np.full((R, W), -1, np.int32))
        p._reduction_tables = out
        return out

    t0 = time.perf_counter()
    if fast_pack_enabled():
        n = len(p.ops)
        ret_row = np.full(n, -1, np.int64)
        ret_row[np.asarray(p.ret_op)] = np.arange(R)
        fv = getattr(p, "_op_fv", (None, None))
        if len(fv) > 2:
            inv_pos = fv[2].astype(np.int64, copy=False)
        else:
            inv_pos = np.fromiter((o.invoke_pos for o in p.ops),
                                  np.int64, n)
        crashed_op = ret_row < 0
        ordkey = np.where(crashed_op, np.int64(R + 2) + inv_pos, ret_row)
        out = _chain_tables_vec(p.active, p.slot_f, p.slot_v, p.slot_op,
                                ordkey, crashed_op, fv[0], fv[1])
        p._reduction_tables = out
        _pack_stats["reduction_s"] += time.perf_counter() - t0
        _pack_stats["reduction_calls"] += 1
        return out

    pure = p.active & (p.slot_f == K.F_READ)

    # Return row per slot occurrence; crashed ops get a sentinel past any
    # row.
    NEVER = np.int32(R + 1)
    ret_row_of_op = np.full(len(p.ops), NEVER, np.int64)
    ret_row_of_op[np.asarray(p.ret_op)] = np.arange(R)
    slot_ret = np.where(p.slot_op >= 0,
                        ret_row_of_op[np.clip(p.slot_op, 0, None)], NEVER)

    # Identical live ops chain in return order; identical crashed ops in
    # invoke order (the class key carries the crashed flag).
    invoke_of_op = np.fromiter((o.invoke_pos for o in p.ops), np.int64,
                               len(p.ops))
    slot_inv = np.where(p.slot_op >= 0,
                        invoke_of_op[np.clip(p.slot_op, 0, None)], 0)
    is_crashed = slot_ret >= NEVER
    ordkey = np.where(is_crashed, np.int64(R + 2) + slot_inv, slot_ret)

    chainable = p.active & ~pure & (p.slot_op >= 0)
    sent = -1 - np.arange(W, dtype=np.int64)          # unique per column
    f_key = np.where(
        chainable,
        (p.slot_f.astype(np.int64) << 1) | is_crashed,
        sent[None, :])
    v_keys = [p.slot_v[:, :, k].astype(np.int64)
              for k in range(p.slot_v.shape[2])]

    # Row-wise canonical order: sort slots by (class, order key); equal
    # classes become adjacent runs in canonical order.
    order = np.lexsort(tuple([ordkey] + v_keys[::-1] + [f_key]), axis=1)
    f_s = np.take_along_axis(f_key, order, axis=1)
    same = f_s[:, 1:] == f_s[:, :-1]
    for vk in v_keys:
        v_s = np.take_along_axis(vk, order, axis=1)
        same &= v_s[:, 1:] == v_s[:, :-1]
    pred = np.full((R, W), -1, np.int32)
    np.put_along_axis(pred, order[:, 1:],
                      np.where(same, order[:, :-1], -1).astype(np.int32),
                      axis=1)
    out = (pure, pred)
    p._reduction_tables = out
    _pack_stats["reduction_s"] += time.perf_counter() - t0
    _pack_stats["reduction_calls"] += 1
    return out


def py_step_fn(kernel_name: str) -> Callable:
    """Python twin of the step kernels on (state tuple, f id, value ids)."""
    nil = int(NIL)

    if kernel_name in ("cas-register", "register"):
        allow_cas = kernel_name == "cas-register"

        def step(state, f, v):
            cur = state[0]
            if f == K.F_READ:
                return (v[0] == nil or v[0] == cur), state
            if f == K.F_WRITE:
                return True, (v[0],)
            if f == K.F_CAS and allow_cas:
                if v[0] == cur:
                    return True, (v[1],)
                return False, state
            return False, state

        return step

    if kernel_name == "mutex":
        def step(state, f, v):
            locked = state[0]
            if f == K.F_ACQUIRE:
                return locked == 0, (1,)
            if f == K.F_RELEASE:
                return locked == 1, (0,)
            return False, state

        return step

    if kernel_name == "set":
        def step(state, f, v):
            if f == K.F_ADD:
                e = v[0]
                if e == nil:
                    return False, state
                w, b = divmod(e, K.SET_BITS)
                s = list(state)
                s[w] |= 1 << b
                return True, tuple(s)
            if f == K.F_READ:
                return tuple(v[:len(state)]) == tuple(state), state
            return False, state

        return step

    if kernel_name == "unordered-unique":
        def step(state, f, v):
            e = v[0]
            if e == nil:
                return False, state
            w, b = divmod(e, K.SET_BITS)
            has = bool((state[w] >> b) & 1)
            if f == K.F_ENQUEUE and not has:
                s = list(state)
                s[w] |= 1 << b
                return True, tuple(s)
            if f == K.F_DEQUEUE and has:
                s = list(state)
                s[w] &= ~(1 << b)
                return True, tuple(s)
            return False, state

        return step

    if kernel_name == "unordered-queue":
        def step(state, f, v):
            e = v[0]
            if f == K.F_ENQUEUE:
                s = list(state)
                s[e] += 1
                return True, tuple(s)
            if f == K.F_DEQUEUE:
                if 0 <= e < len(state) and state[e] > 0:
                    s = list(state)
                    s[e] -= 1
                    return True, tuple(s)
                return False, state
            return False, state

        return step

    if kernel_name == "fifo-queue":
        def step(state, f, v):
            size, buf = state[0], state[1:]
            if f == K.F_ENQUEUE:
                if size >= len(buf):
                    return False, state
                s = list(buf)
                s[size] = v[0]
                return True, (size + 1, *s)
            if f == K.F_DEQUEUE:
                if size > 0 and buf[0] == v[0]:
                    return True, (size - 1, *buf[1:], 0)
                return False, state
            return False, state

        return step

    raise ValueError(f"no python step for kernel {kernel_name!r}")
