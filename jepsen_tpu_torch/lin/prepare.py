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

This is the plain Python walk (the semantics of
:func:`jepsen_tpu.lin.prepare.prepare` with ``JEPSEN_TPU_FAST_PACK=0``);
its tables are identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import kernels as K
from jepsen_tpu_torch.models.kernels import (F_IDS, NIL, VALUE_WIDTH,
                                             KernelModel, kernel_for)


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


def prepare(model, history, max_window: int = MAX_WINDOW) -> PackedHistory:
    """Pack a history for the frontier search. See module docstring."""
    history = list(history)
    ops = pair_ops(history)
    intern = _Interner()
    kernel, init_state, op_f, op_v = _kernelize(model, ops, intern)

    n = len(ops)
    R = sum(1 for o in ops if o.ok)
    invoke_pos = np.fromiter((o.invoke_pos for o in ops), np.int32, n)
    return_pos = np.fromiter(
        (-1 if o.return_pos is None else o.return_pos for o in ops),
        np.int32, n)
    ret_slot, ret_op, active, slot_f, slot_v, slot_op, max_used = \
        _pack_events_py(invoke_pos, return_pos, op_f, op_v, max_window,
                        kernel is not None, R)

    # Per-slot crashed mask ("this active slot's op never returns"). The
    # sentinel append makes slot_op = -1 (inactive) index a live value;
    # the & active keeps those cells False.
    ret_ext = np.concatenate([return_pos, np.zeros(1, np.int32)])
    crashed_tbl = (ret_ext[slot_op] < 0) & active

    W = max(1, max_used)
    return PackedHistory(
        model=model, kernel=kernel, ops=ops, window=W, R=R,
        ret_slot=ret_slot, ret_op=ret_op,
        active=active[:, :W], slot_f=slot_f[:, :W],
        slot_v=slot_v[:, :W], slot_op=slot_op[:, :W],
        crashed=crashed_tbl[:, :W],
        init_state=init_state, intern=intern.ids,
        unintern=intern.values,
        crashed_ops=[o for o in ops if o.return_pos is None])


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


def reduction_tables(p: PackedHistory) -> tuple[np.ndarray, np.ndarray]:
    """Per-row reduction tables ``(pure, pred)`` for a packed history.

    pure: bool[R, W] — active slot holds a pure (state-preserving) op.
    pred: i32[R, W]  — canonical-chain predecessor slot (-1 when none):
    slot j may linearize in row r only once ``pred[r, j]``'s bit is set.
    Cached on the PackedHistory after first computation.
    """
    cached = getattr(p, "_reduction_tables", None)
    if cached is not None:
        return cached

    R, W = p.active.shape
    if p.kernel is None or R == 0:
        out = (np.zeros((R, W), bool), np.full((R, W), -1, np.int32))
        p._reduction_tables = out
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
