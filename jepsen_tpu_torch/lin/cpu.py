"""Host reference implementation of the linearizability search (the
oracle).

The same just-in-time linearization closure the device engine runs,
written as Python set operations over ``(bitset, state)`` configs. The
frontier only changes at completion events:

    at return of op s:
        closure: repeatedly linearize any pending op legal in some config
        filter:  keep configs with s linearized
        recycle: clear s's bit so the slot can be reused

    valid iff the frontier never empties.

It races the device engine in ``competition`` and replays the failing
tail of a device verdict to build its counterexample
(:mod:`jepsen_tpu_torch.lin.witness`). A model or history with no packed
formulation (kernel None) runs :func:`check_generic`, the same search
over the Python model objects themselves.
"""

from __future__ import annotations

from typing import Any

from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.lin.prepare import (PackedHistory, py_step_fn,
                                          reduction_tables)
from jepsen_tpu_torch.models import is_inconsistent
from jepsen_tpu_torch.models.kernels import NIL, SET_BITS

MAX_REPORT_CONFIGS = 32


def _decode_bitmask(p: PackedHistory, state):
    """Elements of a SET_BITS-per-word bitmask state, uninterned."""
    return (p.unintern[w * SET_BITS + b]
            for w, word in enumerate(state)
            for b in range(SET_BITS) if (word >> b) & 1)


def decode_state(p: PackedHistory, state: tuple) -> Any:
    """Decode a packed model state back to its observable value."""
    if p.kernel is None:
        return state
    name = p.kernel.name
    if name in ("cas-register", "register"):
        return None if state[0] == int(NIL) else p.unintern[state[0]]
    if name == "mutex":
        return bool(state[0])
    if name == "set":
        return frozenset(_decode_bitmask(p, state))
    if name == "unordered-queue":
        return tuple(sorted(
            (p.unintern[i] for i, c in enumerate(state) for _ in range(c)),
            key=repr))
    if name == "unordered-unique":
        return tuple(sorted(_decode_bitmask(p, state), key=repr))
    if name == "fifo-queue":
        size = state[0]
        return tuple(p.unintern[e] for e in state[1:1 + size])
    return state


def _op_dict(o) -> dict:
    return {"process": o.process, "f": o.f, "value": o.value,
            "index": o.op_index, "ok": o.ok}


def _decode_configs(p: PackedHistory, configs, row: int | None) -> list:
    out = []
    for bits, st in list(configs)[:MAX_REPORT_CONFIGS]:
        pending = []
        if row is not None:
            for j in range(p.window):
                if p.active[row, j] and not (bits >> j) & 1:
                    pending.append(_op_dict(p.ops[int(p.slot_op[row, j])]))
        out.append({"model": decode_state(p, st), "pending": pending})
    return out


def _witness_path(p: PackedHistory, cons) -> list:
    path = []
    while cons is not None:
        op_id, cons = cons
        path.append(_op_dict(p.ops[op_id]))
    path.reverse()
    return path


def _final_paths(p: PackedHistory, seen, order) -> list:
    """For each config alive when the frontier died, its model state and
    the linearization path that reached it (from the search's anchor)."""
    if order is None:
        return []
    out = []
    for cfg in list(seen)[:MAX_REPORT_CONFIGS]:
        out.append({"model": decode_state(p, cfg[1]),
                    "path": _witness_path(p, order.get(cfg))})
    return out


class Dead(Exception):
    """Internal: the frontier emptied at row ``r``; carries the closure
    set + paths for counterexample reporting."""

    def __init__(self, r, seen, order):
        self.r, self.seen, self.order = r, seen, order


class Cancelled(Exception):
    pass


def search_rows(p: PackedHistory, configs, order, r0: int, r1: int,
                cancel=None, reduce: bool = False):
    """The closure over return events [r0, r1) from ``configs`` (a set of
    (bits, state-tuple)). Returns (configs, order) on survival; raises
    Dead at the row where the frontier empties, Cancelled on a cancel.
    ``order`` (or None to skip witness tracking) maps config -> cons list
    of op ids, anchored wherever the caller started.

    ``reduce=True`` applies the exact reductions of
    :func:`jepsen_tpu_torch.lin.prepare.reduction_tables`: the verdict and
    death row are those of the plain search; surviving config sets are
    canonical representatives, and a witness is a canonical order."""
    step = py_step_fn(p.kernel.name)
    window = p.window
    if reduce:
        pure_tbl, pred_tbl = reduction_tables(p)
    for r in range(r0, r1):
        if cancel is not None and cancel.is_set():
            raise Cancelled
        act = p.active[r]
        f_ints = p.slot_f[r].tolist()
        v_tups = [tuple(row) for row in p.slot_v[r].tolist()]
        if reduce:
            pure_r = pure_tbl[r]
            pred_r = pred_tbl[r].tolist()
            pure_mask = 0
            for j in range(window):
                if pure_r[j]:
                    pure_mask |= 1 << j

            track = order is not None

            def saturate(bits, st, path=None):
                for j in range(window):
                    if (pure_mask >> j) & 1 and not (bits >> j) & 1 \
                            and step(st, f_ints[j], v_tups[j])[0]:
                        bits |= 1 << j
                        if track:
                            path = (int(p.slot_op[r, j]), path)
                return bits, path

            if order is None:
                configs = {(saturate(b, st)[0], st) for b, st in configs}
            else:
                sat: dict = {}
                for b, st in configs:
                    b2, path2 = saturate(b, st, order[(b, st)])
                    sat.setdefault((b2, st), path2)
                configs = set(sat)
                order.update(sat)
        seen = set(configs)
        frontier = list(configs)
        while frontier:
            if cancel is not None and cancel.is_set():
                raise Cancelled
            new = []
            for ci, cfg in enumerate(frontier):
                if cancel is not None and ci % 4096 == 4095 \
                        and cancel.is_set():
                    raise Cancelled
                bits, st = cfg
                for j in range(window):
                    if act[j] and not (bits >> j) & 1:
                        if reduce and ((pure_mask >> j) & 1 or
                                       (pred_r[j] >= 0 and
                                        not (bits >> pred_r[j]) & 1)):
                            continue
                        ok, st2 = step(st, f_ints[j], v_tups[j])
                        if ok:
                            b2 = bits | (1 << j)
                            path = None if order is None else \
                                (int(p.slot_op[r, j]), order[cfg])
                            if reduce:
                                b2, path = saturate(b2, st2, path)
                            c2 = (b2, st2)
                            if c2 not in seen:
                                seen.add(c2)
                                new.append(c2)
                                if order is not None:
                                    order[c2] = path
            frontier = new
        survivors, new_order = _return_filter(seen, order,
                                              int(p.ret_slot[r]))
        if not survivors:
            raise Dead(r, seen, order)
        order = new_order
        configs = survivors
    return configs, order


def _return_filter(seen, order, s: int):
    """The return of slot ``s``: the configs of ``seen`` that linearized
    it, with its bit cleared, and their paths (None when ``order`` is).
    The order is rebuilt from scratch: after clearing the returned bit a
    survivor's key can collide with a closure config that never
    linearized the returner, whose path would be a wrong witness."""
    mask = 1 << s
    survivors = set()
    new_order: dict | None = {} if order is not None else None
    for cfg in seen:
        bits, st = cfg
        if bits & mask:
            c2 = (bits & ~mask, st)
            if c2 not in survivors:
                survivors.add(c2)
                if new_order is not None:
                    new_order[c2] = order[cfg]
    return survivors, new_order


def check_packed(p: PackedHistory, witness: bool = False,
                 cancel=None) -> dict:
    """Decide linearizability on a packed history. ``witness=True`` tracks
    a representative linearization order and, on an invalid verdict,
    emits final-paths. ``cancel`` (a threading.Event) stops the search
    between rows. The search always runs reduced (see search_rows); the
    result carries ``"reduced": True``. A history with no step kernel
    runs :func:`check_generic`."""
    if p.kernel is None:
        return check_generic(p, witness=witness, cancel=cancel)

    init = (0, tuple(int(x) for x in p.init_state))
    configs = {init}
    order: dict | None = {init: None} if witness else None
    try:
        configs, order = search_rows(p, configs, order, 0, p.R,
                                     cancel=cancel, reduce=True)
    except Cancelled:
        return {"valid?": "unknown", "analyzer": "cpu-jit",
                "error": "cancelled"}
    except Dead as d:
        ret = p.ops[int(p.ret_op[d.r])]
        return {"valid?": False,
                "analyzer": "cpu-jit",
                "reduced": True,
                "dead-row": d.r,
                "op": _op_dict(ret),
                "configs": _decode_configs(p, d.seen, d.r),
                "final-paths": _final_paths(p, d.seen, d.order)}

    out = {"valid?": True, "analyzer": "cpu-jit", "reduced": True,
           "configs": _decode_configs(p, configs, None)}
    if order is not None and configs:
        some = next(iter(configs))
        out["witness"] = _witness_path(p, order[some])
    return out


def check_generic(p: PackedHistory, witness: bool = False,
                  cancel=None) -> dict:
    """The same search with the Python model objects themselves as states
    (unreduced): it decides models and histories with no step kernel.
    ``cancel`` stops it between rows."""
    init = (0, p.model)
    configs = {init}
    order: dict | None = {init: None} if witness else None

    def shim(o) -> Op:
        return Op("invoke", o.f, o.value, o.process)

    for r in range(p.R):
        if cancel is not None and cancel.is_set():
            return {"valid?": "unknown", "analyzer": "cpu-generic",
                    "error": "cancelled"}
        act = p.active[r]
        seen = set(configs)
        frontier = list(configs)
        while frontier:
            new = []
            for cfg in frontier:
                bits, st = cfg
                for j in range(p.window):
                    if act[j] and not (bits >> j) & 1:
                        o = p.ops[int(p.slot_op[r, j])]
                        st2 = st.step(shim(o))
                        if not is_inconsistent(st2):
                            c2 = (bits | (1 << j), st2)
                            if c2 not in seen:
                                seen.add(c2)
                                new.append(c2)
                                if order is not None:
                                    order[c2] = (int(p.slot_op[r, j]),
                                                 order[cfg])
            frontier = new
        survivors, new_order = _return_filter(seen, order,
                                              int(p.ret_slot[r]))
        if not survivors:
            ret = p.ops[int(p.ret_op[r])]
            return {"valid?": False, "analyzer": "cpu-generic",
                    "dead-row": r, "op": _op_dict(ret),
                    "configs": [{"model": st, "pending": []}
                                for _, st in list(seen)[:MAX_REPORT_CONFIGS]],
                    "final-paths": _final_paths(p, seen, order)}
        order = new_order
        configs = survivors

    out = {"valid?": True, "analyzer": "cpu-generic",
           "configs": [{"model": st, "pending": []}
                       for _, st in list(configs)[:MAX_REPORT_CONFIGS]]}
    if order is not None and configs:
        some = next(iter(configs))
        out["witness"] = _witness_path(p, order[some])
    return out
