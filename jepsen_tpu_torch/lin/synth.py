"""Synthetic history generation for parity tests and benchmarks.

Simulates a true linearizable object driven by concurrent processes: each
op's linearization point sits just before its completion event, so the
history is linearizable by construction. :func:`corrupt_history` then
makes known-invalid histories. The draws from ``random.Random(seed)`` are
those of :mod:`jepsen_tpu.lin.synth`, so one seed gives one history in
both packages.
"""

from __future__ import annotations

import random
from typing import Any

from jepsen_tpu_torch.history import History, Op, index_history


def generate_register_history(n_ops: int,
                              concurrency: int = 5,
                              seed: int = 0,
                              value_range: int = 5,
                              crash_prob: float = 0.0,
                              max_crashes: int = 16,
                              fs: tuple = ("read", "write", "cas"),
                              ) -> History:
    """A linearizable-by-construction CAS-register history.

    Processes invoke read/write/cas ops; the simulated register applies
    each op atomically at completion. CAS ops whose precondition fails
    complete with ``fail``. With ``crash_prob`` an op crashes (``info``),
    applied or not on a coin flip, and its process is re-incarnated as
    ``process + concurrency``.
    """
    rng = random.Random(seed)
    value: Any = None
    h: list[Op] = []
    procs = list(range(concurrency))
    pending: dict[int, Op] = {}
    crashes = 0
    invoked = 0

    while invoked < n_ops or pending:
        can_invoke = invoked < n_ops and len(pending) < concurrency
        if can_invoke and (not pending or rng.random() < 0.6):
            free = [p for p in procs if p not in pending]
            proc = rng.choice(free)
            f = rng.choice(fs)
            if f == "read":
                op = Op("invoke", "read", None, proc)
            elif f == "write":
                op = Op("invoke", "write", rng.randrange(value_range), proc)
            else:
                op = Op("invoke", "cas",
                        [rng.randrange(value_range),
                         rng.randrange(value_range)], proc)
            pending[proc] = op
            h.append(op)
            invoked += 1
        else:
            proc = rng.choice(list(pending))
            op = pending.pop(proc)
            if crashes < max_crashes and rng.random() < crash_prob:
                # crash: applied or not, nobody knows
                if rng.random() < 0.5:
                    value = _apply(value, op)
                h.append(Op("info", op.f, op.value, proc))
                crashes += 1
                i = procs.index(proc)
                procs[i] = proc + concurrency
            else:
                value, result, ok = _apply_full(value, op)
                if ok:
                    h.append(Op("ok", op.f, result, proc))
                else:
                    h.append(Op("fail", op.f, op.value, proc))
    return index_history(History(h))


def _apply(value, op):
    if op.f == "write":
        return op.value
    if op.f == "cas":
        cur, new = op.value
        return new if cur == value else value
    return value


def _apply_full(value, op):
    if op.f == "read":
        return value, value, True
    if op.f == "write":
        return op.value, op.value, True
    cur, new = op.value
    if cur == value:
        return new, op.value, True
    return value, op.value, False


def generate_partitioned_register_history(
        n_ops: int,
        concurrency: int = 30,
        seed: int = 0,
        value_range: int = 5,
        n_nodes: int = 5,
        partition_every: int = 2000,
        partition_len: int = 300,
        max_crashes: int = 24,
        fs: tuple = ("read", "write", "cas"),
        invoke_bias: float = 0.6,
) -> History:
    """A linearizable-by-construction register history under a partition
    nemesis: the shape of BASELINE config 5 (partitioned 100k-op register
    histories at cockroach's concurrency 30).

    Processes stripe over ``n_nodes`` nodes (node = process mod nodes).
    Every ``partition_every`` invocations a partition isolates the two
    minority nodes for ``partition_len`` invocations: minority mutators
    that complete during it time out indeterminate (``info``, not
    applied), which the checker must treat as possibly applied forever,
    and minority reads fail. Crashed processes re-incarnate, and at most
    ``max_crashes`` ops crash, so the window stays at most concurrency +
    max_crashes. ``invoke_bias`` sets how saturated the schedule runs:
    0.6 keeps nearly every process pending; lower values stagger the
    invocations.
    """
    rng = random.Random(seed)
    value: Any = None
    h: list[Op] = []
    procs = list(range(concurrency))
    pending: dict[int, Op] = {}
    crashes = 0
    invoked = 0
    minority = {n_nodes - 2, n_nodes - 1}

    def node_of(proc: int) -> int:
        return proc % n_nodes

    def partitioned_at(k: int) -> bool:
        return partition_every > 0 and \
            0 <= (k % partition_every) - (partition_every - partition_len) \
            < partition_len

    while invoked < n_ops or pending:
        cut = partitioned_at(invoked)
        can_invoke = invoked < n_ops and len(pending) < concurrency
        if can_invoke and (not pending or rng.random() < invoke_bias):
            free = [p for p in procs if p not in pending]
            if cut:
                free = [p for p in free if node_of(p) not in minority] \
                    or free
            proc = rng.choice(free)
            f = rng.choice(fs)
            if f == "read":
                op = Op("invoke", "read", None, proc)
            elif f == "write":
                op = Op("invoke", "write", rng.randrange(value_range), proc)
            else:
                op = Op("invoke", "cas",
                        [rng.randrange(value_range),
                         rng.randrange(value_range)], proc)
            pending[proc] = op
            h.append(op)
            invoked += 1
        else:
            proc = rng.choice(list(pending))
            op = pending.pop(proc)
            if cut and node_of(proc) in minority:
                # An isolated client: reads fail, mutators time out
                # indeterminate (a minority cannot commit).
                if op.f == "read" or crashes >= max_crashes:
                    h.append(Op("fail", op.f, op.value, proc))
                else:
                    h.append(Op("info", op.f, op.value, proc))
                    crashes += 1
                    i = procs.index(proc)
                    procs[i] = proc + concurrency
                continue
            value, result, ok = _apply_full(value, op)
            if ok:
                h.append(Op("ok", op.f, result, proc))
            else:
                h.append(Op("fail", op.f, op.value, proc))
    return index_history(History(h))


def generate_mutex_history(n_ops: int,
                           concurrency: int = 5,
                           seed: int = 0,
                           crash_prob: float = 0.0,
                           max_crashes: int = 8) -> History:
    """A linearizable-by-construction mutex history (acquire/release)."""
    rng = random.Random(seed)
    locked = False
    holder: int | None = None
    h: list[Op] = []
    procs = list(range(concurrency))
    pending: dict[int, Op] = {}
    crashes = 0
    invoked = 0

    while invoked < n_ops or pending:
        can_invoke = invoked < n_ops and len(pending) < concurrency
        if can_invoke and (not pending or rng.random() < 0.6):
            free = [p for p in procs if p not in pending]
            proc = rng.choice(free)
            f = "release" if (locked and holder == proc) else "acquire"
            # sometimes try the wrong op, which will just fail
            if rng.random() < 0.15:
                f = "acquire" if f == "release" else "release"
            op = Op("invoke", f, None, proc)
            pending[proc] = op
            h.append(op)
            invoked += 1
        else:
            proc = rng.choice(list(pending))
            op = pending.pop(proc)
            applies = (op.f == "acquire" and not locked) or \
                      (op.f == "release" and locked and holder == proc)
            if crashes < max_crashes and rng.random() < crash_prob:
                if applies and rng.random() < 0.5:
                    locked = op.f == "acquire"
                    holder = proc if locked else None
                h.append(Op("info", op.f, None, proc))
                crashes += 1
                i = procs.index(proc)
                procs[i] = proc + concurrency
            elif applies:
                locked = op.f == "acquire"
                holder = proc if locked else None
                h.append(Op("ok", op.f, None, proc))
            else:
                h.append(Op("fail", op.f, None, proc))
    return index_history(History(h))


def generate_queue_history(n_ops: int,
                           concurrency: int = 3,
                           seed: int = 0,
                           fifo: bool = True,
                           crash_prob: float = 0.0,
                           max_crashes: int = 8) -> History:
    """A linearizable-by-construction queue history (enqueue/dequeue), the
    shape of Jepsen's queue workloads: enqueued values are unique ints;
    a dequeue completes with the value actually removed (FIFO order when
    ``fifo``, random otherwise), and on an empty queue it fails."""
    rng = random.Random(seed)
    q: list[int] = []
    next_v = 0
    h: list[Op] = []
    procs = list(range(concurrency))
    pending: dict[int, Op] = {}
    crashes = 0
    invoked = 0

    while invoked < n_ops or pending:
        can_invoke = invoked < n_ops and len(pending) < concurrency
        if can_invoke and (not pending or rng.random() < 0.6):
            free = [p for p in procs if p not in pending]
            proc = rng.choice(free)
            if rng.random() < 0.5:
                op = Op("invoke", "enqueue", next_v, proc)
                next_v += 1
            else:
                op = Op("invoke", "dequeue", None, proc)
            pending[proc] = op
            h.append(op)
            invoked += 1
        else:
            proc = rng.choice(list(pending))
            op = pending.pop(proc)
            if crashes < max_crashes and rng.random() < crash_prob:
                if op.f == "enqueue" and rng.random() < 0.5:
                    q.append(op.value)
                h.append(Op("info", op.f, op.value, proc))
                crashes += 1
                i = procs.index(proc)
                procs[i] = proc + concurrency
            elif op.f == "enqueue":
                q.append(op.value)
                h.append(Op("ok", "enqueue", op.value, proc))
            elif q:
                v = q.pop(0) if fifo else q.pop(rng.randrange(len(q)))
                h.append(Op("ok", "dequeue", v, proc))
            else:
                h.append(Op("fail", "dequeue", None, proc))
    return index_history(History(h))


def generate_set_history(n_ops: int,
                         concurrency: int = 3,
                         seed: int = 0,
                         read_prob: float = 0.2) -> History:
    """A linearizable-by-construction set history (add/read): a read
    completes with the full membership at its linearization point."""
    rng = random.Random(seed)
    s: set[int] = set()
    next_v = 0
    h: list[Op] = []
    procs = list(range(concurrency))
    pending: dict[int, Op] = {}
    invoked = 0

    while invoked < n_ops or pending:
        can_invoke = invoked < n_ops and len(pending) < concurrency
        if can_invoke and (not pending or rng.random() < 0.6):
            free = [p for p in procs if p not in pending]
            proc = rng.choice(free)
            if rng.random() < read_prob:
                op = Op("invoke", "read", None, proc)
            else:
                op = Op("invoke", "add", next_v, proc)
                next_v += 1
            pending[proc] = op
            h.append(op)
            invoked += 1
        else:
            proc = rng.choice(list(pending))
            op = pending.pop(proc)
            if op.f == "add":
                s.add(op.value)
                h.append(Op("ok", "add", op.value, proc))
            else:
                h.append(Op("ok", "read", sorted(s), proc))
    return index_history(History(h))


def corrupt_history(history: History, seed: int = 0,
                    n_corruptions: int = 1) -> History:
    """Corrupt ok-read values so the history is (very likely) not
    linearizable."""
    rng = random.Random(seed)
    h = list(history)
    read_positions = [i for i, o in enumerate(h)
                      if o.is_ok and o.f == "read"]
    rng.shuffle(read_positions)
    for i in read_positions[:n_corruptions]:
        old = h[i].value
        bad = (old if old is not None else 0) + 1000
        h[i] = h[i].replace(value=bad)
    return index_history(History(h))
