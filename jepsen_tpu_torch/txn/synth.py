"""Synthetic list-append histories for the txn checker.

The port's copy of the JAX package's ``txn/synth.py`` on the port's
:class:`~jepsen_tpu_torch.history.Op`: the same seed makes the same
history. The :mod:`jepsen_tpu_torch.lin.synth` role for the
transactional family:

- :func:`generate_list_append_history` — a serializable-by-construction
  concurrent history (every transaction applies atomically at a
  linearization point inside its invocation window), optionally with
  crashed (``:info``) transactions, at any op count — the ``txn_c30``
  bench shape and the 100k-op acceptance history.
- :func:`seeded_anomaly_history` — minimal hand-built histories with a
  KNOWN anomaly (G0 / G1c / G-single / G2-item / G1a), used by the
  parity tests and the smoke: the checker must find and classify each
  identically on oracle and device.
- :func:`splice_anomaly` — injects a seeded anomaly pattern (on fresh
  keys) into a big healthy history, so 100k-op invalid corpora exist.
"""

from __future__ import annotations

import random

from jepsen_tpu_torch.history import Op


def _invoke(process, mops):
    return Op("invoke", "txn", [list(m) for m in mops], process)


def _complete(process, mops, typ="ok"):
    return Op(typ, "txn", [list(m) for m in mops], process)


def generate_list_append_history(n_txns: int, concurrency: int = 10,
                                 keys: int = 8, seed: int = 0,
                                 mops_per_txn: tuple = (1, 4),
                                 read_frac: float = 0.5,
                                 crash_prob: float = 0.0,
                                 max_crashes: int = 16) -> list[Op]:
    """Serializable concurrent history: a shared store applies each
    txn atomically in invocation order; up to ``concurrency`` txns are
    in flight, and completions are emitted after a random number of
    other invocations (so the realtime order is a genuine partial
    order). Crashed txns apply their appends (recoverable iff observed
    later) but never complete."""
    rng = random.Random(seed)
    store: dict = {k: [] for k in range(keys)}
    next_val = [0]
    next_proc = [concurrency]
    history: list[Op] = []
    inflight: list = []   # (process, completion op, remaining delay)
    crashes = 0
    free_procs = list(range(concurrency))

    def drain(force: bool = False):
        nonlocal inflight
        keep = []
        for proc, comp, delay in inflight:
            if force or delay <= 0:
                history.append(comp)
                free_procs.append(proc)
            else:
                keep.append((proc, comp, delay - 1))
        inflight = keep

    for _ in range(n_txns):
        while not free_procs:
            drain()
            if not free_procs and inflight:
                proc, comp, _d = inflight.pop(0)
                history.append(comp)
                free_procs.append(proc)
        proc = free_procs.pop(rng.randrange(len(free_procs)))
        n_mops = rng.randint(*mops_per_txn)
        mops = []
        for _m in range(n_mops):
            k = rng.randrange(keys)
            if rng.random() < read_frac:
                mops.append(("r", k, None))
            else:
                next_val[0] += 1
                mops.append(("append", k, next_val[0]))
        history.append(_invoke(proc, mops))
        # Atomic apply at invocation (a valid linearization point).
        done = []
        for f, k, v in mops:
            if f == "append":
                store[k].append(v)
                done.append(("append", k, v))
            else:
                done.append(("r", k, list(store[k])))
        if crashes < max_crashes and rng.random() < crash_prob:
            crashes += 1
            # Crashed: appends applied, observation lost, no return.
            # The process id is dead (a reused id would alias the
            # dangling invoke in pairing); a fresh one replaces it.
            free_procs.append(next_proc[0])
            next_proc[0] += 1
            continue
        inflight.append((proc, _complete(proc, done),
                         rng.randrange(0, concurrency)))
    drain(force=True)
    return history


# --- seeded anomalies --------------------------------------------------------

def _txn(history, proc, mops_inv, mops_ok=None, typ="ok"):
    history.append(_invoke(proc, mops_inv))
    if typ == "fail":
        history.append(_complete(proc, mops_inv, "fail"))
    elif typ == "ok":
        history.append(_complete(proc, mops_ok or mops_inv, "ok"))
    # typ "info": no completion (dangling invoke = crashed)


def seeded_anomaly_history(kind: str, key_base=None) -> list[Op]:
    """A minimal history exhibiting exactly ``kind``. Keys take the
    form ``f"{key_base}:x"`` so patterns splice into healthy histories
    without touching their keys."""
    kb = key_base if key_base is not None else "seed"
    x, y = f"{kb}:x", f"{kb}:y"
    h: list[Op] = []
    if kind == "G0":
        # ww(x): T0 -> T1 but ww(y): T1 -> T0 (observed interleaving).
        h.append(_invoke(0, [["append", x, 1], ["append", y, 2]]))
        h.append(_invoke(1, [["append", x, 3], ["append", y, 4]]))
        h.append(_complete(0, [["append", x, 1], ["append", y, 2]]))
        h.append(_complete(1, [["append", x, 3], ["append", y, 4]]))
        _txn(h, 2, [["r", x, None], ["r", y, None]],
             [["r", x, [1, 3]], ["r", y, [4, 2]]])
    elif kind == "G1c":
        # wr(x): T0 -> T1 and wr(y): T1 -> T0.
        h.append(_invoke(0, [["append", x, 1], ["r", y, None]]))
        h.append(_invoke(1, [["append", y, 2], ["r", x, None]]))
        h.append(_complete(0, [["append", x, 1], ["r", y, [2]]]))
        h.append(_complete(1, [["append", y, 2], ["r", x, [1]]]))
    elif kind == "G-single":
        # T0 reads y's version from T1 (wr T1->T0) but misses T1's
        # append to x (rw T0->T1): read skew, one anti-dependency.
        h.append(_invoke(1, [["append", y, 5], ["append", x, 7]]))
        h.append(_complete(1, [["append", y, 5], ["append", x, 7]]))
        h.append(_invoke(0, [["r", y, None], ["r", x, None]]))
        h.append(_complete(0, [["r", y, [5]], ["r", x, []]]))
        # A later read establishes x's version order.
        _txn(h, 2, [["r", x, None]], [["r", x, [7]]])
    elif kind == "G2-item":
        # Write skew: each reads the other's key before its append.
        h.append(_invoke(0, [["r", x, None], ["append", y, 1]]))
        h.append(_invoke(1, [["r", y, None], ["append", x, 2]]))
        h.append(_complete(0, [["r", x, []], ["append", y, 1]]))
        h.append(_complete(1, [["r", y, []], ["append", x, 2]]))
        _txn(h, 2, [["r", x, None], ["r", y, None]],
             [["r", x, [2]], ["r", y, [1]]])
    elif kind == "G1a":
        # Aborted read: T1 observes a value whose append failed.
        _txn(h, 0, [["append", x, 9]], typ="fail")
        _txn(h, 1, [["r", x, None]], [["r", x, [9]]])
    else:
        raise ValueError(f"unknown seeded anomaly {kind!r}")
    return h


def splice_anomaly(history: list[Op], kind: str, seed: int = 0,
                   n: int = 1) -> list[Op]:
    """Inject ``n`` seeded ``kind`` patterns (fresh keys, fresh process
    ids) at random positions of a healthy history."""
    rng = random.Random(seed)
    out = list(history)
    procs = {op.process for op in history
             if isinstance(op.process, int)}
    base_proc = (max(procs) + 1) if procs else 0
    for i in range(n):
        # Key base carries kind+seed: two splices into the same history
        # must never share keys (colliding patterns read each other's
        # appends and manufacture incompatible-order noise).
        pat = seeded_anomaly_history(kind, key_base=f"{kind}{seed}.{i}")
        pat = [op.replace(process=base_proc + 10 * i + op.process)
               for op in pat]
        pos = rng.randrange(len(out) + 1)
        out[pos:pos] = pat
    return out
