"""History validators: the linearizability and transaction checkers.

A checker validates a recorded history against a model and returns a
result map with a ``"valid?"`` key — ``True``, ``False`` or
``"unknown"``; ``merge_valid`` combines such values. ``linearizable``
dispatches to :mod:`jepsen_tpu_torch.lin` with the result contract of
:func:`jepsen_tpu.checker.linearizable`; ``txn_cycles`` to
:mod:`jepsen_tpu_torch.txn` with that of
:func:`jepsen_tpu.checker.txn_cycles`.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable

VALID = "valid?"

# Larger numbers dominate when checkers are composed.
_VALID_PRIORITIES = {True: 0, False: 1, "unknown": 0.5}


def merge_valid(valids) -> Any:
    """Merge valid? values, yielding the highest-priority one. Raises on
    a value that is not a valid? value."""
    out = True
    for v in valids:
        for x in (out, v):
            if x not in _VALID_PRIORITIES:
                raise ValueError(f"{x!r} is not a known valid? value")
        if _VALID_PRIORITIES[v] > _VALID_PRIORITIES[out]:
            out = v
    return out


class Checker:
    """Verify a history. Returns a map like ``{"valid?": True}`` or
    ``{"valid?": False, ...details}``."""

    def check(self, test, model, history, opts=None) -> dict:
        raise NotImplementedError


class FnChecker(Checker):
    def __init__(self, fn: Callable):
        self.fn = fn

    def check(self, test, model, history, opts=None):
        return self.fn(test, model, history, opts or {})


def check_safe(checker: Checker, test, model, history, opts=None) -> dict:
    """Like check, but wraps exceptions into
    ``{"valid?": "unknown", "error": ...}``."""
    try:
        return checker.check(test, model, history, opts or {})
    except Exception:
        return {VALID: "unknown", "error": traceback.format_exc()}


def unbridled_optimism() -> Checker:
    """Everything is awesoooommmmme!"""
    return FnChecker(lambda test, model, history, opts: {VALID: True})


def linearizable(algorithm: str = "competition",
                 time_budget: float | None = None, device=None,
                 **kw) -> Checker:
    """Validates linearizability.

    ``algorithm`` is one of ``"gpu"`` (the device engine), ``"cpu"`` (the
    host reference search) or ``"competition"`` (race both, first verdict
    wins). ``device`` is where the device engine runs: the card by
    default; ``"cpu"`` runs the kernels' plain torch versions.

    ``time_budget`` (seconds) caps the search: when it fires, both
    searches are cancelled between rows/chunks and the result is an
    honest ``"unknown"`` with the reason. The result's ``final-paths`` and
    ``configs`` are truncated to 10 entries.
    """

    def check(test, model, history, opts):
        from jepsen_tpu_torch import lin

        # Counterexample paths by default: the host racer tracks witness
        # order; the device racer replays the failing tail.
        kw2 = dict(kw)
        if algorithm in ("cpu", "competition"):
            kw2.setdefault("witness", True)
        if algorithm in ("gpu", "competition"):
            kw2.setdefault("explain", True)
        timer = None
        timed_out = None
        if time_budget is not None:
            cancel = kw2.setdefault("cancel", threading.Event())
            timed_out = threading.Event()

            def fire():
                # Separate flag: the competition race also sets the shared
                # cancel event to stop the losing racer.
                timed_out.set()
                cancel.set()

            timer = threading.Timer(time_budget, fire)
            timer.daemon = True
            timer.start()
        try:
            a = lin.analysis(model, history, algorithm=algorithm,
                             device=device, **kw2)
        finally:
            if timer is not None:
                timer.cancel()
        a = dict(a)
        if timed_out is not None and timed_out.is_set() \
                and a.get(VALID) not in (True, False):
            a[VALID] = "unknown"
            a["error"] = (f"time budget {time_budget}s exceeded: "
                          f"{a.get('error', 'search cancelled')}")
        a["final-paths"] = list(a.get("final-paths", []))[:10]
        a["configs"] = list(a.get("configs", []))[:10]
        return a

    ck = FnChecker(check)
    ck.is_linearizable = True
    ck.algorithm = algorithm
    # Where the device engine runs; a lifted checker's key batch runs
    # there too (jepsen_tpu_torch.independent).
    ck.device = device
    return ck


def txn_cycles(anomalies=None, consistency: str = "serializable",
               algorithm: str = "gpu", realtime: bool | None = None,
               device=None) -> Checker:
    """Validates transactional isolation of list-append histories by
    dependency-graph cycle search (:mod:`jepsen_tpu_torch.txn` — Elle's
    analysis in Adya's formalization; the SQL suites' checker).

    ``anomalies`` — explicit anomaly tuple (e.g. ``("G0", "G1c")``), or
    None to derive from ``consistency`` ("serializable",
    "snapshot-isolation", "strict-serializable", "read-committed").
    ``algorithm`` — ``"gpu"`` (the device SCC engine, with the host
    Tarjan for a tier whose iteration ceiling fires) or ``"cpu"`` (the
    oracle). ``device`` — where the device engine runs: the card by
    default; ``"cpu"`` runs the kernel's plain torch version.
    ``realtime`` — force realtime edges on/off (default: on exactly for
    strict-serializable)."""

    def check(test, model, history, opts):
        from jepsen_tpu_torch import txn

        return txn.check(list(history), anomalies=anomalies,
                         consistency=consistency, realtime=realtime,
                         algorithm=algorithm, device=device)

    ck = FnChecker(check)
    ck.is_txn_cycles = True
    ck.algorithm = algorithm
    return ck
