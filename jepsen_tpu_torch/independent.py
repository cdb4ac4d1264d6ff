"""Lifting single-key tests to maps of independent keys.

A linearizability check needs short histories, so a test of one register
is lifted to a map of keys to registers: each op's value is a
``KV(key, value)`` tuple, and :func:`checker` splits the history into
per-key subhistories and checks each. Where the inner checker is device
linearizability, every key's subhistory joins one batched device search
(:mod:`jepsen_tpu_torch.lin.batched`); keys that cannot batch are checked
one at a time. The port of :mod:`jepsen_tpu.independent`'s checker side;
its generators and artifact files are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

from jepsen_tpu_torch import checker as checker_ns
from jepsen_tpu_torch.history import Op

DIR = "independent"


class KV(NamedTuple):
    """A key-value tuple marking an op as belonging to an independent
    key."""

    key: object
    value: object


def tuple_(k, v) -> KV:
    return KV(k, v)


def is_tuple(v) -> bool:
    return isinstance(v, KV) or (isinstance(v, (list, tuple))
                                 and len(v) == 2
                                 and getattr(v, "_is_kv", False))


def history_keys(history) -> set:
    """The set of independent keys in a history."""
    return {op.value.key for op in history if isinstance(op.value, KV)}


def subhistory(k, history) -> list[Op]:
    """Ops for key k (tuples unwrapped) plus every un-keyed op: nemesis
    ops appear in every subhistory."""
    return _subhistories([k], history)[k]


def _subhistories(ks, history) -> dict:
    """{k: subhistory(k, history)} for every key of ``ks``, in one pass
    over the history (a pass per key costs keys x ops); ops of other
    keys are left out."""
    subs: dict = {k: [] for k in ks}
    for op in history:
        v = op.value
        if not isinstance(v, KV):
            for sub in subs.values():
                sub.append(op)
        elif v.key in subs:
            subs[v.key].append(op.replace(value=v.value))
    return subs


def checker(inner: checker_ns.Checker,
            batch_device: bool = True) -> checker_ns.Checker:
    """Lift a checker over values to a checker over [k v] histories: valid
    iff the inner checker is valid for every key's subhistory. Results
    per key under "results"; invalid keys under "failures".

    When the inner checker is device linearizability (``"gpu"`` or
    ``"competition"``), the keys are checked in batched device searches
    on the inner checker's device (``inner.device``: the card unless it
    was given ``device="cpu"``; raises without a card) instead of key at
    a time. "batch-engaged" and "batch-keys" say whether and for how
    many keys the batch decided."""

    def check(test, model, history, opts):
        ks = sorted(history_keys(history), key=repr)
        subs = _subhistories(ks, history)
        opts = opts or {}

        batched = None
        # The batched device search may only stand in for a checker that
        # IS device linearizability: substituting it for another lifted
        # checker would skip that checker's semantics.
        inner_is_lin = getattr(inner, "is_linearizable", False) and \
            getattr(inner, "algorithm", None) in ("gpu", "competition")
        if batch_device and inner_is_lin and model is not None:
            from jepsen_tpu_torch.lin import batched as batched_mod

            batched = batched_mod.try_check_batch(
                model, subs, device=getattr(inner, "device", None))
        # The batch may cover a subset; the other keys go one at a time.
        results = dict(batched or {})
        for k in ks:
            if k in results:
                continue
            sub_opts = {**opts,
                        "subdirectory": _subdir(opts, k),
                        "history-key": k}
            results[k] = checker_ns.check_safe(
                inner, test, model, subs[k], sub_opts)

        failures = [k for k in ks
                    if results[k].get(checker_ns.VALID) is not True]
        return {checker_ns.VALID:
                checker_ns.merge_valid(
                    [results[k].get(checker_ns.VALID) for k in ks])
                if ks else True,
                "results": results,
                "failures": failures,
                "batch-engaged": batched is not None,
                "batch-keys": len(batched or {}),
                "n-keys": len(ks)}

    return checker_ns.FnChecker(check)


def _subdir(opts, k):
    sub = opts.get("subdirectory")
    parts = [sub] if isinstance(sub, str) else list(sub or [])
    return parts + [DIR, str(k)]
