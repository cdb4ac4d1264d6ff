"""Abstract models: pure state machines with a ``step(op) -> model |
Inconsistent`` transition.

- :class:`NoOp`           — always itself
- :class:`CASRegister`    — write / read / compare-and-set register
- :class:`Register`       — write / read register
- :class:`Mutex`          — acquire / release lock
- :class:`SetModel`       — add / read set
- :class:`UnorderedQueue` — enqueue / dequeue in any order (a multiset)
- :class:`FIFOQueue`      — enqueue / dequeue in order

These are the semantic reference; the batched torch step functions the
device search evaluates live in :mod:`jepsen_tpu_torch.models.kernels`.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Inconsistent:
    """A transition result marking an impossible op."""

    msg: str


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(x) -> bool:
    return isinstance(x, Inconsistent)


class Model:
    """Base for abstract models."""

    def step(self, op) -> "Model | Inconsistent":
        raise NotImplementedError


@dataclass(frozen=True)
class NoOp(Model):
    """Always returns itself, unchanged."""

    def step(self, op):
        return self


noop = NoOp()


@dataclass(frozen=True)
class CASRegister(Model):
    """A compare-and-set register.

    - ``write v``        — always succeeds, value becomes v
    - ``cas [cur, new]`` — succeeds iff value == cur, becomes new
    - ``read v``         — succeeds iff v is None (unknown) or v == value
    """

    value: Any = None

    def step(self, op):
        f = op.f
        if f == "write":
            return CASRegister(op.value)
        if f == "cas":
            cur, new = op.value
            if cur == self.value:
                return CASRegister(new)
            return inconsistent(f"can't CAS {self.value} from {cur} to {new}")
        if f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(
                f"can't read {op.value} from register {self.value}")
        return inconsistent(f"unknown op f={f}")


def cas_register(value=None) -> CASRegister:
    return CASRegister(value)


@dataclass(frozen=True)
class Register(Model):
    """A read/write register without CAS."""

    value: Any = None

    def step(self, op):
        f = op.f
        if f == "write":
            return Register(op.value)
        if f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(
                f"can't read {op.value} from register {self.value}")
        return inconsistent(f"unknown op f={f}")


def register(value=None) -> Register:
    return Register(value)


@dataclass(frozen=True)
class Mutex(Model):
    """A single mutex responding to acquire/release."""

    locked: bool = False

    def step(self, op):
        f = op.f
        if f == "acquire":
            if self.locked:
                return inconsistent("already held")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return inconsistent("not held")
            return Mutex(False)
        return inconsistent(f"unknown op f={f}")


def mutex() -> Mutex:
    return Mutex(False)


@dataclass(frozen=True)
class SetModel(Model):
    """A set responding to add/read: a read must observe exactly the
    set's members."""

    s: frozenset = field(default_factory=frozenset)

    def step(self, op):
        f = op.f
        if f == "add":
            return SetModel(self.s | {op.value})
        if f == "read":
            try:
                observed = set(op.value) if op.value is not None else None
            except TypeError:
                observed = None
            if observed is not None and observed == set(self.s):
                return self
            return inconsistent(
                f"can't read {op.value!r} from {set(self.s)!r}")
        return inconsistent(f"unknown op f={f}")


def set_model() -> SetModel:
    return SetModel()


@dataclass(frozen=True)
class UnorderedQueue(Model):
    """A queue which does not order its pending elements: a multiset."""

    pending: tuple = ()  # sorted by repr, so that equal multisets are equal

    def step(self, op):
        f = op.f
        if f == "enqueue":
            return UnorderedQueue(_multiset_add(self.pending, op.value))
        if f == "dequeue":
            if op.value in self.pending:
                return UnorderedQueue(_multiset_remove(self.pending,
                                                       op.value))
            return inconsistent(f"can't dequeue {op.value}")
        return inconsistent(f"unknown op f={f}")


def _multiset_add(t: tuple, v) -> tuple:
    return tuple(sorted(list(t) + [v], key=repr))


def _multiset_remove(t: tuple, v) -> tuple:
    out = list(t)
    out.remove(v)
    return tuple(out)


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


@dataclass(frozen=True)
class FIFOQueue(Model):
    """A FIFO queue: a dequeue must take the oldest pending element."""

    pending: tuple = ()

    def step(self, op):
        f = op.f
        if f == "enqueue":
            return FIFOQueue(self.pending + (op.value,))
        if f == "dequeue":
            if not self.pending:
                return inconsistent(
                    f"can't dequeue {op.value} from empty queue")
            if self.pending[0] == op.value:
                return FIFOQueue(self.pending[1:])
            return inconsistent(f"can't dequeue {op.value}")
        return inconsistent(f"unknown op f={f}")


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()


def multiset(xs=()) -> Counter:
    """A multiset of ``xs`` (for queue checkers' bookkeeping)."""
    return Counter(xs)
