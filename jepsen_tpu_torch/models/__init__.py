"""Abstract models of the three dense families: pure state machines with a
``step(op) -> model | Inconsistent`` transition.

- :class:`CASRegister` — write / read / compare-and-set register
- :class:`Register`    — write / read register
- :class:`Mutex`       — acquire / release lock

These are the semantic reference; the batched torch step functions the
device search evaluates live in :mod:`jepsen_tpu_torch.models.kernels`.
"""

from __future__ import annotations

from dataclasses import dataclass
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
