"""Operation histories: the op record the checker consumes.

An op is ``{type, f, value, process, time, index}`` (``type`` one of
``invoke`` / ``ok`` / ``fail`` / ``info``), the same record and JSONL
encoding as :mod:`jepsen_tpu.history`, so a history written by either
package reads back identically in the other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Any, Iterable

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"


@dataclass(frozen=True)
class Op:
    """One history event. Frozen; use :meth:`replace` to derive variants."""

    type: str
    f: Any = None
    value: Any = None
    process: Any = None
    time: int | None = None
    index: int | None = None
    extra: dict = field(default_factory=dict, compare=False)

    def replace(self, **kw) -> "Op":
        extra_updates = {k: v for k, v in kw.items() if k not in _OP_FIELDS}
        base = {k: v for k, v in kw.items() if k in _OP_FIELDS}
        if extra_updates:
            base["extra"] = {**self.extra, **extra_updates}
        return _dc_replace(self, **base)

    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    def to_dict(self) -> dict:
        d = {"type": self.type, "f": self.f, "value": self.value,
             "process": self.process, "time": self.time, "index": self.index}
        d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Op":
        extra = {k: v for k, v in d.items() if k not in _OP_FIELDS}
        return Op(type=d.get("type"), f=d.get("f"), value=d.get("value"),
                  process=d.get("process"), time=d.get("time"),
                  index=d.get("index"), extra=extra)


_OP_FIELDS = {"type", "f", "value", "process", "time", "index"}


def invoke_op(process, f, value, **extra) -> Op:
    return Op(INVOKE, f, value, process, extra=extra)


def ok_op(process, f, value, **extra) -> Op:
    return Op(OK, f, value, process, extra=extra)


def fail_op(process, f, value, **extra) -> Op:
    return Op(FAIL, f, value, process, extra=extra)


def info_op(process, f, value, **extra) -> Op:
    return Op(INFO, f, value, process, extra=extra)


def op(d) -> Op:
    return d if isinstance(d, Op) else Op.from_dict(d)


def index(history: Iterable[Op]) -> list[Op]:
    """Assign sequential ``index`` to each op."""
    return [o.replace(index=i) if o.index != i else o
            for i, o in enumerate(history)]


def _default(o):
    if isinstance(o, Op):
        return o.to_dict()
    if isinstance(o, (set, frozenset)):
        return {"__set__": sorted(o, key=repr)}
    if isinstance(o, tuple):
        return list(o)
    return repr(o)


def dumps_op(o: Op) -> str:
    return json.dumps(o.to_dict(), default=_default)


def _decode(v):
    if isinstance(v, dict):
        if set(v) == {"__set__"}:
            return frozenset(_decode(x) for x in v["__set__"])
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode(x) for x in v]
    return v


def loads_op(s: str) -> Op:
    return Op.from_dict(_decode(json.loads(s)))


class History(list):
    """A list of Ops with convenience constructors."""

    @staticmethod
    def of(*ops) -> "History":
        h = History()
        for o in ops:
            h.append(op(o))
        return index_history(h)


def index_history(h: "History") -> "History":
    return History(index(h))
