"""ctypes binding of the native packing walk, ``csrc/history_pack.cc``.

The C++ twin of :func:`jepsen_tpu_torch.lin.prepare._pack_events_py`,
with the C ABI ``jtpu_pack_events``. It is built by the host compiler
through :mod:`jepsen_tpu_torch._build` at first use, into
``build/torch_kernels/``. A build or load that fails raises with the
compiler's output: the walk is never swapped for another one quietly.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from jepsen_tpu_torch import _build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("history_pack")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.jtpu_pack_events.restype = ctypes.c_int
            lib.jtpu_pack_events.argtypes = [
                ctypes.c_int32,                 # n_ops
                i32p, i32p, i32p, i32p, i32p,   # invoke/return/f/v0/v1
                ctypes.c_int32,                 # nil_value
                ctypes.c_int32,                 # max_window
                ctypes.c_int32,                 # fill_fv
                ctypes.c_int32,                 # R
                i32p, i32p,                     # ret_slot, ret_op
                u8p, i32p, i32p, i32p,          # active, slot_f, slot_v,
                                                # slot_op
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        return _lib


class WindowOverflow(Exception):
    """The concurrency window passed max_window at history position
    ``.pos``."""

    def __init__(self, pos: int):
        super().__init__(f"window overflow at history position {pos}")
        self.pos = pos


def pack_events(invoke_pos, return_pos, f_id, v0, v1, *,
                nil_value: int, max_window: int, fill_fv: bool, R: int):
    """Run the native packing walk: ``(ret_slot, ret_op, active, slot_f,
    slot_v, slot_op, window)``, the tables at width ``max_window`` with
    the Python walk's defaults (active False, slot_f 0, slot_v NIL,
    slot_op -1). Raises :class:`WindowOverflow` where the Python walk
    raises its window error, and ``ValueError`` on inputs the walk
    refuses (R not the count of returning ops)."""
    lib = _load()
    n = len(invoke_pos)
    invoke_pos = np.ascontiguousarray(invoke_pos, np.int32)
    return_pos = np.ascontiguousarray(return_pos, np.int32)
    f_id = np.ascontiguousarray(f_id, np.int32)
    v0 = np.ascontiguousarray(v0, np.int32)
    v1 = np.ascontiguousarray(v1, np.int32)

    ret_slot = np.zeros(R, np.int32)
    ret_op = np.zeros(R, np.int32)
    active = np.zeros((R, max_window), np.uint8)
    slot_f = np.zeros((R, max_window), np.int32)
    slot_v = np.full((R, max_window, 2), nil_value, np.int32)
    slot_op = np.full((R, max_window), -1, np.int32)
    out_w = ctypes.c_int32(0)

    rc = lib.jtpu_pack_events(
        np.int32(n), invoke_pos, return_pos, f_id, v0, v1,
        np.int32(nil_value), np.int32(max_window), np.int32(int(fill_fv)),
        np.int32(R), ret_slot, ret_op,
        active.reshape(-1), slot_f.reshape(-1), slot_v.reshape(-1),
        slot_op.reshape(-1), ctypes.byref(out_w))
    if rc == -1:
        raise WindowOverflow(int(out_w.value))
    if rc != 0:
        raise ValueError(f"jtpu_pack_events refused its inputs (rc {rc}): "
                         f"n_ops {n}, max_window {max_window}, R {R}")
    return (ret_slot, ret_op, active.astype(bool), slot_f, slot_v,
            slot_op, int(out_w.value))
