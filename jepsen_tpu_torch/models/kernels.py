"""Batched torch step functions of the three dense model families.

Conventions (shared with :mod:`jepsen_tpu_torch.lin.prepare`):

- ``f`` is an interned function id (:data:`F_READ` ...).
- Values are interned non-negative ids; :data:`NIL` is the sentinel for
  nil/unknown (a read that observed nil matches any state).
- Model state is a vector of ints, one wide for all three families.
- ``step(state, f, v) -> (ok, new_state)`` over broadcast tensors:
  ``state[..., S]``, ``f[...]``, ``v[..., VW]``; ``ok`` is bool of the
  broadcast leading shape and ``new_state`` is ``[..., S]``. No Python
  branching on values, so one call evaluates every (state, op) pair of a
  chunk at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

# Interned function ids. The full table is kept (not only the dense
# families' fs) so that an op of another family packs to the same id as
# in the JAX package and is simply never legal here.
F_READ = 0
F_WRITE = 1
F_CAS = 2
F_ACQUIRE = 3
F_RELEASE = 4
F_NOOP = 5          # legal in every model, state unchanged
F_ENQUEUE = 6
F_DEQUEUE = 7
F_ADD = 8

F_IDS = {"read": F_READ, "write": F_WRITE, "cas": F_CAS,
         "acquire": F_ACQUIRE, "release": F_RELEASE,
         "enqueue": F_ENQUEUE, "dequeue": F_DEQUEUE, "add": F_ADD}

# Sentinel for nil/unknown values: -2**31 in int32. Never produced by
# interning.
NIL = np.int32(-(2 ** 31))

# Families whose one-word state is a bounded non-negative id (NIL remapped
# to a dedicated id): the ones the dense engine and the sparse engine's
# packed keys take.
PACKED_STATE_KERNELS = ("cas-register", "register", "mutex")

# Kernels whose F_READ legality is exactly "v == NIL or v == state[0]"
# (see _cas_register_step / _register_step). The sparse engine bakes
# this predicate into per-state saturation tables; a kernel listed here
# with other read semantics would make that path unsound.
READ_VALUE_MATCH_KERNELS = ("cas-register", "register")


def packed_state_bound(kernel: "KernelModel", n_intern: int) -> int:
    """Exclusive upper bound of a PACKED_STATE_KERNELS kernel's one-word
    state values. NIL is remapped to the bound itself (nil_id), so packed
    state ids live in [0, bound] and need ``bound.bit_length()`` bits.
    Every family the port has ranges over the intern table."""
    del kernel
    return max(n_intern, 2)

# Max value words per op: cas carries [cur, new]; everything else uses v[0].
VALUE_WIDTH = 2


@dataclass(frozen=True)
class KernelModel:
    """A model compiled for the device frontier search."""

    name: str
    init_state: Callable[[], np.ndarray]  # initial packed state (host)
    step: Callable  # (state[..., S], f[...], v[..., VW]) -> (ok, state)


def _cas_register_step(state, f, v):
    cur = state[..., 0]
    v0, v1 = v[..., 0], v[..., 1]
    is_read = f == F_READ
    is_write = f == F_WRITE
    is_cas = f == F_CAS
    ok = ((is_read & ((v0 == int(NIL)) | (v0 == cur)))
          | is_write
          | (is_cas & (v0 == cur))
          | (f == F_NOOP))
    new = torch.where(is_write, v0, torch.where(is_cas, v1, cur))
    return ok, new.unsqueeze(-1)


def _register_step(state, f, v):
    # write/read only; cas is never legal.
    cur = state[..., 0]
    v0 = v[..., 0]
    is_read = f == F_READ
    is_write = f == F_WRITE
    ok = (is_read & ((v0 == int(NIL)) | (v0 == cur))) | is_write \
        | (f == F_NOOP)
    new = torch.where(is_write, v0, cur)
    return ok, new.unsqueeze(-1)


def _mutex_step(state, f, v):
    # acquire fails when held, release when not.
    locked = state[..., 0]
    is_acq = f == F_ACQUIRE
    is_rel = f == F_RELEASE
    ok = (is_acq & (locked == 0)) | (is_rel & (locked == 1)) | (f == F_NOOP)
    one = torch.ones_like(locked)
    new = torch.where(is_acq, one, torch.where(is_rel, 0 * one, locked))
    return ok, new.unsqueeze(-1)


def cas_register_kernel(initial: int = int(NIL)) -> KernelModel:
    return KernelModel("cas-register",
                       lambda: np.array([initial], np.int32),
                       _cas_register_step)


def register_kernel(initial: int = int(NIL)) -> KernelModel:
    return KernelModel("register",
                       lambda: np.array([initial], np.int32),
                       _register_step)


def mutex_kernel(locked: bool = False) -> KernelModel:
    return KernelModel("mutex",
                       lambda: np.array([int(locked)], np.int32),
                       _mutex_step)


def kernel_for(model) -> KernelModel:
    """Map a model instance (:mod:`jepsen_tpu_torch.models`) to its step
    kernel. Register values still pass through interning in
    :mod:`jepsen_tpu_torch.lin.prepare`, which sets the interned initial
    state."""
    from jepsen_tpu_torch import models as m

    if isinstance(model, m.CASRegister):
        return cas_register_kernel()
    if isinstance(model, m.Register):
        return register_kernel()
    if isinstance(model, m.Mutex):
        return mutex_kernel(model.locked)
    raise ValueError(
        f"no step kernel for model {type(model).__name__}; the port "
        "supports register/cas-register/mutex")
