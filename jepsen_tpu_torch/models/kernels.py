"""Batched torch step functions of the models.

Conventions (shared with :mod:`jepsen_tpu_torch.lin.prepare`):

- ``f`` is an interned function id (:data:`F_READ` ...).
- Values are interned non-negative ids; :data:`NIL` is the sentinel for
  nil/unknown (a read that observed nil matches any state).
- Model state is a vector of ints of fixed width ``state_width``: one
  for the register and mutex families, one per 31 elements for sets and
  unique-value queues, one per value for an unordered queue of repeated
  values, and depth + 1 for a FIFO queue.
- ``step(state, f, v) -> (ok, new_state)`` over broadcast tensors:
  ``state[..., S]``, ``f[...]``, ``v[..., VW]``; ``ok`` is bool of the
  broadcast leading shape and ``new_state`` is ``[..., S]``. No Python
  branching on values, so one call evaluates every (state, op) pair of a
  chunk at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
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

# Families whose one-word state is a bounded non-negative int (NIL
# remapped to a dedicated id): the ones the dense engine and the sparse
# engine's packed keys take. The register and mutex families range over
# the intern table; a one-word set ranges over element bitmasks, so its
# bound rides on the kernel (``state_bound``). :func:`packed_state_bound`
# is the one definition of that range the engines share.
PACKED_STATE_KERNELS = ("cas-register", "register", "mutex", "set")

# Kernels whose F_READ legality is exactly "v == NIL or v == state[0]"
# (see _cas_register_step / _register_step). The sparse engine bakes
# this predicate into per-state saturation tables; a kernel listed here
# with other read semantics would make that path unsound.
READ_VALUE_MATCH_KERNELS = ("cas-register", "register")


def packed_state_bound(kernel: "KernelModel", n_intern: int) -> int:
    """Exclusive upper bound of a PACKED_STATE_KERNELS kernel's one-word
    state values. NIL is remapped to the bound itself (nil_id), so packed
    state ids live in [0, bound] and need ``bound.bit_length()`` bits.
    Intern-ranged kernels (register, mutex) are bounded by the intern
    table; a one-word set carries its own ``state_bound`` (2**n_elements:
    its state never equals NIL, so the remapped id never occurs)."""
    if kernel.state_bound is not None:
        return kernel.state_bound
    return max(n_intern, 2)

# Max value words per op: cas carries [cur, new]; everything else uses v[0].
VALUE_WIDTH = 2


@dataclass(frozen=True)
class KernelModel:
    """A model compiled for the device frontier search."""

    name: str
    state_width: int
    init_state: Callable[[], np.ndarray]  # initial packed state (host)
    step: Callable  # (state[..., S], f[...], v[..., VW]) -> (ok, state)
    value_width: int = VALUE_WIDTH  # words per op value (VW)
    # Exclusive upper bound of one-word state values for kernels whose
    # state is not intern-ranged (see packed_state_bound); None for
    # intern-ranged and multiword kernels.
    state_bound: int | None = None


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


# --- set ------------------------------------------------------------------
#
# State is a bitmask over interned element ids, SET_BITS bits per word (31,
# so no word is negative and none equals NIL). ``add e`` sets bit e; ``read``
# succeeds iff the observed mask, packed into the op's value words by
# prepare, equals the state exactly. A nil or unpackable read carries
# all-NIL value words, which no state equals.

SET_BITS = 31


def _word_bit(e: torch.Tensor, n_words: int) -> torch.Tensor:
    """The one-hot word mask [..., n_words] of element ids ``e`` [...]
    (floor division and modulo, so a negative id selects no word)."""
    word = torch.div(e, SET_BITS, rounding_mode="floor")
    bit = torch.ones_like(e) << torch.remainder(e, SET_BITS)
    idx = torch.arange(n_words, device=e.device)
    return torch.where(idx == word.unsqueeze(-1), bit.unsqueeze(-1),
                       torch.zeros_like(bit).unsqueeze(-1))


@lru_cache(maxsize=None)
def _set_step_fn(n_words: int):
    def step(state, f, v):
        is_add = f == F_ADD
        is_read = f == F_READ
        add_mask = _word_bit(v[..., 0], n_words)
        match = (state == v[..., :n_words]).all(-1)
        ok = is_add | (is_read & match) | (f == F_NOOP)
        new = torch.where(is_add.unsqueeze(-1), state | add_mask, state)
        return ok, new.to(state.dtype)

    return step


def _bitmask_init(n_words: int, initial_ids) -> Callable[[], np.ndarray]:
    def init():
        st = np.zeros(n_words, np.int32)
        for e in initial_ids:
            st[e // SET_BITS] |= np.int32(1 << (e % SET_BITS))
        return st

    return init


def set_kernel(n_elements: int, initial_ids=()) -> KernelModel:
    n_words = max(1, -(-n_elements // SET_BITS))
    return KernelModel("set", n_words, _bitmask_init(n_words, initial_ids),
                       _set_step_fn(n_words),
                       value_width=max(VALUE_WIDTH, n_words),
                       # A one-word set packs into the engines' state
                       # ids: its word ranges over element bitmasks.
                       state_bound=(1 << n_elements) if n_words == 1
                       else None)


# --- unordered queue -------------------------------------------------------
#
# A multiset: state is a count per interned value id. Enqueue always
# succeeds; dequeue succeeds iff its value's count is positive.

@lru_cache(maxsize=None)
def _unordered_queue_step_fn(n_values: int):
    def step(state, f, v):
        is_enq = f == F_ENQUEUE
        is_deq = f == F_DEQUEUE
        idx = torch.arange(n_values, device=state.device)
        onehot = (idx == v[..., :1]).to(state.dtype)
        cnt = (state * onehot).sum(-1)
        ok = is_enq | (is_deq & (cnt > 0)) | (f == F_NOOP)
        delta = torch.where(is_enq.unsqueeze(-1), onehot,
                            torch.where(is_deq.unsqueeze(-1), -onehot,
                                        torch.zeros_like(onehot)))
        return ok, (state + delta).to(state.dtype)

    return step


def unordered_queue_kernel(n_values: int, initial_ids=()) -> KernelModel:
    n = max(1, n_values)

    def init():
        st = np.zeros(n, np.int32)
        for e in initial_ids:
            st[e] += 1
        return st

    return KernelModel("unordered-queue", n, init,
                       _unordered_queue_step_fn(n))


# When every enqueued value is distinct, the pending multiset is a set,
# packed as a bitmask like the set kernel: 31 values a word.

@lru_cache(maxsize=None)
def _unordered_unique_step_fn(n_words: int):
    def step(state, f, v):
        is_enq = f == F_ENQUEUE
        is_deq = f == F_DEQUEUE
        mask = _word_bit(v[..., 0], n_words)
        has = ((state & mask) != 0).any(-1)
        ok = (is_enq & ~has) | (is_deq & has) | (f == F_NOOP)
        new = torch.where(is_enq.unsqueeze(-1), state | mask,
                          torch.where(is_deq.unsqueeze(-1), state & ~mask,
                                      state))
        return ok, new.to(state.dtype)

    return step


def unordered_unique_kernel(n_values: int, initial_ids=()) -> KernelModel:
    n_words = max(1, -(-max(1, n_values) // SET_BITS))
    return KernelModel("unordered-unique", n_words,
                       _bitmask_init(n_words, initial_ids),
                       _unordered_unique_step_fn(n_words))


# --- FIFO queue ------------------------------------------------------------
#
# State is [size, buf[0..cap-1]] with buf[0] the front; empty cells are 0,
# so equal queues are equal states. Enqueue writes at index size; dequeue
# requires buf[0] == v and shifts left.

@lru_cache(maxsize=None)
def _fifo_queue_step_fn(capacity: int):
    def step(state, f, v):
        lead = torch.broadcast_shapes(state.shape[:-1], f.shape,
                                      v.shape[:-1])
        is_enq = f == F_ENQUEUE
        is_deq = f == F_DEQUEUE
        size = state[..., 0]
        buf = state[..., 1:]
        v0 = v[..., 0]
        ok = ((is_enq & (size < capacity))
              | (is_deq & (size > 0) & (buf[..., 0] == v0))
              | (f == F_NOOP))
        idx = torch.arange(capacity, device=state.device)
        at = (idx == size.clamp(0, capacity - 1).unsqueeze(-1))
        enq_buf = torch.where(at, v0.unsqueeze(-1).to(state.dtype), buf)
        deq_buf = torch.cat([buf[..., 1:], torch.zeros_like(buf[..., :1])],
                            -1)
        new_buf = torch.where(is_enq.unsqueeze(-1), enq_buf,
                              torch.where(is_deq.unsqueeze(-1), deq_buf,
                                          buf))
        one = torch.ones_like(size)
        new_size = size + torch.where(is_enq, one,
                                      torch.where(is_deq, -one, 0 * one))
        new = torch.cat([new_size.expand(lead).unsqueeze(-1),
                         new_buf.expand(lead + (capacity,))], -1)
        return ok.expand(lead), new.to(state.dtype)

    return step


def fifo_queue_kernel(capacity: int, initial_ids=()) -> KernelModel:
    cap = max(1, capacity)

    def init():
        st = np.zeros(cap + 1, np.int32)
        st[0] = len(initial_ids)
        for i, e in enumerate(initial_ids):
            st[1 + i] = e
        return st

    return KernelModel("fifo-queue", cap + 1, init,
                       _fifo_queue_step_fn(cap))


def cas_register_kernel(initial: int = int(NIL)) -> KernelModel:
    return KernelModel("cas-register", 1,
                       lambda: np.array([initial], np.int32),
                       _cas_register_step)


def register_kernel(initial: int = int(NIL)) -> KernelModel:
    return KernelModel("register", 1,
                       lambda: np.array([initial], np.int32),
                       _register_step)


def mutex_kernel(locked: bool = False) -> KernelModel:
    return KernelModel("mutex", 1,
                       lambda: np.array([int(locked)], np.int32),
                       _mutex_step)


def kernel_for(model) -> KernelModel:
    """Map a model instance (:mod:`jepsen_tpu_torch.models`) to its step
    kernel. Register values still pass through interning in
    :mod:`jepsen_tpu_torch.lin.prepare`, which sets the interned initial
    state. A set or queue kernel is sized here for the model's own
    contents (element and value ids in ``repr`` order); prepare sizes it
    for a history instead, from every element the history names."""
    from jepsen_tpu_torch import models as m

    if isinstance(model, m.CASRegister):
        return cas_register_kernel()
    if isinstance(model, m.Register):
        return register_kernel()
    if isinstance(model, m.Mutex):
        return mutex_kernel(model.locked)
    if isinstance(model, m.SetModel):
        n = len(model.s)
        return set_kernel(max(1, n), range(n))
    if isinstance(model, m.FIFOQueue):
        ids = {v: i for i, v in enumerate(sorted(set(model.pending),
                                                 key=repr))}
        return fifo_queue_kernel(len(model.pending),
                                 [ids[v] for v in model.pending])
    if isinstance(model, m.UnorderedQueue):
        ids = {v: i for i, v in enumerate(sorted(set(model.pending),
                                                 key=repr))}
        initial = [ids[v] for v in model.pending]
        if len(set(initial)) == len(initial):
            return unordered_unique_kernel(len(ids), initial)
        return unordered_queue_kernel(len(ids), initial)
    raise ValueError(
        f"no step kernel for model {type(model).__name__}; the port "
        "supports register/cas-register/mutex/set/unordered-queue/"
        "fifo-queue")
