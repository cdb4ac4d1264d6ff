"""Dense config-space bitmap engine for the linearizability search.

With the slot-compressed window W (:mod:`jepsen_tpu_torch.lin.prepare`)
and a one-word model state of NS <= 32 values, the whole config space has
``2**W * NS`` points, so the frontier is kept as its characteristic
function, a u32[2**W] bitmap::

    bit s of word B  ==  config (linearized-bitset B, state s) reachable

- *Linearize pending op in slot j*: words with bit j clear contribute to
  words with bit j set, through the op's transition masks.
- *Return of slot s*: keep words with bit s, clear it.
- *Crashed ops* keep their slot bit forever; the bitmap's size is fixed up
  front, so they need nothing else.

The search runs chunk by chunk over the return events: each chunk is one
launch of :func:`jepsen_tpu_torch.lin.dense_cuda.dense_chunk` (the CUDA
kernel on the card, its plain torch version on the CPU), and the host's
only blocking fetch per chunk is the flag word (dead / trunc / rows
done). Chunk-entry bitmaps can be kept (``snapshots=``) so a
counterexample pass replays just the failing tail on the CPU oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jepsen_tpu_torch import _u32, resolve_device
from jepsen_tpu_torch.lin import dense_cuda
from jepsen_tpu_torch.lin.prepare import PackedHistory
from jepsen_tpu_torch.models.kernels import (NIL, PACKED_STATE_KERNELS,
                                             packed_state_bound)

# Largest window the dense representation takes: 2**20 words = 4 MiB.
MAX_DENSE_WINDOW = 20
# States must fit one u32 word of bitmap per bitset row.
MAX_DENSE_STATES = 32
# Return events per kernel launch. The JAX package's value, kept until a
# measurement on the H100 sets it; it also bounds the counterexample
# tail replay (one chunk).
CHUNK = 16384

_W_BUCKETS = (4, 6, 8, 10, 12, 14, 16, 18, 20)
_NS_BUCKETS = (4, 8, 16, 32)


def plan(p: PackedHistory):
    """Dense-searchability test. Returns ``(w, ns, nil_id, init_id)`` with
    bucketed w/ns, or None when this history needs the sparse engine."""
    if p.kernel is None or p.kernel.name not in PACKED_STATE_KERNELS:
        return None
    if p.state_width != 1 or p.window > MAX_DENSE_WINDOW:
        return None
    # State ids range over the intern table (a one-word set: over its
    # element bitmasks); NIL is remapped to the id just past them (nil_id).
    nid = packed_state_bound(p.kernel, len(p.unintern))
    if nid + 1 > MAX_DENSE_STATES:
        return None
    w = next(b for b in _W_BUCKETS if b >= p.window)
    ns = next(b for b in _NS_BUCKETS if b >= nid + 1)
    init = int(p.init_state[0])
    init_id = nid if init == int(NIL) else init
    return w, ns, nid, init_id


def transition_tables(slot_f, slot_v, active, nil_id, *, ns, step_fn):
    """Per-(row, slot, state) transition tables from the model step
    kernel: ok bool[CH,w,ns] legality and to int64[CH,w,ns] successor
    state id, from ``slot_f`` [CH,w], ``slot_v`` [CH,w,VW] and ``active``
    bool[CH,w] on one device. State id ``nil_id`` stands for NIL; ids past
    it map to raw ids and are masked inert, and ``to`` is clipped into
    [0, ns-1], as :func:`jepsen_tpu.lin.dense.transition_tables` does.

    With a leading key axis (``slot_f`` [K,CH,w] ...), ``nil_id`` may be
    an int64 tensor [K], each key's own, as each lane of the XLA twin's
    vmap has its own; the tables are then [K,CH,w,ns]."""
    dev = slot_f.device
    sid = torch.arange(ns, dtype=torch.int64, device=dev)
    nid = torch.as_tensor(nil_id, dtype=torch.int64, device=dev)
    nid = nid.reshape(nid.shape + (1, 1, 1))          # over [.., CH, w, ns]
    states = torch.where(sid == nid, int(NIL), sid).unsqueeze(-1)
    ok, new = step_fn(states,
                      slot_f.to(torch.int64).unsqueeze(-1),
                      slot_v.to(torch.int64).unsqueeze(-2))
    to = new[..., 0]
    to = torch.where(to == int(NIL), nid, to).clamp(0, ns - 1)
    ok = ok & active.unsqueeze(-1) & (sid <= nid)
    return ok, to


def _pad_w(a: np.ndarray, wc: int) -> np.ndarray:
    """Columns 0..wc-1 of a [rows, W, ...] table; slots past W are
    inactive (zero) and slots past wc are inactive in this chunk."""
    if a.shape[1] >= wc:
        return a[:, :wc]
    pad = [(0, 0)] * a.ndim
    pad[1] = (0, wc - a.shape[1])
    return np.pad(a, pad)


def chunk_inputs(p: PackedHistory, base: int, n: int, w: int, ns: int,
                 nil_id: int, device):
    """The kernel's inputs for return events [base, base + n) at bitmap
    width w: ``(masks, ret_slot)`` on ``device``."""
    sl = slice(base, base + n)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(_pad_w(a[sl], w))) \
            .to(device)

    masks = dense_cuda.transition_masks(
        put(p.slot_f), put(p.slot_v), put(p.active), nil_id, ns=ns,
        step_fn=p.kernel.step)
    ret = torch.from_numpy(np.ascontiguousarray(p.ret_slot[sl])).to(device)
    return masks, ret


class BatchInputs(NamedTuple):
    """The dense kernel's inputs for K keys (:func:`batch_inputs`), on one
    device: ``F`` raw int32[K, 2**w] entry bitmaps (``1 << init_id`` in
    word 0), ``n_rows`` int32[K] (each key's R), ``masks`` raw
    int32[K, r_pad, w, ns] and ``ret_slot`` int32[K, r_pad]."""

    F: torch.Tensor
    n_rows: torch.Tensor
    masks: torch.Tensor
    ret_slot: torch.Tensor


def batch_inputs(packed: list, plans: list, w: int, ns: int, r_pad: int,
                 device) -> BatchInputs:
    """Every key's whole history as one chunk at the group's bitmap width
    ``w`` and state count ``ns`` (its maxima, so that each key's bitmap is
    the one the XLA twin's vmap carries), rows padded to ``r_pad``. The
    host stacks the keys' tables once; the transition masks of all keys
    come from one torch pass on ``device``, each key with its own
    ``nil_id`` (``plans[k]`` is :func:`plan` of ``packed[k]``)."""
    K = len(packed)
    vw = packed[0].slot_v.shape[2]
    slot_f = np.zeros((K, r_pad, w), np.int32)
    slot_v = np.zeros((K, r_pad, w, vw), np.int32)
    active = np.zeros((K, r_pad, w), bool)
    ret_slot = np.zeros((K, r_pad), np.int32)
    F0 = np.zeros((K, 1 << w), np.uint32)
    n_rows = np.zeros(K, np.int32)
    nil_ids = np.zeros(K, np.int64)
    for k, (p, (_, _, nil_id, init_id)) in enumerate(zip(packed, plans)):
        R, W = p.active.shape
        slot_f[k, :R, :W] = p.slot_f
        slot_v[k, :R, :W] = p.slot_v
        active[k, :R, :W] = p.active
        ret_slot[k, :R] = p.ret_slot
        F0[k, 0] = np.uint32(1) << np.uint32(init_id)
        n_rows[k] = R
        nil_ids[k] = nil_id

    def put(a):
        return torch.from_numpy(a).to(device)

    masks = dense_cuda.transition_masks(
        put(slot_f), put(slot_v), put(active), put(nil_ids), ns=ns,
        step_fn=packed[0].kernel.step)
    return BatchInputs(_u32.bitmap_from_numpy(F0, device), put(n_rows),
                       masks.contiguous(), put(ret_slot))


def check_packed(p: PackedHistory, chunk: int = CHUNK, cancel=None,
                 snapshots: list | None = None, explain: bool = False,
                 device=None) -> dict:
    """Decide linearizability of a packed history with the dense engine.

    The frontier stays on ``device`` between chunk launches; the host's
    only blocking fetch per chunk is the flag word, which gives early exit
    on invalid histories and a prompt race cancel. ``snapshots``, if a
    list, receives ``(base_row, entry_bitmap)`` pairs (raw int32 tensors)
    for witness reconstruction; ``explain=True`` keeps the last one and,
    on an invalid verdict, replays the failing tail on the CPU oracle to
    emit configs + final-paths (:mod:`jepsen_tpu_torch.lin.witness`).
    ``cancel`` (threading.Event) stops between chunks."""
    device = resolve_device(device)
    pl = plan(p)
    if pl is None:
        return {"valid?": "unknown", "analyzer": "gpu-dense",
                "error": "history outside dense engine bounds"}
    w, ns, nil_id, init_id = pl
    backend = "cuda" if device.type == "cuda" else "plain"
    # Explicit callers get every chunk-entry snapshot; explain only ever
    # replays from the last one (the dead row is inside the current
    # chunk), so it keeps just that.
    keep_all = snapshots is not None
    if explain and snapshots is None:
        snapshots = []
    if p.R == 0:
        return {"valid?": True, "analyzer": "gpu-dense", "configs": []}

    # Slot indices grow monotonically (freed slots are reused low-first,
    # crashed slots accumulate upward), so early chunks run on a smaller
    # bitmap: per-chunk width = that chunk's highest active slot,
    # bucketed. Growing between chunks is a zero-pad of F.
    W = p.window
    active_h = np.asarray(p.active)
    row_hi = np.where(active_h.any(axis=1),
                      W - np.argmax(active_h[:, ::-1], axis=1), 1)

    def bucket_w(need):
        return next(b for b in _W_BUCKETS if b >= need)

    w_cur = bucket_w(int(row_hi[:min(chunk, p.R)].max()))
    F = torch.zeros(1 << w_cur, dtype=torch.int32, device=device)
    F[0] = _u32.raw_word(1 << init_id)

    base = 0
    while base < p.R:
        if cancel is not None and cancel.is_set():
            return {"valid?": "unknown", "analyzer": "gpu-dense",
                    "error": "cancelled"}
        n = min(chunk, p.R - base)
        w_c = bucket_w(int(row_hi[base:base + n].max()))
        if w_c > w_cur:
            F = torch.cat([F, torch.zeros((1 << w_c) - (1 << w_cur),
                                          dtype=torch.int32,
                                          device=device)])
            w_cur = w_c
        if snapshots is not None:
            if keep_all:
                snapshots.append((base, F))
            else:
                snapshots[:] = [(base, F)]
        masks, ret = chunk_inputs(p, base, n, w_cur, ns, nil_id, device)
        res = dense_cuda.dense_chunk(F, n, masks, ret, w=w_cur, ns=ns)
        F = res.F
        # The one blocking transfer per chunk carries every flag.
        rows_done, dead, trunc = res.state[:3].tolist()
        if trunc:
            # The closure ceiling fired with changes pending: the frontier
            # is incomplete, so neither verdict is trustworthy.
            return {"valid?": "unknown", "analyzer": "gpu-dense",
                    "backend": backend, "overflow": "budget",
                    "error": f"dense closure pass ceiling hit with "
                             f"changes pending near row {base} "
                             f"(non-monotone closure edit?)"}
        if dead:
            r = base + rows_done - 1
            ret_op = p.ops[int(p.ret_op[r])]
            out = {"valid?": False, "analyzer": "gpu-dense",
                   "backend": backend, "dead-row": r,
                   "op": {"process": ret_op.process, "f": ret_op.f,
                          "value": ret_op.value, "index": ret_op.op_index,
                          "ok": ret_op.ok},
                   "configs": [], "final-paths": []}
            if explain and snapshots and \
                    not (cancel is not None and cancel.is_set()):
                from jepsen_tpu_torch.lin import witness

                out.update(witness.tail_replay(p, nil_id, snapshots, r,
                                               cancel=cancel))
            return out
        base += n

    return {"valid?": True, "analyzer": "gpu-dense", "backend": backend,
            "final-frontier-popcount": _u32.popcount(F),
            "configs": []}


def decode_bitmap(F, nil_id: int) -> list[tuple[int, tuple]]:
    """Host-side decode of a frontier bitmap (raw int32 tensor or numpy
    u32 array) into (bitset, state-word) configs in the CPU oracle's
    representation (state NIL-restored)."""
    if isinstance(F, torch.Tensor):
        F = _u32.bitmap_to_numpy(F)
    F = np.asarray(F).astype(np.uint32)
    out = []
    for B in np.nonzero(F)[0]:
        word = int(F[B])
        s = 0
        while word:
            if word & 1:
                sv = int(NIL) if s == nil_id else s
                out.append((int(B), (sv,)))
            word >>= 1
            s += 1
    return out
