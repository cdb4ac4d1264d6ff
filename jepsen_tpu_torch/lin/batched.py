"""Batched per-key linearizability: one device search over many keys.

The device counterpart of :mod:`jepsen_tpu_torch.independent`'s checker:
every key's packed history joins one batch on a leading key axis, and one
search decides all keys of a group. The dense batch launches the dense
CUDA kernel once over a grid of keys, one block a key
(:func:`jepsen_tpu_torch.lin.dense_cuda.dense_chunk_batch`); a group
outside the dense bounds runs the multiword sparse search with a key axis
(:func:`jepsen_tpu_torch.lin.bfs._search_chunk`), its rows padded to a
common shape with identity rows. The port of :mod:`jepsen_tpu.lin.batched`,
where both are ``jax.vmap`` over keys.

Not ported yet: the stream batch (``try_stream_batch``), the trace spans
and the progress ticks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from jepsen_tpu_torch import _u32, resolve_device
from jepsen_tpu_torch.lin import bfs, prepare
from jepsen_tpu_torch.lin.prepare import PackedHistory
from jepsen_tpu_torch.models.kernels import F_NOOP

BATCH_CAP_SCHEDULE = (64, 1024)


@dataclass
class Decline:
    """Why a key group could NOT batch: the shape axis that failed. It is
    FALSY, so ``result or fallback`` call sites keep working.

    axis: "prepare" (history unpackable), "kernel" (model has no device
    kernel), "dense-plan" (outside the dense engine's bounds), "rows" /
    "bitmap-words" / "table-cells" (dense batch resource ceilings),
    "window" (past the sparse bitset), "frontier-overflow" (the batched
    sparse search overflowed its top capacity)."""

    axis: str
    detail: str = ""
    keys: list = field(default_factory=list)

    def __bool__(self) -> bool:
        return False

    def as_dict(self) -> dict:
        return {"axis": self.axis, "detail": self.detail,
                "keys": [repr(k) for k in self.keys[:8]]}


# Dense-batch resource ceilings, the reference's: one launch carries K
# bitmaps of 2**w words plus [K, r_pad, w] tables. They decide which keys
# batch, and so the result; past them a Decline names the axis and the
# group tries the sparse batch.
MAX_BATCH_BITMAP_WORDS = 1 << 24      # 64 MiB of frontier bitmaps
MAX_BATCH_TABLE_CELLS = 1 << 27       # [K, r_pad, w] table budget
MAX_BATCH_ROWS = 1 << 14


def _result_rows(packed, ks, dead, r_done, analyzer) -> dict:
    """Per-key verdict dicts from a batched search's (dead, rows_done)."""
    results = {}
    for i, k in enumerate(ks):
        p = packed[k]
        if not dead[i]:
            results[k] = {"valid?": True, "analyzer": analyzer,
                          "configs": [], "final-paths": []}
        else:
            r = int(r_done[i]) - 1
            ret = p.ops[int(p.ret_op[r])] if 0 <= r < p.R else None
            results[k] = {
                "valid?": False, "analyzer": analyzer, "dead-row": r,
                "op": None if ret is None else
                {"process": ret.process, "f": ret.f, "value": ret.value,
                 "index": ret.op_index, "ok": ret.ok},
                "configs": [], "final-paths": []}
    return results


def row_pad(r_max: int) -> int:
    """A batch's padded row count for its longest key's ``r_max`` rows:
    the next power of two, at least 16."""
    return 1 << max(4, (r_max - 1).bit_length())


@dataclass
class DenseBatch:
    """One dense batch as :func:`_try_dense_batch` launches it: the keys in
    launch order, their :func:`dense.plan`, the group's bitmap width ``w``
    and state count ``ns`` (its maxima, as the reference's vmap carries),
    the padded row count and the kernel's inputs."""

    keys: list
    plans: list
    w: int
    ns: int
    r_pad: int
    inp: object


def dense_batch(packed: dict, device) -> DenseBatch | Decline:
    """The dense batch of a key group on ``device``, or a falsy
    :class:`Decline` naming the shape axis when any key falls outside the
    dense bounds or the batch exceeds the resource ceilings."""
    from jepsen_tpu_torch.lin import dense

    plans = {}
    for k, p in packed.items():
        pl = dense.plan(p)
        if pl is None:
            return Decline(
                "dense-plan",
                f"window {p.window} / state shape outside the dense "
                f"engine bounds", keys=[k])
        plans[k] = pl

    w = max(pl[0] for pl in plans.values())
    ns = max(pl[1] for pl in plans.values())
    r_pad = row_pad(max(p.R for p in packed.values()))
    ks = sorted(packed, key=repr)
    K = len(ks)
    if r_pad > MAX_BATCH_ROWS:
        return Decline("rows", f"r_pad {r_pad} > {MAX_BATCH_ROWS}",
                       keys=ks)
    if K * (1 << w) > MAX_BATCH_BITMAP_WORDS:
        return Decline(
            "bitmap-words",
            f"{K} keys x 2^{w} words > {MAX_BATCH_BITMAP_WORDS}",
            keys=ks)
    if K * r_pad * w > MAX_BATCH_TABLE_CELLS:
        return Decline(
            "table-cells",
            f"{K} x {r_pad} x {w} cells > {MAX_BATCH_TABLE_CELLS}",
            keys=ks)
    plan_list = [plans[k] for k in ks]
    inp = dense.batch_inputs([packed[k] for k in ks], plan_list, w, ns,
                             r_pad, device)
    return DenseBatch(ks, plan_list, w, ns, r_pad, inp)


def _try_dense_batch(packed: dict, device) -> dict | Decline:
    """Batch all keys through the dense bitmap engine: one launch of the
    dense kernel over a grid of keys. Each key's row count, state count
    (nil_id) and initial state ride the batch, so no identity-row
    padding is needed and crashed-op keys cost nothing. Returns {key:
    result}, or the :class:`Decline` of :func:`dense_batch` (the caller
    tries the sparse batch)."""
    from jepsen_tpu_torch.lin import dense_cuda

    b = dense_batch(packed, device)
    if isinstance(b, Decline):
        return b
    res = dense_cuda.dense_chunk_batch(b.inp.F, b.inp.n_rows, b.inp.masks,
                                       b.inp.ret_slot, w=b.w, ns=b.ns)
    # The one blocking transfer: every key's flags.
    state = res.state.cpu().numpy()
    dense_cuda.check_batch_state(state)
    r_done, dead, trunc = state[:, 0], state[:, 1] != 0, state[:, 2] != 0
    ks = b.keys
    results = _result_rows(packed, ks, dead, r_done, "gpu-dense-batch")
    # A key whose closure hit the pass ceiling with changes pending
    # answers an honest unknown, never a verdict off an incomplete
    # frontier (dense.check_packed's twin).
    for i, k in enumerate(ks):
        if trunc[i]:
            results[k] = {"valid?": "unknown",
                          "analyzer": "gpu-dense-batch",
                          "overflow": "budget",
                          "error": "dense closure pass ceiling hit "
                                   "with changes pending"}
    return results


def _pad_to(p: PackedHistory, r_pad: int, w_pad: int, nw: int):
    """Pad one packed history to (r_pad, w_pad + 1): columns beyond the
    key's own window are inactive; missing rows are identity rows on the
    shared pad slot w_pad. Reduction tables pad inert (the pad slot is
    impure and unchained)."""
    R, W = p.active.shape
    vw = p.slot_v.shape[2]
    ret_slot = np.concatenate(
        [p.ret_slot, np.full(r_pad - R, w_pad, np.int32)])
    active = np.zeros((r_pad, w_pad + 1), bool)
    active[:R, :W] = p.active
    active[R:, w_pad] = True
    slot_f = np.zeros((r_pad, w_pad + 1), np.int32)
    slot_f[:R, :W] = p.slot_f
    slot_f[R:, w_pad] = F_NOOP
    slot_v = np.zeros((r_pad, w_pad + 1, vw), np.int32)
    slot_v[:R, :W] = p.slot_v
    pure_k, pred_bit_k = bfs.reduction_bit_tables(p, nw)
    pure = np.zeros((r_pad, w_pad + 1), bool)
    pure[:R, :W] = pure_k
    pred_bit = np.zeros((r_pad, w_pad + 1, nw), np.uint32)
    pred_bit[:R, :W] = pred_bit_k
    return ret_slot, active, slot_f, slot_v, pure, pred_bit


def try_check_batch(model, subs: dict, declines: list | None = None,
                    device=None) -> dict | None:
    """Check keys' subhistories in batched device searches on ``device``
    (the card when None; raises without one). Keys are GROUPED by (step
    function, state shape): each homogeneous group batches on its own.
    Returns {key: result} covering every key that batched (possibly a
    subset: the caller checks leftovers per key), or None when nothing
    could batch.

    ``declines``, when given a list, collects one :class:`Decline` per
    key or group that could NOT batch. A ``subs`` value may be a raw
    history or an already-packed :class:`PackedHistory`, used as-is."""
    device = resolve_device(device)
    if not subs:
        return {}
    packed: dict = {}
    for k, sub in subs.items():
        try:
            p = sub if isinstance(sub, PackedHistory) \
                else prepare.prepare(model, sub)
        except prepare.UnsupportedHistory as e:
            if declines is not None:
                declines.append(Decline("prepare", str(e), keys=[k]))
            continue
        if p.kernel is None:
            if declines is not None:
                declines.append(Decline(
                    "kernel", "model/history has no device kernel",
                    keys=[k]))
            continue
        packed[k] = p

    groups: dict = {}
    for k, p in packed.items():
        sig = (p.kernel.step, tuple(p.init_state.shape))
        groups.setdefault(sig, {})[k] = p

    results: dict = {}
    for group in groups.values():
        r = _check_group(group, device)
        if isinstance(r, Decline):
            if declines is not None:
                declines.append(r)
            continue
        results.update(r)
    return results or None


def _check_group(packed: dict, device) -> dict | Decline:
    """One homogeneous (shared step fn + state shape) key group through
    the dense batch, then the sparse batch. A falsy :class:`Decline` when
    the group cannot run on the device (window overflow, or frontier
    overflow at the top capacity)."""
    dense_res = _try_dense_batch(packed, device)
    if not isinstance(dense_res, Decline):
        return dense_res
    dense_decline = dense_res

    ks, w_pad, nw, r_pad = sparse_batch_shape(packed)
    if w_pad + 1 > bfs.MAX_DEVICE_WINDOW:
        return Decline(
            "window",
            f"padded window {w_pad + 1} > device bitset "
            f"{bfs.MAX_DEVICE_WINDOW} (dense declined: "
            f"{dense_decline.axis})", keys=ks)
    if all(p.R == 0 for p in packed.values()):
        return {k: {"valid?": True, "analyzer": "gpu-bfs-batch"}
                for k in packed}

    tables = sparse_batch_tables([packed[k] for k in ks], r_pad, w_pad, nw,
                                 device)
    step_fn = packed[ks[0]].kernel.step
    for cap in BATCH_CAP_SCHEDULE:
        bits, state, count = sparse_batch_entry(
            [packed[k] for k in ks], cap, nw, device)
        _, _, _, rows, dead, overflow = bfs._search_chunk(
            r_pad, *tables, bits, state, count, cap=cap, step_fn=step_fn)
        if not bool(overflow.any()):
            break
    if bool(overflow.any()):
        return Decline(
            "frontier-overflow",
            f"vmapped sparse search overflowed cap "
            f"{BATCH_CAP_SCHEDULE[-1]} (dense declined: "
            f"{dense_decline.axis})", keys=ks)

    return _result_rows(packed, ks, (dead | overflow).cpu().numpy(),
                        rows.cpu().numpy(), "gpu-bfs-batch")


def sparse_batch_shape(packed: dict) -> tuple:
    """The sparse batch's shape for a key group: (keys in batch order,
    padded window w_pad, bit words nw of its w_pad + 1 slots, r_pad)."""
    w_pad = max(p.window for p in packed.values())
    return (sorted(packed, key=repr), w_pad, (w_pad + 1 + 31) // 32,
            row_pad(max(p.R for p in packed.values())))


def sparse_batch_tables(packed: list, r_pad: int, w_pad: int, nw: int,
                        device) -> tuple:
    """The sparse batch's row tables for :func:`bfs._search_chunk`, each
    key padded by :func:`_pad_to` and stacked on the key axis, on
    ``device``: (ret_slot, active, slot_f, slot_v, pure, pred_bit)."""
    rows = [_pad_to(p, r_pad, w_pad, nw) for p in packed]

    def put(i, dtype=torch.int64):
        a = np.stack([r[i] for r in rows])
        if a.dtype == np.uint32:
            return _u32.widen(torch.from_numpy(a.view(np.int32))
                              .to(device))
        return torch.from_numpy(a).to(device, dtype)

    return (put(0), put(1, torch.bool), put(2), put(3), put(4, torch.bool),
            put(5))


def sparse_batch_entry(packed: list, cap: int, nw: int, device) -> tuple:
    """The sparse batch's entry frontiers at capacity ``cap``: one config
    a key (empty bitset, the key's initial state), as int64 (bits [K,
    cap, NW], state [K, cap, S], count [K]) on ``device``."""
    init = torch.from_numpy(np.stack([p.init_state for p in packed])) \
        .to(device, torch.int64)
    K, S = init.shape
    bits = torch.zeros((K, cap, nw), dtype=torch.int64, device=device)
    state = torch.zeros((K, cap, S), dtype=torch.int64, device=device)
    state[:, 0] = init
    return bits, state, torch.ones(K, dtype=torch.int64, device=device)
