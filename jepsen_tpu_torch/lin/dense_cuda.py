"""The dense engine's chunk step: a CUDA kernel for Hopper, its binding,
and its plain torch version.

:func:`dense_chunk` advances the frontier bitmap through up to ``n_rows``
return events (``csrc/dense_chunk.cu`` says how). It replaces the TPU
kernel :func:`jepsen_tpu.lin.dense_pallas.pallas_chunk`. On a CUDA tensor
it launches the kernel (or raises); on a CPU tensor it runs
:func:`dense_chunk_plain`, the same function in torch ops, which the
tests hold against the JAX package and ``chip_smoke.py`` holds the kernel
against on the card.

Words are u32 in meaning and travel as raw int32 tensors
(:mod:`jepsen_tpu_torch._u32`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from jepsen_tpu_torch import _build, _u32

MAX_W = 20
MAX_NS = 32
# Widest bitmap the bit-sliced kernel keeps in shared memory (kSharedMaxW
# in csrc/dense_chunk.cu): 32 state slices of 2**(w - 5) words, 4 * 2**w
# bytes, 128 KiB at w = 15. Wider ones run the device-memory kernel.
SHARED_MAX_W = 15

# Kernel launches since import (or since a caller reset it): one per
# launch of the CUDA kernel, none for the plain version. BATCH_LAUNCHES
# counts the launches over a grid of keys (:func:`dense_chunk_batch`).
LAUNCHES = 0
BATCH_LAUNCHES = 0
# rows_done of a batched key whose row count lies outside its tables.
BAD_ROWS = -1

_lib = None


class ChunkResult(NamedTuple):
    """``F``: the advanced bitmap (raw int32[2**w]). ``state``: int32[5] =
    (rows_done, dead, trunc, passes, sweeps) on F's device, so one copy
    to the host reads every flag. ``rows_done`` counts the dead row
    itself; ``passes`` counts the closure passes the chunk ran and
    ``sweeps`` the (pass, slot with transitions) pairs, the work its data
    needed."""

    F: torch.Tensor
    state: torch.Tensor

    @property
    def rows_done(self) -> torch.Tensor:
        return self.state[0]

    @property
    def dead(self) -> torch.Tensor:
        return self.state[1] != 0

    @property
    def trunc(self) -> torch.Tensor:
        return self.state[2] != 0

    @property
    def passes(self) -> torch.Tensor:
        return self.state[3]

    @property
    def sweeps(self) -> torch.Tensor:
        return self.state[4]


def transition_masks(slot_f, slot_v, active, nil_id, *, ns, step_fn):
    """Raw int32[CH, w, ns] transition masks: bit s of mask[r, j, s'] is
    set iff op (r, j) is active, legal in state s, and maps s to s'.
    Built from :func:`jepsen_tpu_torch.lin.dense.transition_tables` on
    the tables' device; bit-identical to
    :func:`jepsen_tpu.lin.dense_pallas.transition_masks`."""
    from jepsen_tpu_torch.lin.dense import transition_tables

    ok, to = transition_tables(slot_f, slot_v, active, nil_id, ns=ns,
                               step_fn=step_fn)
    src_bit = torch.ones(ns, dtype=torch.int64, device=ok.device) \
        << torch.arange(ns, device=ok.device)
    masks = torch.stack(
        [((ok & (to == t)).to(torch.int64) * src_bit).sum(-1)
         for t in range(ns)], dim=-1)
    return _u32.narrow(masks)


def _check_args(F, n_rows, masks, ret_slot, w, ns):
    if not 1 <= w <= MAX_W or not 1 <= ns <= MAX_NS:
        raise ValueError(f"dense_chunk takes 1 <= w <= {MAX_W} and "
                         f"1 <= ns <= {MAX_NS}, got w={w} ns={ns}")
    if F.dtype != torch.int32 or tuple(F.shape) != (1 << w,):
        raise ValueError(f"F must be int32[{1 << w}], got "
                         f"{F.dtype}{list(F.shape)}")
    if masks.dtype != torch.int32 or masks.dim() != 3 \
            or tuple(masks.shape[1:]) != (w, ns):
        raise ValueError(f"masks must be int32[rows, {w}, {ns}], got "
                         f"{masks.dtype}{list(masks.shape)}")
    if ret_slot.dtype != torch.int32 or ret_slot.dim() != 1:
        raise ValueError(f"ret_slot must be int32[rows], got "
                         f"{ret_slot.dtype}{list(ret_slot.shape)}")
    if not 0 <= n_rows <= min(masks.shape[0], ret_slot.shape[0]):
        raise ValueError(f"n_rows={n_rows} outside the tables "
                         f"({masks.shape[0]}, {ret_slot.shape[0]} rows)")
    if not F.device == masks.device == ret_slot.device:
        raise ValueError("F, masks and ret_slot must share a device")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("dense_chunk")
        fn = lib.dense_chunk_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.dense_chunk_batch_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dense_chunk_shared_max_w.argtypes = []
        lib.dense_chunk_shared_max_w.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_path(w: int) -> str:
    """The kernel a chunk of width ``w`` runs: "sliced" (the bitmap as
    state slices in shared memory) up to :data:`SHARED_MAX_W`, else
    "device" (the bitmap in device memory)."""
    if not 1 <= w <= MAX_W:
        raise ValueError(f"dense_chunk takes 1 <= w <= {MAX_W}, got {w}")
    return "sliced" if w <= SHARED_MAX_W else "device"


def shared_max_w() -> int:
    """Widest bitmap the kernel keeps in shared memory; wider ones live
    in device memory."""
    return int(_load().dense_chunk_shared_max_w())


def dense_chunk(F, n_rows: int, masks, ret_slot, *, w: int,
                ns: int) -> ChunkResult:
    """Advance the frontier bitmap ``F`` (raw int32[2**w]) through up to
    ``n_rows`` return events with transition masks ``masks`` (raw
    int32[rows, w, ns]) and returning slots ``ret_slot`` (int32[rows]).
    CUDA tensors launch the kernel on the current stream (no sync, no
    allocation inside the kernel); CPU tensors run the plain version."""
    global LAUNCHES
    _check_args(F, n_rows, masks, ret_slot, w, ns)
    if F.device.type == "cpu":
        return dense_chunk_plain(F, n_rows, masks, ret_slot, w=w, ns=ns)
    if F.device.type != "cuda":
        raise ValueError(f"dense_chunk runs on cuda or cpu, not {F.device}")
    if not (F.is_contiguous() and masks.is_contiguous()
            and ret_slot.is_contiguous()):
        raise ValueError("dense_chunk needs contiguous tensors")
    lib = _load()
    F_out = torch.empty_like(F)
    state = torch.empty(5, dtype=torch.int32, device=F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        rc = lib.dense_chunk_launch(
            F.data_ptr(), F_out.data_ptr(), masks.data_ptr(),
            ret_slot.data_ptr(), int(n_rows), int(w), int(ns),
            state.data_ptr(), stream)
    if rc != 0:
        raise _build.LaunchError(
            f"dense_chunk kernel launch failed: CUDA error "
            f"{rc} (w={w}, ns={ns}, n_rows={n_rows})")
    LAUNCHES += 1
    return ChunkResult(F_out, state)


def dense_chunk_plain(F, n_rows: int, masks, ret_slot, *, w: int,
                      ns: int) -> ChunkResult:
    """:func:`dense_chunk` in plain torch ops on int64 words, on any
    device. It follows :func:`jepsen_tpu.lin.dense._dense_chunk` step for
    step: the same Gauss-Seidel pass over slots, the same do-while to
    fixpoint with its w + 2 pass ceiling, the same trunc and dead flags."""
    _check_args(F, n_rows, masks, ret_slot, w, ns)
    dev = F.device
    Fw = _u32.widen(F)                    # a fresh tensor: updated in place
    mw = _u32.widen(masks[:n_rows])
    live = (mw != 0).any(-1).tolist()     # [rows][w]: slot has transitions
    rs = ret_slot[:n_rows].tolist()
    shifts = torch.arange(ns, device=dev)
    rows_done = dead = trunc = passes = sweeps = 0

    def closure_pass(r):
        for j in range(w):
            if not live[r][j]:
                continue                  # an inactive slot adds nothing
            # Bit-j-clear words are index 0 of the middle axis; they
            # contribute to their bit-j-set partners at index 1.
            F3 = Fw.view(-1, 2, 1 << j)
            hit = (F3[:, 0, :].unsqueeze(-1) & mw[r, j]) != 0
            F3[:, 1, :] |= (hit.to(torch.int64) << shifts).sum(-1)

    for r in range(n_rows):
        it = 0
        while True:
            prev = Fw.clone()
            closure_pass(r)
            it += 1
            changed = not torch.equal(Fw, prev)
            if not changed or it >= w + 2:
                break
        passes += it
        sweeps += it * sum(live[r])
        trunc = int(changed)
        # Return filter for slot s: F'[B] = F[B | 2**s] where bit s of B
        # is clear, 0 where it is set. The XLA formulation writes this as
        # a roll of the bit-s-set words by -2**s; the roll only ever
        # wraps zeros, so the pairwise move below is the same map.
        s = rs[r]
        if 0 <= s < w:
            F3 = Fw.view(-1, 2, 1 << s)
            F3[:, 0, :] = F3[:, 1, :]
            F3[:, 1, :] = 0
        else:
            Fw.zero_()                    # (iota >> s) & 1 keeps nothing
        rows_done = r + 1
        dead = int(not bool(Fw.any()))
        if dead or trunc:
            break
    state = torch.tensor([rows_done, dead, trunc, passes, sweeps],
                         dtype=torch.int32, device=dev)
    return ChunkResult(_u32.narrow(Fw), state)


def _check_batch_args(F, n_rows, masks, ret_slot, w, ns):
    if not 1 <= w <= MAX_W or not 1 <= ns <= MAX_NS:
        raise ValueError(f"dense_chunk_batch takes 1 <= w <= {MAX_W} and "
                         f"1 <= ns <= {MAX_NS}, got w={w} ns={ns}")
    if F.dtype != torch.int32 or F.dim() != 2 or F.shape[1] != 1 << w \
            or F.shape[0] < 1:
        raise ValueError(f"F must be int32[keys, {1 << w}], got "
                         f"{F.dtype}{list(F.shape)}")
    keys = F.shape[0]
    if masks.dtype != torch.int32 or masks.dim() != 4 \
            or masks.shape[0] != keys or tuple(masks.shape[2:]) != (w, ns):
        raise ValueError(f"masks must be int32[{keys}, rows, {w}, {ns}], "
                         f"got {masks.dtype}{list(masks.shape)}")
    if ret_slot.dtype != torch.int32 \
            or tuple(ret_slot.shape) != tuple(masks.shape[:2]):
        raise ValueError(f"ret_slot must be int32{list(masks.shape[:2])}, "
                         f"got {ret_slot.dtype}{list(ret_slot.shape)}")
    if n_rows.dtype != torch.int32 or tuple(n_rows.shape) != (keys,):
        raise ValueError(f"n_rows must be int32[{keys}], got "
                         f"{n_rows.dtype}{list(n_rows.shape)}")
    if not F.device == masks.device == ret_slot.device == n_rows.device:
        raise ValueError("F, n_rows, masks and ret_slot must share a device")


def dense_chunk_batch(F, n_rows, masks, ret_slot, *, w: int,
                      ns: int) -> ChunkResult:
    """:func:`dense_chunk` for K independent keys at once: key k advances
    ``F[k]`` (raw int32[keys, 2**w]) through its first ``n_rows[k]``
    (int32[keys]) return events of ``masks[k]`` (raw int32[keys, r_pad,
    w, ns]) and ``ret_slot[k]`` (int32[keys, r_pad]), and stops at its
    own dead row or pass ceiling. Returns ``F`` [keys, 2**w] and
    ``state`` int32[keys, 5], row k as :class:`ChunkResult` describes.
    A key whose row count lies outside [0, r_pad] runs no row: its bitmap
    passes through and its state row reads rows_done = -1
    (:data:`BAD_ROWS`), which :func:`check_batch_state` rejects once the
    host holds the state. CUDA tensors launch the kernel once, one block a
    key, on the current stream (no sync); CPU tensors run
    :func:`dense_chunk_batch_plain`, which answers the same."""
    global BATCH_LAUNCHES
    _check_batch_args(F, n_rows, masks, ret_slot, w, ns)
    if F.device.type == "cpu":
        return dense_chunk_batch_plain(F, n_rows, masks, ret_slot, w=w,
                                       ns=ns)
    if F.device.type != "cuda":
        raise ValueError(f"dense_chunk_batch runs on cuda or cpu, not "
                         f"{F.device}")
    if not (F.is_contiguous() and masks.is_contiguous()
            and ret_slot.is_contiguous() and n_rows.is_contiguous()):
        raise ValueError("dense_chunk_batch needs contiguous tensors")
    lib = _load()
    keys, r_pad = ret_slot.shape
    F_out = torch.empty_like(F)
    state = torch.empty((keys, 5), dtype=torch.int32, device=F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        rc = lib.dense_chunk_batch_launch(
            F.data_ptr(), F_out.data_ptr(), masks.data_ptr(),
            ret_slot.data_ptr(), n_rows.data_ptr(), int(keys), int(r_pad),
            int(w), int(ns), state.data_ptr(), stream)
    if rc != 0:
        raise _build.LaunchError(
            f"dense_chunk_batch kernel launch failed: CUDA "
            f"error {rc} (keys={keys}, w={w}, ns={ns}, "
            f"r_pad={r_pad})")
    BATCH_LAUNCHES += 1
    return ChunkResult(F_out, state)


def dense_chunk_batch_plain(F, n_rows, masks, ret_slot, *, w: int,
                            ns: int) -> ChunkResult:
    """:func:`dense_chunk_batch` in plain torch ops, on any device: one
    :func:`dense_chunk_plain` per key, as the XLA twin's vmap runs each
    lane on its own. A row count outside [0, r_pad] runs no row and reads
    rows_done = :data:`BAD_ROWS`, as on the card."""
    _check_batch_args(F, n_rows, masks, ret_slot, w, ns)
    r_pad = ret_slot.shape[1]
    outs = []
    for k, n in enumerate(n_rows.tolist()):
        bad = not 0 <= n <= r_pad
        o = dense_chunk_plain(F[k], 0 if bad else n, masks[k], ret_slot[k],
                              w=w, ns=ns)
        if bad:
            o.state[0] = BAD_ROWS
        outs.append(o)
    return ChunkResult(torch.stack([o.F for o in outs]),
                       torch.stack([o.state for o in outs]))


def check_batch_state(state) -> None:
    """Raise ValueError when a key of a batched launch's ``state`` (int
    [keys, 5], on the host) was given a row count outside its tables."""
    bad = [k for k, r in enumerate(np.asarray(state)[:, 0]) if r == BAD_ROWS]
    if bad:
        raise ValueError(f"dense_chunk_batch: keys {bad[:8]} had a row count "
                         f"outside [0, r_pad]")
