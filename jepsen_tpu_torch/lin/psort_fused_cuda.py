"""ctypes binding of ``csrc/psort_fused.cu``: the CUDA kernel behind
:func:`jepsen_tpu_torch.lin.psort_fused.fixpoint_flags`.

The function here takes CUDA tensors that the wrapper in
:mod:`jepsen_tpu_torch.lin.psort_fused` has checked, allocates the
outputs and scratch, and launches on the current stream. It does not
synchronise. Keys are raw int32 tensors read as ``uint32_t``
(:mod:`jepsen_tpu_torch._u32`); pair keys are two such arrays, hi and lo,
which the kernel joins into ``uint64_t``.
"""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch import _build

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("psort_fused")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.psort_fused_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p,
                                           p, p, p, p]
        lib.psort_fused_launch.restype = i
        lib.psort_fused_shared_max_n.argtypes = [i]
        lib.psort_fused_shared_max_n.restype = i
        _lib = lib
    return _lib


def shared_max_n(pair: bool = False) -> int:
    """Largest candidate space the kernel keeps in shared memory, for
    single keys or pairs; larger ones live in device memory."""
    return int(_load().psort_fused_shared_max_n(int(pair)))


def fixpoint(lo: torch.Tensor, hi, count: torch.Tensor, cols: torch.Tensor,
             sats: torch.Tensor, cap: int, b: int, n_pad: int, it_max: int):
    """Launch one whole closure fixpoint; ``hi`` is None for single keys.
    ``count`` is an int32[1] tensor on lo's device. Returns (lo
    int32[cap], hi int32[cap] or None, flags int32[4])."""
    lib = _load()
    dev = lo.device
    pair = hi is not None
    M = int(cols.shape[1])
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    out_hi = torch.empty(cap, dtype=torch.int32, device=dev) if pair \
        else None
    flags = torch.empty(4, dtype=torch.int32, device=dev)
    # Above the shared-memory bound the candidates and the carried keys
    # (n_pad + cap keys of one or two words) live in this buffer.
    words = (n_pad + cap) * (2 if pair else 1) \
        if n_pad > shared_max_n(pair) else 1
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.psort_fused_launch(
            lo.data_ptr(), hi.data_ptr() if pair else None,
            count.data_ptr(), cols.data_ptr(), sats.data_ptr(), M, int(b),
            cap.bit_length() - 1, n_pad, int(it_max), out.data_ptr(),
            out_hi.data_ptr() if pair else None, flags.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fixpoint kernel launch failed: CUDA error {rc} "
                           f"(cap={cap}, M={M}, b={b}, n_pad={n_pad}, "
                           f"pair={pair})")
    return out, out_hi, flags
