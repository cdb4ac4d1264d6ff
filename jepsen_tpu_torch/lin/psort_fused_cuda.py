"""ctypes binding of ``csrc/psort_fused.cu``: the CUDA kernel behind
:func:`jepsen_tpu_torch.lin.psort_fused.fixpoint_flags`.

The function here takes CUDA tensors that the wrapper in
:mod:`jepsen_tpu_torch.lin.psort_fused` has checked, allocates the
outputs and scratch, and launches on the current stream. It does not
synchronise. Keys are raw int32 tensors read as ``uint32_t``
(:mod:`jepsen_tpu_torch._u32`).
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
        lib.psort_fused_launch.argtypes = [p, p, p, p, i, i, i, i, i, p, p,
                                           p, p]
        lib.psort_fused_launch.restype = i
        lib.psort_fused_shared_max_n.argtypes = []
        lib.psort_fused_shared_max_n.restype = i
        _lib = lib
    return _lib


def shared_max_n() -> int:
    """Largest candidate space the kernel keeps in shared memory; larger
    ones live in device memory."""
    return int(_load().psort_fused_shared_max_n())


def fixpoint(lo: torch.Tensor, count: torch.Tensor, cols: torch.Tensor,
             sats: torch.Tensor, cap: int, b: int, n_pad: int, it_max: int):
    """Launch one whole closure fixpoint. ``count`` is an int32[1] tensor
    on lo's device. Returns (lo int32[cap], flags int32[4])."""
    lib = _load()
    dev = lo.device
    M = int(cols.shape[1])
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    flags = torch.empty(4, dtype=torch.int32, device=dev)
    scratch = torch.empty(n_pad if n_pad > shared_max_n() else 1,
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.psort_fused_launch(
            lo.data_ptr(), count.data_ptr(), cols.data_ptr(),
            sats.data_ptr(), M, int(b), cap.bit_length() - 1, n_pad,
            int(it_max), out.data_ptr(), flags.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fixpoint kernel launch failed: CUDA error {rc} "
                           f"(cap={cap}, M={M}, b={b}, n_pad={n_pad})")
    return out, flags
