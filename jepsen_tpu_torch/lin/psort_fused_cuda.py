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

# The launcher's bounds (csrc/psort_fused.cu): n_pad a power of two from
# MIN_N to MAX_N, the reference's clamp 2^FUSED_MAX_EXP. The engine's own
# gate, psort_fused.fits, stays at psort.PSORT_MAX_N.
MIN_N = 1024
MAX_N = 1 << 21
MAX_LOG_CAP = 20
# Bits of the path word the kernel writes beside the flags: a pass sorted
# its live candidates in shared memory, or in the device-memory scratch.
PATH_SHARED, PATH_DEVICE = 1, 2

_lib = None
# The path word of the latest launch (int32[1] on the card), for checks
# that every path ran.
last_path = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("psort_fused")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.psort_fused_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p,
                                           p, p, p, p, p]
        lib.psort_fused_launch.restype = i
        lib.psort_fused_shared_max_n.argtypes = [i]
        lib.psort_fused_shared_max_n.restype = i
        _lib = lib
    return _lib


def shared_max_n(pair: bool = False) -> int:
    """Live candidates a pass sorts in shared memory, for single keys or
    pairs; a pass with more sorts in the device-memory scratch."""
    return int(_load().psort_fused_shared_max_n(int(pair)))


def launchable(cap: int, M: int, b: int, n_pad: int) -> bool:
    """The launcher's own limits on a launch's shape."""
    return (1 <= M <= 32 and 1 <= b <= 6 and cap >= 1
            and (cap & (cap - 1)) == 0
            and cap.bit_length() - 1 <= MAX_LOG_CAP
            and MIN_N <= n_pad <= MAX_N and (n_pad & (n_pad - 1)) == 0
            and cap * (1 + M) <= n_pad)


def scratch_words(cap: int, M: int, pair: bool, shared_n: int) -> int:
    """int32 words of the device-memory scratch: two radix buffers of the
    worst-case live count, cap * (1 + M) keys of one or two words, where
    that can exceed ``shared_n`` (:func:`shared_max_n`); else one unused
    word."""
    n = cap * (1 + M)
    return 2 * n * (2 if pair else 1) if n > shared_n else 1


def fixpoint(lo: torch.Tensor, hi, count: torch.Tensor, cols: torch.Tensor,
             sats: torch.Tensor, cap: int, b: int, n_pad: int, it_max: int):
    """Launch one whole closure fixpoint; ``hi`` is None for single keys.
    ``count`` is an int32[1] tensor on lo's device. Returns (lo
    int32[cap], hi int32[cap] or None, flags int32[4]) and sets
    :data:`last_path`."""
    global last_path
    lib = _load()
    dev = lo.device
    pair = hi is not None
    M = int(cols.shape[1])
    if not launchable(cap, M, b, n_pad):
        raise ValueError(f"fixpoint kernel: cap={cap} M={M} b={b} "
                         f"n_pad={n_pad} outside the launcher's limits")
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    out_hi = torch.empty(cap, dtype=torch.int32, device=dev) if pair \
        else None
    words = torch.empty(5, dtype=torch.int32, device=dev)
    flags, path = words[:4], words[4:]
    scratch = torch.empty(scratch_words(cap, M, pair, shared_max_n(pair)),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.psort_fused_launch(
            lo.data_ptr(), hi.data_ptr() if pair else None,
            count.data_ptr(), cols.data_ptr(), sats.data_ptr(), M, int(b),
            cap.bit_length() - 1, n_pad, int(it_max), out.data_ptr(),
            out_hi.data_ptr() if pair else None, flags.data_ptr(),
            path.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise _build.LaunchError(
            f"fixpoint kernel launch failed: CUDA error {rc} "
            f"(cap={cap}, M={M}, b={b}, n_pad={n_pad}, "
            f"pair={pair})")
    last_path = path
    return out, out_hi, flags
