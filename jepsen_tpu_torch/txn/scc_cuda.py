"""ctypes binding of ``csrc/txn_scc.cu``: the CUDA kernel behind
:func:`jepsen_tpu_torch.txn.device.scc_program`.

The function here takes CUDA tensors that the wrapper in
:mod:`jepsen_tpu_torch.txn.device` has checked, allocates the output and
scratch, and launches the whole three-loop program as one cooperative
launch on the current stream. It does not synchronise.
"""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch import _build

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("txn_scc")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.txn_scc_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
        lib.txn_scc_launch.restype = i
        lib.txn_scc_grid.argtypes = [i, i]
        lib.txn_scc_grid.restype = i
        lib.txn_scc_threads.argtypes = []
        lib.txn_scc_threads.restype = i
        _lib = lib
    return _lib


def out_words(n_pad: int) -> int:
    """int32 words of the output: alive, lab and flag (n_pad each), then
    iters[3] and overflow[3]."""
    return 3 * n_pad + 6


def grid(e_pad: int, n_pad: int) -> int:
    """Blocks a launch at (e_pad, n_pad) takes on the current device: one
    a multiprocessor, capped at one thread per edge or node."""
    g = int(_load().txn_scc_grid(int(e_pad), int(n_pad)))
    if g <= 0:
        raise _build.LaunchError(
            f"txn_scc grid query failed: CUDA error {-g}")
    return g


def threads() -> int:
    """Threads a block of the launch runs."""
    return int(_load().txn_scc_threads())


def scc(src: torch.Tensor, dst: torch.Tensor, live: torch.Tensor, n: int,
        it_max: int, n_pad: int) -> torch.Tensor:
    """Launch the SCC program; returns its int32[:func:`out_words`] output
    on src's device. Raises if the card refuses the launch (a grid that
    cannot be co-resident, say): there is no fallback."""
    lib = _load()
    dev = src.device
    e_pad = int(src.shape[0])
    out = torch.empty(out_words(n_pad), dtype=torch.int32, device=dev)
    # in/out marks, the next labels or flags, and the changed-word ring;
    # the kernel needs the marks and the ring zeroed.
    scratch = torch.zeros(3 * n_pad + 4, dtype=torch.int32, device=dev)
    em = torch.empty(e_pad, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.txn_scc_launch(
            src.data_ptr(), dst.data_ptr(), live.data_ptr(), e_pad, int(n),
            int(n_pad), int(it_max), out.data_ptr(), scratch.data_ptr(),
            em.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise _build.LaunchError(
            f"txn_scc kernel launch failed: CUDA error {rc} "
            f"(e_pad={e_pad}, n={n}, n_pad={n_pad}, "
            f"it_max={it_max})")
    return out
