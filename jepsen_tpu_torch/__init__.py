"""jepsen_tpu_torch — the linearizability and transaction checkers on
PyTorch and CUDA.

A port of :mod:`jepsen_tpu`'s linearizability checker to an NVIDIA Hopper
GPU: the register, mutex, set and queue models, history packing, the
dense config-space bitmap engine with its hand-written CUDA kernel
(``csrc/dense_chunk.cu``), the sparse frontier engine's bands with theirs
(``csrc/psort.cu``, ``csrc/psort_fused.cu``), the CPU oracle,
counterexample replay, the ``linearizable`` checker and its lift to
independent keys (:mod:`jepsen_tpu_torch.independent`). Beside it the
transaction checker (:mod:`jepsen_tpu_torch.txn`, ``checker.txn_cycles``):
Elle's dependency-graph cycle search over list-append histories, its SCC
program one launch of a CUDA kernel (``csrc/txn_scc.cu``). And the
streaming checker (:mod:`jepsen_tpu_torch.stream`): a history decided
while it is recorded, in settled-row increments that carry the sparse
engine's frontier, each settle's table paint on the card, and the live
run's checker thread with its early abort. It imports torch and numpy
only.

Entry points take ``device=``. Without one they run on the card, and
raise if there is none; pass ``device="cpu"`` to run the plain torch
versions of the kernels on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when none is given.
    Raises when no card is present rather than running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain torch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
