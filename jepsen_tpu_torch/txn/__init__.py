"""Transaction dependency-graph anomaly checking — Elle on the card.

The port of the JAX package's ``txn`` package: histories of list-append
transactions are checked for snapshot-isolation / serializability
violations by cycle search over the inferred wr/ww/rw(/realtime)
dependency graph (Kingsbury & Alvaro, *Elle*, VLDB 2020; Adya, *Weak
Consistency*, MIT 1999).

- :mod:`jepsen_tpu_torch.txn.oracle` — the executable CPU spec (the
  `lin/cpu.py` role): edge inference, Tarjan SCC, G0/G1c/G-single/
  G2-item classification with canonical minimal witness cycles.
- :mod:`jepsen_tpu_torch.txn.pack`   — packed codec: sorted flat edge
  arrays (the `lin/prepare.py` role).
- :mod:`jepsen_tpu_torch.txn.device` — the device engine: trim +
  min-label SCC propagation in one launch of a CUDA kernel
  (``csrc/txn_scc.cu``, bound in :mod:`jepsen_tpu_torch.txn.scc_cuda`),
  iteration ceilings inside the launch.
- :mod:`jepsen_tpu_torch.txn.synth`  — history generators + seeded-anomaly
  corpora.

``checker.txn_cycles(...)`` is the suite-facing checker.
"""

from __future__ import annotations

from jepsen_tpu_torch.txn import oracle as _oracle
from jepsen_tpu_torch.txn.oracle import (CONSISTENCY_MODELS,  # noqa: F401
                                         CYCLE_ANOMALIES, DIRECT_ANOMALIES,
                                         TxnGraph, UnsupportedTxnHistory)


def check(history, anomalies=None, consistency: str = "serializable",
          realtime: bool | None = None, algorithm: str = "gpu",
          device=None) -> dict:
    """Decide transactional consistency of a list-append history.

    ``algorithm``: ``"gpu"`` packs the dependency graph and runs the
    device SCC engine (:mod:`jepsen_tpu_torch.txn.device`) on ``device``
    — the card by default, raising without one; ``"cpu"`` runs the
    plain version — with the host Tarjan for a tier whose iteration
    ceiling fires; ``"cpu"`` runs the oracle end to end. Both classify
    with the same shared code and report identical verdicts + witness
    cycles.
    """
    if algorithm == "cpu":
        return _oracle.check(history, anomalies=anomalies,
                             consistency=consistency, realtime=realtime)
    if algorithm != "gpu":
        raise ValueError(f"unknown txn algorithm {algorithm!r}")
    from jepsen_tpu_torch import resolve_device
    from jepsen_tpu_torch.txn import device as _device, pack

    dev = resolve_device(device)
    requested, rt = _oracle.resolve_anomalies(anomalies, consistency,
                                              realtime)
    try:
        pt = pack.pack(history, realtime=rt)
    except UnsupportedTxnHistory as e:
        return {"valid?": "unknown", "analyzer": "txn-pack",
                "error": str(e)}
    return _device.check_packed(pt, anomalies=requested,
                                consistency=consistency, realtime=rt,
                                device=dev)
