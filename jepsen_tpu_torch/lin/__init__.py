"""Linearizability checking on the GPU.

- :mod:`jepsen_tpu_torch.lin.prepare` — host packing: invoke/completion
  pairing, slot assignment, value interning, the return-event table.
- :mod:`jepsen_tpu_torch.lin.cpu`     — the host reference search (the
  oracle).
- :mod:`jepsen_tpu_torch.lin.dense`   — the dense config-space bitmap
  engine (windows <= 20), chunk by chunk through
  :mod:`jepsen_tpu_torch.lin.dense_cuda`'s kernel.
- :mod:`jepsen_tpu_torch.lin.bfs`     — the sparse frontier engine for
  wider windows (register histories, crash-free or with crashed ops, on
  single u32 keys or (hi, lo) u32 pairs; other one-word kernels on
  single keys; multiword states such as sets and queues),
  through :mod:`jepsen_tpu_torch.lin.psort`'s and
  :mod:`jepsen_tpu_torch.lin.psort_fused`'s kernels.
- :mod:`jepsen_tpu_torch.lin.witness` — counterexamples for device
  verdicts.
- :mod:`jepsen_tpu_torch.lin.batched` — many independent keys in one
  device search (:mod:`jepsen_tpu_torch.independent`'s checker).
- :mod:`jepsen_tpu_torch.lin.supervise` — the dispatch watchdog, the
  fault-shape quarantine ledger and frontier checkpoint/resume.

``analysis(model, history)`` returns ``{"valid?": bool, "op": ...,
"configs": [...], "final-paths": [...]}``, the result shape of
:func:`jepsen_tpu.lin.analysis`.
"""

from __future__ import annotations

import threading

from jepsen_tpu_torch import resolve_device
from jepsen_tpu_torch.lin import prepare as _prepare_mod
from jepsen_tpu_torch.lin.prepare import PackedHistory, UnsupportedHistory

ALGORITHMS = ("gpu", "cpu", "competition")


def analysis(model, history, algorithm: str = "competition", device=None,
             **kw) -> dict:
    """Decide linearizability of ``history`` against ``model``.

    algorithm: ``"gpu"`` (the device engine), ``"cpu"`` (the host
    reference), or ``"competition"`` (race both; the first definite
    verdict wins). ``device`` is where the device engine runs (default:
    the card; see :func:`jepsen_tpu_torch.resolve_device`).
    ``checkpoint`` and ``resume`` go to the sparse engine
    (:func:`jepsen_tpu_torch.lin.bfs.check_packed`)."""
    known = {"witness", "cancel", "chunk", "cap_schedule", "host_caps",
             "explain", "checkpoint", "resume"}
    if kw.keys() - known:
        raise TypeError(f"unknown analysis options {kw.keys() - known}")
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown linearizability algorithm {algorithm!r}")
    if algorithm != "cpu":
        device = resolve_device(device)
    try:
        packed = _prepare_mod.prepare(model, history)
    except UnsupportedHistory as e:
        if e.kind == "window" and algorithm != "gpu":
            # Past the packed bitset width the host search still applies
            # (Python int bitsets have no width limit).
            try:
                packed = _prepare_mod.prepare(model, history,
                                              max_window=1 << 14)
            except UnsupportedHistory as e2:
                return {"valid?": "unknown", "error": str(e2),
                        "analyzer": "prepare"}
            from jepsen_tpu_torch.lin import cpu

            ckw = {k: v for k, v in kw.items()
                   if k in ("witness", "cancel")}
            return cpu.check_packed(packed, **ckw)
        return {"valid?": "unknown", "error": str(e), "analyzer": "prepare"}

    if algorithm == "cpu":
        from jepsen_tpu_torch.lin import cpu

        ckw = {k: v for k, v in kw.items() if k in ("witness", "cancel")}
        return cpu.check_packed(packed, **ckw)
    if algorithm == "gpu":
        dkw = {k: v for k, v in kw.items() if k != "witness"}
        return device_check_packed(packed, device=device, **dkw)
    return _competition(packed, device=device, **kw)


def device_check_packed(packed: PackedHistory, cancel=None, device=None,
                        **kw) -> dict:
    """The device search, routed by history shape: the dense bitmap
    engine when window and state count fit its bounds, else the sparse
    frontier engine, which answers a history with no step kernel or a
    window past its bitset with an honest unknown naming why
    (:func:`jepsen_tpu_torch.lin.bfs.band_error`). ``checkpoint`` and
    ``resume`` are the sparse engine's (a dense history decides in
    seconds); an incremental call (``frontier``, ``frontier_row``,
    ``partial``) always goes to the sparse engine, whose multiword layout
    the carried frontier is in."""
    from jepsen_tpu_torch.lin import bfs, dense

    known = {"chunk", "cap_schedule", "host_caps", "explain", "checkpoint",
             "resume", "frontier", "frontier_row", "partial"}
    if kw.keys() - known:
        raise TypeError(f"unknown device-check options {kw.keys() - known}")
    incremental = kw.get("partial") or kw.get("frontier") is not None
    if not incremental and dense.plan(packed) is not None:
        dkw = {k: v for k, v in kw.items() if k in ("chunk", "explain")}
        return dense.check_packed(packed, cancel=cancel, device=device,
                                  **dkw)
    return bfs.check_packed(packed, cancel=cancel, device=device, **kw)


def _competition(packed: PackedHistory, cancel=None, device=None,
                 **kw) -> dict:
    """Race the device and host searches; the first definite verdict wins.
    A racer returning "unknown" does not end the race; only when both fail
    to decide is "unknown" returned. An external ``cancel`` aborts both;
    the race also sets it to stop the loser, and joins the loser before
    it returns."""
    from jepsen_tpu_torch.lin import cpu

    cpu_kw = {k: v for k, v in kw.items() if k == "witness"}
    # The device options the reference's racer gets.
    dev_kw = {k: v for k, v in kw.items()
              if k in ("chunk", "cap_schedule", "explain", "checkpoint",
                       "resume")}
    lock = threading.Lock()
    state: dict = {"result": None, "finished": 0}
    done = threading.Event()
    cancel = cancel if cancel is not None else threading.Event()

    def run(fn, name, fkw):
        try:
            r = fn(packed, cancel=cancel, **fkw)
        except Exception as e:  # noqa: BLE001 - a racer may fail; the race decides
            r = {"valid?": "unknown", "error": f"{name}: {e!r}"}
        with lock:
            state["finished"] += 1
            if r.get("valid?") in (True, False):
                if not done.is_set():
                    state["result"] = r
                    done.set()
            else:
                if state["result"] is None and \
                        r.get("error") != "cancelled":
                    state["result"] = r  # fallback if nobody decides
                if state["finished"] == 2:
                    done.set()

    threads = [threading.Thread(target=run,
                                args=(cpu.check_packed, "cpu", cpu_kw)),
               threading.Thread(target=run,
                                args=(device_check_packed, "gpu",
                                      {**dev_kw, "device": device}))]
    for t in threads:
        t.start()
    done.wait()
    # Stop the loser (it checks `cancel` between rows/chunks) and join it.
    cancel.set()
    for t in threads:
        t.join()
    with lock:
        if state["result"] is None:
            return {"valid?": "unknown", "error": "cancelled"}
        return dict(state["result"])
