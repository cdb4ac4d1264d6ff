"""StreamChecker: the carried-frontier incremental checking session.

The port's copy of the JAX package's ``stream/session.py``. One session is
one history checked while it is recorded. The session owns an
:class:`jepsen_tpu_torch.stream.incr.IncrementalPacker` and the sparse
engine's frontier between increments: the multiword ``bits`` / ``state``
/ ``count`` arrays of the chunk-kind checkpoint codec, held in memory and,
with a checkpoint path, on disk, so that a killed session resumes
mid-stream. Each increment is one call of
``lin.device_check_packed(packed, frontier=, frontier_row=, partial=True,
device=)``: the sparse engine re-enters at the carried row as a resume
does, walks only the new settled rows, and hands the committed frontier
back.

The carried frontier is an exact committed frontier at a row boundary,
the settled rows' tables are final when packed, and at finalize the
packed tables are the one-shot pack's bit for bit, so the streamed
verdict, dead row and final paths are the one-shot check's.

Each increment runs supervised at site ``stream-incr``
(:func:`jepsen_tpu_torch.lin.supervise.run_guarded`: the watchdog's
deadline, the fault taxonomy, the ledger's record). A wedged, faulted or
undecided increment degrades the session: incremental checking stops,
and finalize runs one post-hoc check of the whole history on the
session's device instead (the result says ``stream-fallback``): on the
card the device search alone, on the CPU the JAX package's race of the
device search and the host oracle. It never guesses and never hangs the
producer.

**Early abort.** The moment an increment returns ``valid? False`` the
session latches the witness verdict: ``aborted`` flips and the
``on_abort`` observer is called, so the producer learns of a violation
within one increment of the offending completion.

Knobs, read at each call under the JAX package's names:
``JEPSEN_TPU_STREAM_ROWS`` (settled rows an increment waits for, 256)
and ``JEPSEN_TPU_STREAM_CKPT`` (the checkpoint path).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

import numpy as np

from jepsen_tpu_torch import util
from jepsen_tpu_torch.stream.incr import IncrementalPacker

# The kind tag of stream checkpoints (the supervise.Checkpointer codec).
CKPT_KIND = "stream"
ANALYZER = "gpu-bfs-stream"


def default_min_rows() -> int:
    """Settled rows buffered before an increment dispatches: fewer means
    a lower abort latency, more a better amortised row loop (each
    increment pays fixed packing and dispatch costs)."""
    return util.env_int("JEPSEN_TPU_STREAM_ROWS", 256)


def stream_ckpt_path() -> str | None:
    return os.environ.get("JEPSEN_TPU_STREAM_CKPT", "") or None


class StreamChecker:
    """Open, ``append`` N times, then ``finalize`` (or ``abort``).

    ``append`` takes history events (:class:`Op`), invocations and
    completions in history order; an op enters an increment only once its
    completion is recorded (the packer's settled-row rule). ``finalize``
    settles everything and returns the whole history's verdict with the
    session's ``stream`` summary.

    ``device`` is where the increments, the settle paint and a post-hoc
    check run (the card when None; raises without one);
    ``paint_min_rows`` goes to the packer. One producer at a time:
    :class:`jepsen_tpu_torch.stream.runner.LiveChecker` serialises
    access.
    """

    def __init__(self, model, *, min_rows: int | None = None,
                 checkpoint: str | None = None, explain: bool = True,
                 check_kw: dict | None = None,
                 on_abort: Callable[[dict], None] | None = None,
                 device=None, paint_min_rows: int | None = None):
        self.model = model
        self.packer = IncrementalPacker(model, device=device,
                                        paint_min_rows=paint_min_rows)
        self.device = self.packer.device
        self.min_rows = min_rows if min_rows is not None \
            else default_min_rows()
        self.explain = explain
        self.check_kw = dict(check_kw or {})
        self.on_abort = on_abort
        self.ckpt_path = checkpoint if checkpoint is not None \
            else stream_ckpt_path()
        self._ckpt = None
        self._tried_resume = False

        self._frontier = None          # (bits u32[n, nw], state i32[n, S])
        self._count = 0
        self._row = 0                  # rows checked (the frontier's row)
        self._verdict: dict | None = None   # the latched definite False
        self._degraded: str | None = None
        self._final: dict | None = None
        self._t0 = time.monotonic()
        self.stats: dict = {
            "mode": "incremental" if self.packer.incremental
            else "buffer", "ops_ingested": 0, "ops_pending": 0,
            "rows_settled": 0, "rows_checked": 0, "lag_rows": 0,
            "increments": 0, "increment_s": 0.0, "aborted": False}

    # --- state --------------------------------------------------------------

    @property
    def aborted(self) -> bool:
        """True once an increment returned a definite invalid verdict
        (the early-abort latch a producer polls)."""
        return self._verdict is not None \
            and self._verdict.get("valid?") is False

    @property
    def verdict(self) -> dict | None:
        """The latched abort verdict (None while the stream is clean)."""
        return self._verdict

    def status(self) -> dict:
        return {"row": self._row, "settled": self.packer.R,
                "ops": self.stats["ops_ingested"],
                "pending": self.packer.unresolved,
                "aborted": self.aborted, "degraded": self._degraded,
                "frontier": self._count}

    # --- producing ----------------------------------------------------------

    def append(self, events) -> dict:
        """Feed events; advance the checker when enough rows settled.
        Returns :meth:`status` (with the latched witness verdict under
        ``"result"`` once aborted)."""
        if self._final is not None:
            raise RuntimeError("stream session already finalized")
        n = self.packer.feed_many(events)
        self.stats["ops_ingested"] += n
        self._advance(final=False)
        out = self.status()
        if self._verdict is not None:
            out["result"] = self._verdict
        return out

    def finalize(self) -> dict:
        """Settle everything, run the last increment (or the post-hoc
        check), and return the whole history's verdict. Idempotent."""
        if self._final is not None:
            return self._final
        if self._verdict is not None:
            out = dict(self._verdict)
        elif not self.packer.incremental:
            out = self._posthoc_check(
                f"unpackable event: {self.packer.broken}"
                if self.packer.broken else "buffer mode")
        else:
            self._advance(final=True)
            if self._verdict is not None:
                out = dict(self._verdict)
            elif self._degraded is not None:
                out = self._posthoc_check(self._degraded)
            else:
                # Every settled row checked clean.
                out = {"valid?": True, "analyzer": ANALYZER,
                       "configs": [],
                       "final-frontier-size": int(self._count)}
        out["stream"] = self._stream_summary()
        self._final = out
        if self._ckpt is not None and out.get("valid?") in (True, False):
            self._ckpt.clear()
        return out

    def abort(self) -> None:
        """The producer's cancel: drop the session state (no verdict)."""
        if self._final is None:
            self._final = {"valid?": "unknown", "analyzer": ANALYZER,
                           "error": "stream aborted by producer",
                           "stream": self._stream_summary()}

    # --- the increment loop -------------------------------------------------

    def _advance(self, final: bool) -> None:
        from jepsen_tpu_torch.lin.prepare import UnsupportedHistory

        try:
            self.packer.settle(final=final)
        except UnsupportedHistory as e:
            self._degrade(f"settle: {e}")
            return
        self.stats["rows_settled"] = self.packer.R
        self.stats["ops_pending"] = self.packer.unresolved
        self.stats["lag_rows"] = self.packer.R - self._row
        if self.packer.broken and self.stats.get("mode") != "buffer":
            # The packer turned to buffer mode at feed time: keep
            # buffering, stop incrementing, say why.
            self.stats["mode"] = "buffer"
            self.stats["degraded"] = \
                f"unpackable event: {self.packer.broken}"[:200]
        if not self.packer.incremental or self._degraded is not None \
                or self._verdict is not None:
            return
        if not self._maybe_resume(final):
            return   # the resume decision waits: settle only
        while self._verdict is None and self._degraded is None:
            todo = self.packer.R - self._row
            if todo <= 0 or (not final and todo < self.min_rows):
                break
            self._increment()

    def _increment(self) -> None:
        from jepsen_tpu_torch import lin
        from jepsen_tpu_torch.lin import supervise

        p = self.packer.packed()
        if p.kernel is None:
            self._degrade("no device kernel")
            return
        row0, rows = self._row, p.R - self._row
        key = supervise.shape_key("stream-incr", rows=rows,
                                  cap=self._count or 1,
                                  window=int(p.window), kernel=p.kernel.name)
        cancel = threading.Event()

        def thunk():
            kw = dict(self.check_kw)
            kw.setdefault("explain", self.explain)
            return lin.device_check_packed(
                p, cancel=cancel, device=self.device,
                frontier=self._frontier_arg(), frontier_row=row0,
                partial=True, **kw)

        t0 = time.monotonic()
        # The deadline scales with the increment (rows / CHUNK dispatches,
        # each owed a base deadline): a healthy long increment must not
        # trip, a wedged one costs its detection window.
        outcome, r = supervise.run_guarded(
            "stream-incr", key, thunk, scale=max(3.0, rows / 512),
            stats=self.stats)
        if outcome != "ok":
            cancel.set()   # stop the abandoned increment's chunks
            self._degrade(f"increment {outcome} at row {row0}: {r}")
            return
        self.commit_increment(r, row0=row0, dt=time.monotonic() - t0)

    def commit_increment(self, r: dict, *, row0: int, dt: float) -> None:
        """Adopt one increment's result: latch the abort verdict, degrade
        on an undecided one, else carry the committed frontier forward and
        checkpoint it."""
        self.stats["increments"] += 1
        self.stats["increment_s"] = round(
            self.stats["increment_s"] + dt, 4)
        v = r.get("valid?")
        if v is False:
            self._abort_with(r)
            return
        if v is not True or "stream-frontier" not in r:
            self._degrade(f"increment undecided at row {row0}: "
                          f"{r.get('error', r.get('overflow', v))!r}")
            return
        sf = r["stream-frontier"]
        self._frontier = (np.asarray(sf["bits"], np.uint32),
                          np.asarray(sf["state"], np.int32))
        self._count = int(sf["count"])
        self._row = int(sf["row"])
        self.stats["rows_checked"] = self._row
        self.stats["lag_rows"] = self.packer.R - self._row
        self.stats["frontier"] = self._count
        self._save_ckpt()

    def _frontier_arg(self):
        if self._frontier is None:
            return None
        return (self._frontier[0], self._frontier[1], self._count)

    def _abort_with(self, r: dict) -> None:
        self._verdict = dict(r)
        self.stats["aborted"] = True
        self.stats["aborted_row"] = r.get("dead-row")
        self.stats["rows_checked"] = self._row
        if self.on_abort is not None:
            try:
                self.on_abort(self._verdict)
            except Exception:  # noqa: BLE001 - an observer must not
                pass           # poison the verdict

    def _degrade(self, reason: str) -> None:
        """Incremental checking is an optimisation of the post-hoc check:
        what it cannot decide exactly (a wedge, a fault, capacity, an
        unpackable tail) hands the whole verdict to the one-shot check at
        finalize."""
        self._degraded = reason
        self._frontier = None
        self.stats["degraded"] = reason[:200]

    def _posthoc_check(self, why: str) -> dict:
        """The one-shot check of the whole history. On the CPU it races
        the device search and the host oracle (the JAX package's
        ``"competition"``); on the card it is the device search alone,
        whose own sites answer a wedge or fault with an honest unknown or
        raise: the card's work never moves to the host."""
        from jepsen_tpu_torch import lin
        from jepsen_tpu_torch.lin import supervise

        algorithm = "competition" if supervise.host_rungs(self.device) \
            else "gpu"
        out = dict(lin.analysis(self.model, list(self.packer.history),
                                algorithm=algorithm, device=self.device,
                                explain=self.explain))
        out["stream-fallback"] = why
        return out

    # --- checkpoint / resume ------------------------------------------------

    def _checkpointer(self):
        from jepsen_tpu_torch.lin import supervise

        if self._ckpt is None and self.ckpt_path:
            self._ckpt = supervise.Checkpointer(self.ckpt_path, "",
                                                every_s=0.0)
        return self._ckpt

    def _save_ckpt(self) -> None:
        ck = self._checkpointer()
        if ck is None or self._frontier is None:
            return
        # The fingerprint is the settled prefix's identity at this row,
        # which any session fed the same events computes.
        ck.fingerprint = self.packer.prefix_fingerprint(self._row)
        n = max(self._count, 1)
        ck.save(CKPT_KIND, self._row, self._count,
                {"bits": self._frontier[0][:n],
                 "state": self._frontier[1][:n]},
                {"kernel": self.packer.kernel.name})

    def _maybe_resume(self, final: bool = False) -> bool:
        """At a session's first advances with a checkpoint path: adopt a
        prior session's frontier when its settled-prefix fingerprint
        matches ours at the checkpointed row (the same events in the same
        order; anything else is rejected and checking starts at row 0).
        Returns False while the decision waits (the checkpoint's row lies
        past the settled prefix: checking must hold off, or the session
        would re-check from row 0); at ``final`` a checkpoint row still
        out of reach is rejected."""
        if self._tried_resume or not self.ckpt_path or self._row:
            return True
        status, rd = self._load_ckpt()
        if status == "wait" and not final:
            return False
        self._tried_resume = True
        if rd is None:
            return True
        self._frontier = (np.asarray(rd["bits"], np.uint32),
                          np.asarray(rd["state"], np.int32))
        self._count = int(rd["count"])
        self._row = int(rd["row"])
        self.stats["rows_checked"] = self._row
        self.stats["resumed_from_row"] = self._row
        return True

    def _load_ckpt(self) -> tuple[str, dict | None]:
        """("ok", payload), ("none", None) (rejected: stop looking) or
        ("wait", None) (the checkpoint's row lies past the settled
        prefix, so its fingerprint cannot be judged yet)."""
        from jepsen_tpu_torch.lin import supervise

        path = self.ckpt_path
        if not path or not os.path.exists(path):
            return "none", None
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["__meta__"]).decode())
                if meta.get("version") != supervise.CKPT_VERSION \
                        or meta.get("kind") != CKPT_KIND:
                    return "none", None
                row = int(meta["row"])
                if row > self.packer.R:
                    return "wait", None
                if meta.get("fingerprint") != \
                        self.packer.prefix_fingerprint(row):
                    return "none", None
                return "ok", {"bits": z["bits"], "state": z["state"],
                              "row": row, "count": int(meta["count"])}
        except Exception:  # noqa: BLE001 - damage means no checkpoint
            return "none", None

    # --- reporting ----------------------------------------------------------

    def _stream_summary(self) -> dict:
        out = dict(self.stats)
        out["wall_s"] = round(time.monotonic() - self._t0, 3)
        return util.round_stats(out)
