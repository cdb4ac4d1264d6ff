"""LiveChecker: a live run's streaming-checker thread.

The port's copy of the JAX package's ``stream/runner.py``, in-process
only. A run loop feeds every history append to :meth:`LiveChecker.offer`;
a daemon thread drains the queue into a
:class:`jepsen_tpu_torch.stream.session.StreamChecker`, so that increment
checks never block a worker's op loop. The run loop polls
:meth:`LiveChecker.should_abort` between ops: once an increment goes
invalid, the workers stop drawing ops and the run ends with the witness
in hand.

``JEPSEN_TPU_STREAM_ABORT=0`` keeps checking live but lets the run
complete. The run loop that would open a LiveChecker per test (the JAX
package's ``JEPSEN_TPU_STREAM`` gate, ``live_checker_for``) is not
ported yet: a caller builds the LiveChecker itself. Nor is the JAX
package's wire session (``JEPSEN_TPU_STREAM_WIRE``, a checker daemon's
stream session): the session here is always in-process.

A failure inside the checker thread does not end the run, and is not
swallowed either: the thread records the first exception in the session's
``stream`` summary (``checker_error``) and :meth:`LiveChecker.finish`
raises it after the join.
"""

from __future__ import annotations

import os
import threading
from collections import deque


def abort_enabled() -> bool:
    """``JEPSEN_TPU_STREAM_ABORT=0`` keeps checking live but lets the run
    complete (observe only: the abort latency without the abort)."""
    return os.environ.get("JEPSEN_TPU_STREAM_ABORT", "1") != "0"


def _open_session(model, **session_kw):
    """The LiveChecker's session: the in-process StreamChecker."""
    from jepsen_tpu_torch.stream.session import StreamChecker

    return StreamChecker(model, **session_kw)


class LiveChecker:
    """A queue-fed, thread-driven StreamChecker for a live run.
    ``session_kw`` go to the StreamChecker (``device=`` among them)."""

    def __init__(self, model, **session_kw):
        self.session = _open_session(model, **session_kw)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._aborted = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="jepsen-stream-checker")
        self._thread.start()

    def offer(self, op) -> None:
        """Called from worker threads on the history's append path; O(1):
        enqueue and wake the checker thread."""
        with self._cv:
            self._q.append(op)
            self._cv.notify()

    def should_abort(self) -> bool:
        return abort_enabled() and self._aborted.is_set()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(0.5)
                batch = list(self._q)
                self._q.clear()
                stopping = self._stop
            if batch:
                try:
                    self.session.append(batch)
                except Exception as e:  # noqa: BLE001 - recorded, and
                    # raised by finish(): the run goes on meanwhile.
                    if self._error is None:
                        self._error = e
                        self.session.stats["checker_error"] = \
                            repr(e)[:200]
                if self.session.aborted:
                    self._aborted.set()
            if stopping and not batch:
                return

    def finish(self) -> dict:
        """Drain, finalize and return the stream verdict (joins the
        checker thread; called once after the workload ends). Raises the
        checker thread's first exception, if it had one."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=600)
        if self._error is not None:
            raise self._error
        return self.session.finalize()

