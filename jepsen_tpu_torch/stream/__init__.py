"""Streaming incremental checking: verdicts while a history is recorded.

The port's copy of the JAX package's ``stream`` package, on the card:

- :mod:`jepsen_tpu_torch.stream.incr` — :class:`IncrementalPacker`:
  extends the packed history (the slot walk, the interner, the reduction
  tables) in settled-row increments instead of re-packing from op 0; a
  settle of at least ``paint_min_rows`` rows paints its tables on the
  device (:func:`jepsen_tpu_torch.lin.pack_dev.paint_tables_dev`). The
  final tables are a one-shot ``prepare.prepare``'s bit for bit.
- :mod:`jepsen_tpu_torch.stream.session` — :class:`StreamChecker`: takes
  history events in increments, carries the sparse engine's frontier
  between them (``lin.device_check_packed(..., frontier=, partial=True)``
  under the ``stream-incr`` supervision site), and aborts the moment an
  increment goes invalid.
- :mod:`jepsen_tpu_torch.stream.runner` — :class:`LiveChecker`: the
  checker thread a live run feeds, with the early-abort latch.

Not ported yet: the JAX package's wire sessions (a checker daemon's
``stream-*`` frames), its stream batch over a key axis, and the run
loop's ``JEPSEN_TPU_STREAM`` gate (``live_checker_for``).
"""

from jepsen_tpu_torch.stream.incr import IncrementalPacker
from jepsen_tpu_torch.stream.runner import LiveChecker
from jepsen_tpu_torch.stream.session import StreamChecker

__all__ = ["IncrementalPacker", "StreamChecker", "LiveChecker"]
