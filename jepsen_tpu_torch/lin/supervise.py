"""Supervised dispatch runtime for the port's device engines.

The port's copy of the JAX package's ``lin/supervise.py``, with the same
names, env knobs and defaults:

- :func:`call` — the dispatch watchdog: one engine dispatch runs in a
  worker thread under a per-site deadline and a bounded retry budget.
  Exhaustion raises :class:`WedgedDispatch`, which the call sites turn
  into their next rung or an honest unknown.
- The **fault-shape quarantine ledger** — a JSON file keyed by program
  shape (site, rows x cap, window, kernel). A dispatch that faults, or
  wedges in a streak, records its shape; the host-row sites
  (``host-fixpoint``, ``host-pass``), ``txn-scc`` and ``pack-dev`` route
  a quarantined shape straight to their next rung, in later processes
  too. The base sites (``chunk``, ``spike``) and the stream's increment
  (``stream-incr``, :mod:`jepsen_tpu_torch.stream.session`, whose
  non-ok outcome hands the session to one post-hoc check) have no other
  rung: their entries are a record only.
- :class:`Checkpointer` / :func:`load_checkpoint` — frontier
  checkpoint/resume at committed row boundaries, in the JAX package's
  format (``CKPT_VERSION``, the ``__meta__`` JSON, the same
  :func:`history_fingerprint`), so a checkpoint either package writes,
  the other resumes.

The rungs are the JAX package's. Those that move a dispatch's work to
the host (the CPU oracle, the host Tarjan, the host pack) run only for a
search on the CPU (:func:`host_rungs`). On the card no work leaves the
device: the fused row fixpoint falls to the per-pass program, and every
other non-ok outcome ends in the site's honest unknown (``overflow:
wedge`` / ``fault``) or raises where the site has no unknown.

On the card a dispatch is asynchronous, so every thunk ends on the host:
its fetch (``.tolist()``, ``.cpu()``) runs inside the thunk, and the
deadline covers device time, not the enqueue. A launch cannot be
cancelled: an abandoned attempt's launches stay on the stream, and a
retry queues behind them, so a truly stuck kernel gives
:class:`WedgedDispatch` and the next rung, not a successful retry. An
abandoned attempt gets a stop flag (:func:`stopped`, :func:`check_stop`),
which the engines test at each row and closure-pass boundary, so it stops
issuing launches; it owns its outputs and stats, which nobody reads.

A fault is a CUDA error (:func:`is_fault`): a kernel's launch error code
(``_build.LaunchError``), a CUDA error torch raises, or an injected one.
An out-of-memory error, a failed library load and a failed kernel build
are not: they raise out of every site, as they do unsupervised. A CUDA
fault that poisons the context (an illegal address, a trap) is sticky:
every later call in the process fails, so :func:`run_guarded` records
its shape and raises it rather than let the search go on.

Env knobs: ``JEPSEN_TPU_SUPERVISE``, ``JEPSEN_TPU_DISPATCH_DEADLINE_S``,
``JEPSEN_TPU_DISPATCH_RETRIES``, ``JEPSEN_TPU_QUARANTINE``,
``JEPSEN_TPU_CKPT``, ``JEPSEN_TPU_CKPT_EVERY_S``, ``JEPSEN_TPU_WEDGE`` /
``JEPSEN_TPU_FAULT`` (test hooks), ``JEPSEN_TPU_CPU_ROW_MAX``. The
ledger is off unless ``JEPSEN_TPU_QUARANTINE`` names its file: a shape
recorded once must not keep a later run off a kernel unasked, and a TPU
program's shape key says nothing about the card.
"""

from __future__ import annotations

import atexit
import calendar
import hashlib
import json
import os
import threading
import time
from typing import Callable

import numpy as np

from jepsen_tpu_torch import _build, util

CKPT_VERSION = 1
LEDGER_VERSION = 1
# Events kept in the in-stats trip log (the ledger holds the durable
# record).
MAX_EVENTS = 8


def enabled() -> bool:
    """The watchdog's master switch; ``JEPSEN_TPU_SUPERVISE=0`` runs every
    dispatch unwrapped, in the caller's thread."""
    return os.environ.get("JEPSEN_TPU_SUPERVISE", "1") != "0"


def base_deadline_s() -> float:
    """Base deadline of a dispatch. Call sites scale it (the host row's
    fused fixpoint runs a whole closure in one dispatch: scale 3)."""
    return util.env_float("JEPSEN_TPU_DISPATCH_DEADLINE_S", 600.0)


def retry_budget() -> int:
    """Re-dispatches after a wedge before :class:`WedgedDispatch`."""
    return util.env_int("JEPSEN_TPU_DISPATCH_RETRIES", 1)


def cpu_row_max() -> int:
    """Largest entry frontier the CPU-oracle rung takes; past it the
    ladder reports an honest wedge or fault overflow."""
    return util.env_int("JEPSEN_TPU_CPU_ROW_MAX", 1 << 16)


def host_rungs(device) -> bool:
    """Whether a site may hand a non-ok dispatch's work to the host (the
    CPU oracle, the host Tarjan, the host pack): for a search on the CPU,
    as the JAX package's ladder does, never for one on the card, where
    such a rung would put a kernel's work on the host unseen."""
    return getattr(device, "type", device) != "cuda"


class WedgedDispatch(Exception):
    """A dispatch overran its deadline on every attempt. The call site
    falls to its next rung or reports an honest unknown."""

    def __init__(self, site: str, deadline_s: float, attempts: int):
        self.site, self.deadline_s, self.attempts = \
            site, deadline_s, attempts
        super().__init__(
            f"dispatch at site {site!r} exceeded the {deadline_s:.0f}s "
            f"watchdog deadline on {attempts} attempt(s)")


class InjectedFault(RuntimeError):
    """The fault an injection (``JEPSEN_TPU_FAULT``, :func:`inject_fault`)
    raises in place of a dispatch. Its repr, which results quote, is the
    JAX package's (a ``RuntimeError``)."""

    def __repr__(self) -> str:
        return f"RuntimeError({self.args[0]!r})"


class Quarantined(RuntimeError):
    """Raised by a site with no honest unknown (``pack-dev``) when its
    shape is quarantined and the work may not leave the card."""


class Abandoned(Exception):
    """Raised inside an abandoned attempt at its next row or pass
    boundary (:func:`check_stop`); nobody reads it."""


# --- process-wide counters ---------------------------------------------------
# Trips, faults and quarantine skips of every site since the last reset,
# and the watchdog's own cost: supervised attempts harvested and the wall
# seconds each spent outside its thunk (the thread start and the join).

_totals = {"watchdog_trips": 0, "faults": 0, "quarantine_skips": 0,
           "calls": 0, "handoff_s": 0.0}
# Per site: [attempts harvested, their summed and their largest seconds].
_sites: dict[str, list] = {}


def totals() -> dict:
    return dict(_totals)


def site_times() -> dict:
    """Per site: harvested attempts and their summed and largest wall
    seconds inside the thunk, since the last :func:`reset_totals`."""
    return {k: {"calls": v[0], "s": v[1], "max_s": v[2]}
            for k, v in _sites.items()}


def reset_totals() -> None:
    for k in _totals:
        _totals[k] = 0.0 if k.endswith("_s") else 0
    _sites.clear()


def note_skip(stats: dict | None) -> None:
    """Count one dispatch routed past its quarantined shape."""
    _totals["quarantine_skips"] += 1
    if stats is not None:
        util.stat_bump(stats, "quarantine_skips")


# --- the abandoned attempt's stop flag ---------------------------------------

_attempt = threading.local()
# Worker threads of abandoned attempts that may still run.
_abandoned: list[threading.Thread] = []


def stopped() -> bool:
    """True inside an attempt the watchdog has abandoned."""
    ev = getattr(_attempt, "stop", None)
    return ev is not None and ev.is_set()


def check_stop() -> None:
    """Raise :class:`Abandoned` inside an abandoned attempt: the engines
    call it at each row and pass boundary, so an attempt whose result
    nobody will read stops launching."""
    if stopped():
        raise Abandoned()


def join_abandoned(timeout: float = 60.0) -> bool:
    """Wait up to ``timeout`` seconds for the threads of abandoned
    attempts, each of which ends at its next boundary; True when none is
    left. Runs at interpreter exit too: a thread still inside a torch op
    while the interpreter tears down aborts the process."""
    end = time.monotonic() + timeout
    with _lock:
        threads = list(_abandoned)
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    with _lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        return not _abandoned


atexit.register(join_abandoned)


# --- wedge and fault injection (test hooks) ----------------------------------
# JEPSEN_TPU_WEDGE="site:count[:deadline_s]" (or inject_wedge()) makes the
# next ``count`` supervised calls at ``site`` run a fake thunk that blocks
# past the deadline without touching the device; the real thunk runs on
# the next attempt. The optional deadline applies to the injected attempts
# only. JEPSEN_TPU_FAULT="site:count" (or inject_fault()) makes the next
# ``count`` calls at ``site`` raise InjectedFault before the real thunk runs.

_injected: dict[str, list] = {}   # site -> [count, deadline_s | None]
_env_wedge_loaded: str | None = None
_lock = threading.Lock()
_injected_faults: dict[str, int] = {}
_env_fault_loaded: str | None = None


def inject_wedge(site: str, n: int = 1,
                 deadline_s: float | None = None) -> None:
    with _lock:
        e = _injected.setdefault(site, [0, deadline_s])
        e[0] += n
        if deadline_s is not None:
            e[1] = deadline_s


def inject_fault(site: str, n: int = 1) -> None:
    with _lock:
        _injected_faults[site] = _injected_faults.get(site, 0) + n


def reset_injections() -> None:
    """Disarm every pending wedge and fault injection (the env hooks'
    current values count as consumed)."""
    global _env_wedge_loaded, _env_fault_loaded
    with _lock:
        _injected.clear()
        _injected_faults.clear()
        _env_wedge_loaded = os.environ.get("JEPSEN_TPU_WEDGE") or None
        _env_fault_loaded = os.environ.get("JEPSEN_TPU_FAULT") or None


def _consume_fault_injection(site: str) -> bool:
    global _env_fault_loaded
    with _lock:
        env = os.environ.get("JEPSEN_TPU_FAULT", "")
        if env and env != _env_fault_loaded:
            _env_fault_loaded = env
            for part in env.split(","):
                bits = part.split(":")
                if bits and bits[0]:
                    s = bits[0].strip()
                    _injected_faults[s] = _injected_faults.get(s, 0) + (
                        int(bits[1]) if len(bits) > 1 and bits[1]
                        else 1)
        n = _injected_faults.get(site, 0)
        if n > 0:
            _injected_faults[site] = n - 1
            return True
        return False


def _consume_injection(site: str):
    """None when this attempt runs the real thunk; otherwise the deadline
    of the injected (fake-wedged) attempt, -1.0 for the call's own."""
    global _env_wedge_loaded
    with _lock:
        env = os.environ.get("JEPSEN_TPU_WEDGE", "")
        if env and env != _env_wedge_loaded:
            _env_wedge_loaded = env
            for part in env.split(","):
                bits = part.split(":")
                if bits and bits[0]:
                    e = _injected.setdefault(bits[0].strip(), [0, None])
                    e[0] += int(bits[1]) if len(bits) > 1 and bits[1] \
                        else 1
                    if len(bits) > 2 and bits[2]:
                        e[1] = float(bits[2])
        e = _injected.get(site)
        if e is not None and e[0] > 0:
            e[0] -= 1
            return e[1] if e[1] is not None else -1.0
        return None


def _note_event(stats: dict | None, site: str, kind: str,
                detail: str = "") -> None:
    key = "watchdog_trips" if kind == "wedge" else "faults"
    _totals[key] += 1
    if stats is None:
        return
    util.stat_bump(stats, key)
    ev = stats.setdefault("supervise_events", [])
    if len(ev) < MAX_EVENTS:
        e = {"site": site, "kind": kind}
        if detail:
            e["detail"] = detail[:200]
        ev.append(e)


def note_fault(stats: dict | None, site: str, detail: str = "") -> None:
    """Record a dispatch fault (the thunk raised) in the stats trip log;
    :func:`call` records wedges itself."""
    _note_event(stats, site, "fault", detail)


def call(site: str, thunk: Callable, *, scale: float = 1.0,
         deadline_s: float | None = None, retries: int | None = None,
         stats: dict | None = None, shape: str | None = None):
    """Run one engine dispatch thunk under the watchdog.

    The thunk runs in a daemon worker thread, joined with the deadline; a
    join timeout is a wedge: the worker is abandoned (its stop flag set,
    see :func:`check_stop`), the trip is recorded in ``stats``, and the
    thunk runs again, up to the retry budget. After a deadline miss the
    worker gets one grace join (25% of the deadline, at most 60 s), so a
    dispatch that ends just past the deadline is harvested, not raced.
    Each attempt must own what it writes (the engines give it a copy of
    their state and a fresh stats dict), so a retry is exact.

    Exceptions from the thunk propagate unchanged; classification and the
    ledger are :func:`run_guarded`'s. Raises :class:`WedgedDispatch` when
    the budget is spent. ``shape`` is accepted for the JAX package's
    signature (its trace span); the port records no span."""
    del shape
    deadline = deadline_s if deadline_s is not None \
        else base_deadline_s() * scale
    if not enabled():
        return thunk()
    attempts = max(1, (retries if retries is not None
                       else retry_budget()) + 1)
    for _ in range(attempts):
        if _consume_fault_injection(site):
            # An injected fault raises as a dead worker would, without
            # touching the device.
            raise InjectedFault(
                f"injected fault at site {site!r} "
                f"(JEPSEN_TPU_FAULT/inject_fault test hook)")
        fn = thunk
        join_deadline = deadline
        stop = threading.Event()
        inj = _consume_injection(site)
        if inj is not None:
            # A fake wedge blocks past the deadline without running the
            # real dispatch, and ends when it is abandoned.
            if inj > 0:
                join_deadline = inj
            fn = lambda: stop.wait(join_deadline * 10)  # noqa: E731
        result: list = []
        err: list = []
        spent: list = []

        def run(fn=fn, stop=stop):
            _attempt.stop = stop
            t = time.perf_counter()
            try:
                result.append(fn())
            except BaseException as e:  # noqa: BLE001 - below
                err.append(e)
            finally:
                spent.append(time.perf_counter() - t)
                _attempt.stop = None

        t0 = time.perf_counter()
        worker = threading.Thread(target=run, daemon=True,
                                  name=f"supervised-{site}")
        worker.start()
        worker.join(join_deadline)
        if worker.is_alive():
            worker.join(min(join_deadline * 0.25, 60.0))
        if worker.is_alive():
            stop.set()
            with _lock:
                _abandoned[:] = [t for t in _abandoned if t.is_alive()]
                _abandoned.append(worker)
            _note_event(stats, site, "wedge")
            continue
        if err:
            raise err[0]
        _totals["calls"] += 1
        _totals["handoff_s"] += max(0.0, time.perf_counter() - t0
                                    - spent[0])
        st = _sites.setdefault(site, [0, 0.0, 0.0])
        st[0] += 1
        st[1] += spent[0]
        st[2] = max(st[2], spent[0])
        return result[0]
    raise WedgedDispatch(site, deadline, attempts)


def is_fault(e: BaseException) -> bool:
    """A device fault: an injected one, a kernel's launch error code
    (``_build.LaunchError``) or a CUDA error torch raised. Not an
    out-of-memory error, a failed library load or build, or any other
    exception: those raise through every site."""
    if isinstance(e, (InjectedFault, _build.LaunchError)):
        return True
    return isinstance(e, RuntimeError) \
        and not isinstance(e, _build.BuildError) \
        and type(e).__name__ != "OutOfMemoryError" \
        and "CUDA error" in str(e)


def _context_poisoned() -> bool:
    """After a CUDA error: whether the process's CUDA context is gone (a
    sticky fault makes every later call fail). Asks without waiting."""
    import torch

    if not torch.cuda.is_initialized():
        return False
    try:
        torch.cuda.current_stream().query()
    except RuntimeError:
        return True
    return False


def run_guarded(site: str, key: str, thunk: Callable, *,
                scale: float = 1.0, stats: dict | None = None,
                retries: int | None = None):
    """:func:`call` with the fault taxonomy and the ledger. Returns
    ``(outcome, value)``: ``("ok", result)``, ``("wedge",
    WedgedDispatch)`` (budget spent, shape recorded) or ``("fault",
    exc)`` (:func:`is_fault`: event noted in ``stats``, shape recorded).
    A sticky CUDA fault is recorded and then raised: the process cannot
    launch again. Every other exception propagates, a failed kernel
    build (``_build.BuildError``) among them."""
    try:
        return "ok", call(site, thunk, scale=scale, stats=stats,
                          retries=retries, shape=key)
    except WedgedDispatch as e:
        record_fault(key, "wedge")
        return "wedge", e
    except Exception as e:
        if not is_fault(e):
            raise
        note_fault(stats, site, repr(e))
        record_fault(key, "fault", repr(e))
        if not isinstance(e, InjectedFault) and _context_poisoned():
            raise
        return "fault", e


# --- fault-shape quarantine ledger -------------------------------------------


def ledger_path() -> str | None:
    """The ledger file, ``JEPSEN_TPU_QUARANTINE``; None (no ledger) when
    it is unset or ``0``."""
    env = os.environ.get("JEPSEN_TPU_QUARANTINE", "")
    return env if env and env != "0" else None


def shape_key(site: str, *, cap: int, window: int, kernel: str,
              rows: int = 1, band: str = "") -> str:
    """The program-shape key: site, rows x cap, window and kernel, and
    ``band`` for variants that share a site but run different programs."""
    base = f"{site}|rows{rows}|cap{cap}|w{window}|{kernel}"
    return f"{base}|{band}" if band else base


_ledger_cache: tuple[str, float, dict] | None = None


def load_ledger(path: str | None = None) -> dict:
    """The ledger's ``shapes`` dict ({} when absent, disabled or
    corrupt: a damaged ledger never blocks a check), cached by mtime."""
    global _ledger_cache
    path = path or ledger_path()
    if path is None:
        return {}
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return {}
    if _ledger_cache is not None and _ledger_cache[0] == path \
            and _ledger_cache[1] == mtime:
        return _ledger_cache[2]
    try:
        with open(path) as fh:
            shapes = json.load(fh).get("shapes", {})
    except (OSError, ValueError):
        return {}
    _ledger_cache = (path, mtime, shapes)
    return shapes


# One wedge does not quarantine a shape (a stall may be environmental); a
# streak of WEDGE_QUARANTINE_COUNT wedges of the same shape within the
# window does, and a fault quarantines at once.
WEDGE_QUARANTINE_COUNT = 2
WEDGE_STREAK_WINDOW_S = 6 * 3600.0

_TS_FMT = "%Y-%m-%dT%H:%M:%SZ"


def _parse_ts(s) -> float | None:
    try:
        return calendar.timegm(time.strptime(s, _TS_FMT))
    except (TypeError, ValueError):
        return None


def quarantined(key: str, path: str | None = None) -> dict | None:
    """The ledger entry of a quarantined shape, else None."""
    e = load_ledger(path).get(key)
    if e is None:
        return None
    # A static-gate prediction (written by the JAX package's gate) does
    # not quarantine unless the shape also faulted.
    if e.get("reason") == "static" and not e.get("faulted"):
        return None
    if e.get("reason") == "wedge" and not e.get("faulted") \
            and e.get("streak", e.get("count", 0)) \
            < WEDGE_QUARANTINE_COUNT:
        return None
    return e


def _write_json_atomic(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _write_ledger(path: str, shapes: dict) -> None:
    global _ledger_cache
    _write_json_atomic(path, {"version": LEDGER_VERSION, "shapes": shapes})
    _ledger_cache = None


def record_fault(key: str, reason: str, detail: str = "",
                 path: str | None = None) -> dict | None:
    """Record (or re-record) a shape: ``reason`` "fault" (the dispatch
    raised), "wedge" (deadline) or "static" (a prediction, which never
    overwrites crash evidence). Read-modify-write with an atomic
    replace; the last writer wins."""
    path = path or ledger_path()
    if path is None:
        return None
    shapes = dict(load_ledger(path))
    now_s = time.time()
    now = time.strftime(_TS_FMT, time.gmtime(now_s))
    e = dict(shapes.get(key) or {"first": now, "count": 0})
    if reason == "static" and e.get("reason") in ("wedge", "fault"):
        e["static_count"] = e.get("static_count", 0) + 1
        e["last_static"] = now
        shapes[key] = e
        _write_ledger(path, shapes)
        return e
    if reason == "wedge":
        prev = _parse_ts(e.get("last"))
        within = prev is not None and now_s - prev <= \
            WEDGE_STREAK_WINDOW_S
        e["streak"] = (e.get("streak", 0) + 1) if within else 1
    elif reason == "fault":
        e["faulted"] = True
    e.update(reason=reason, count=e.get("count", 0) + 1, last=now)
    if detail:
        e["detail"] = detail[:500]
    shapes[key] = e
    _write_ledger(path, shapes)
    return e


def clear_ledger(keys=None, path: str | None = None) -> int:
    """Remove ``keys`` (or every entry) from the ledger; returns how many
    were removed."""
    path = path or ledger_path()
    if path is None:
        return 0
    shapes = dict(load_ledger(path))
    if keys is None:
        removed = len(shapes)
        shapes = {}
    else:
        removed = 0
        for k in keys:
            if shapes.pop(k, None) is not None:
                removed += 1
    _write_ledger(path, shapes)
    return removed


def ledger_delta(before: dict, path: str | None = None) -> dict:
    """Shapes recorded (or re-recorded) since ``before``, a prior
    :func:`load_ledger` snapshot."""
    now = load_ledger(path)
    out = {}
    for k, e in now.items():
        old = before.get(k)
        if old is None or old.get("count") != e.get("count"):
            out[k] = e
    return out


# --- frontier checkpoint/resume ----------------------------------------------


def ckpt_path() -> str | None:
    return os.environ.get("JEPSEN_TPU_CKPT", "") or None


def ckpt_every_s() -> float:
    return util.env_float("JEPSEN_TPU_CKPT_EVERY_S", 60.0)


def history_fingerprint(p) -> str:
    """Identity of a packed history for resume safety (the JAX package's
    digest over the same tables): a checkpoint resumes only onto the same
    search input."""
    h = hashlib.sha256()
    h.update(f"{p.kernel.name if p.kernel else None}|{p.window}|{p.R}|"
             f"{len(p.unintern)}".encode())
    for a in (p.ret_slot, p.active, p.slot_f, p.slot_v, p.crashed,
              p.init_state):
        arr = np.ascontiguousarray(np.asarray(a))
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class Checkpointer:
    """Interval-gated frontier checkpoint writer (an atomic ``.npz``).

    The engines call ``save`` at committed row boundaries (after a clean
    chunk, after each committed host row); ``due()`` gates the
    device-to-host copy to once per ``every_s``. ``on_save`` is a test
    hook, ``seconds`` the wall time the engines spent checkpointing
    (their copy to the host and the write)."""

    def __init__(self, path: str, fingerprint: str,
                 every_s: float | None = None):
        self.path = path
        self.fingerprint = fingerprint
        self.every_s = ckpt_every_s() if every_s is None else every_s
        self._last = float("-inf")
        self.writes = 0
        self.seconds = 0.0
        self.on_save = None

    def due(self) -> bool:
        return time.monotonic() - self._last >= self.every_s

    def save(self, kind: str, row: int, count: int,
             arrays: dict, meta: dict | None = None) -> None:
        m = {"version": CKPT_VERSION, "fingerprint": self.fingerprint,
             "kind": kind, "row": int(row), "count": int(count)}
        m.update(meta or {})
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        payload["__meta__"] = np.frombuffer(
            json.dumps(m, default=str).encode(), dtype=np.uint8)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, self.path)
        self._last = time.monotonic()
        self.writes += 1
        if self.on_save is not None:
            self.on_save(kind, int(row))

    def clear(self) -> None:
        """Remove the checkpoint (on a definite verdict; an unknown, a
        cancel or a wedge keeps it so that a re-run continues)."""
        try:
            os.remove(self.path)
        except OSError:
            pass


def load_checkpoint(path: str, fingerprint: str) -> dict | None:
    """Load and validate a checkpoint: ``{"kind", "row", "count", "meta",
    <arrays>}``, or None when missing, corrupt, of another version or
    another history (the resume is then a fresh run)."""
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            if meta.get("version") != CKPT_VERSION:
                return None
            if meta.get("fingerprint") != fingerprint:
                return None
            out = {k: z[k] for k in z.files if k != "__meta__"}
    except Exception:  # noqa: BLE001 - any damage means "no checkpoint"
        return None
    out.update(kind=meta["kind"], row=int(meta["row"]),
               count=int(meta["count"]), meta=meta)
    return out


# --- numpy packed-key codec ---------------------------------------------------
# Host mirror of bfs._pack/_unpack_frontier_keys[2]: the CPU-oracle rung
# and the host-kind resume decode and encode frontiers without the device.

KEY_FILL = np.uint32(0xFFFFFFFF)


def np_unpack_keys(lo, hi, count, b, nil_id, nw, key_hi, nil_state):
    """(bits[count, nw] uint32, state[count, 1] int32) from packed key
    arrays (numpy, the first ``count`` live entries)."""
    n = int(count)
    lo = np.asarray(lo)[:n].astype(np.uint64)
    mask = np.uint64((1 << b) - 1)
    if key_hi:
        full = lo | (np.asarray(hi)[:n].astype(np.uint64) << np.uint64(32))
    else:
        full = lo
    sv = (full & mask).astype(np.int64)
    state = np.where(sv == nil_id, nil_state, sv).astype(np.int32)
    bits_full = full >> np.uint64(b)
    cols = [(bits_full & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    if nw > 1:
        cols.append((bits_full >> np.uint64(32)).astype(np.uint32))
    bits = np.stack(cols, axis=1)
    if nw > len(cols):
        bits = np.pad(bits, ((0, 0), (0, nw - len(cols))))
    return bits, state[:, None]


def np_pack_keys(bits, state, b, nil_id, key_hi, nil_state, cap):
    """(lo[cap], hi[cap] or None) uint32 arrays from unpacked frontier
    rows, KEY_FILL padded: the numpy twin of the packed-key encoding."""
    bits = np.asarray(bits, dtype=np.uint64)
    state = np.asarray(state)
    n = bits.shape[0]
    sv = state[:, 0].astype(np.int64)
    ps = np.where(sv == nil_state, nil_id, sv).astype(np.uint64)
    full = (bits[:, 0] << np.uint64(b)) | ps
    if bits.shape[1] > 1:
        full = full | (bits[:, 1] << np.uint64(32 + b))
    lo = np.full(cap, KEY_FILL, np.uint32)
    lo[:n] = (full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if not key_hi:
        return lo, None
    hi = np.full(cap, KEY_FILL, np.uint32)
    hi[:n] = (full >> np.uint64(32)).astype(np.uint32)
    return lo, hi
