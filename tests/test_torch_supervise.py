"""The port's supervised runtime (``jepsen_tpu_torch.lin.supervise``)
against the JAX package's ``jepsen_tpu.lin.supervise``, on the CPU.

The unit cases are the JAX package's own (the watchdog, the injection
hooks, the quarantine ledger, the checkpoint codec) run against the port's
module, and the port's fingerprint, shape key and numpy key codec equal
the JAX package's on the same inputs. The ladder cases drive both
packages' engines (the port on ``device="cpu"``, the reference in its
per-row host-row mode) under the same injected wedges, faults and
quarantines, at the sites ``host-fixpoint``, ``host-pass``, ``chunk``,
``spike``, ``txn-scc`` and ``pack-dev``: the same verdict or the same
honest unknown, with the trips in the stats and the shapes in the
ledger. Every comparison is exact."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu import txn as jtxn
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import pack_dev as jpd
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import supervise as jsup
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu.txn import synth as jtsynth
from jepsen_tpu_torch import _build
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import txn as ttxn
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import pack_dev as tpd
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import supervise
from jepsen_tpu_torch.lin import synth as tsynth
from jepsen_tpu_torch.txn import synth as ttsynth

KEYS = ("valid?", "dead-row", "op", "final-frontier-size", "max-cap",
        "overflow", "error")
HOST_KEYS = ("rows", "dispatches", "passes", "wasted_passes",
             "watchdog_trips", "faults", "quarantine_skips", "cpu_rows")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # No injection leaks between tests; the reference's host-row executor
    # runs in its per-row mode (the port's); one torch thread.
    for k in ("JEPSEN_TPU_WEDGE", "JEPSEN_TPU_FAULT", "JEPSEN_TPU_SUPERVISE",
              "JEPSEN_TPU_DISPATCH_DEADLINE_S", "JEPSEN_TPU_CKPT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("JEPSEN_TPU_HOST_SCHED", "0")
    monkeypatch.setenv("JEPSEN_TPU_HOST_ROWS_K", "1")
    monkeypatch.setenv("JEPSEN_TPU_HOST_STICKY", "1")
    for mod in (supervise, jsup):
        mod.reset_injections()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    # Abandoned attempts end at their next boundary: let them, so that none
    # outlives its test.
    assert supervise.join_abandoned(30.0)
    torch.set_num_threads(n)
    for mod in (supervise, jsup):
        mod.reset_injections()


@pytest.fixture()
def ledger(tmp_path, monkeypatch):
    path = str(tmp_path / "quarantine.json")
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", path)
    return path


# --- the dispatch watchdog --------------------------------------------------


def test_call_passes_through_value_and_exceptions():
    assert supervise.call("t", lambda: 42, deadline_s=5) == 42
    with pytest.raises(ValueError):
        supervise.call("t", lambda: (_ for _ in ()).throw(ValueError()),
                       deadline_s=5)


def test_wedge_detected_within_deadline_and_retried():
    supervise.inject_wedge("t", 1, deadline_s=0.2)
    stats: dict = {}
    t0 = time.monotonic()
    out = supervise.call("t", lambda: "real", deadline_s=9, stats=stats)
    dt = time.monotonic() - t0
    assert out == "real"
    assert 0.15 <= dt < 2.0, f"detection took {dt:.2f}s, not ~0.2s"
    assert stats["watchdog_trips"] == 1
    assert stats["supervise_events"] == [{"site": "t", "kind": "wedge"}]


def test_wedge_budget_exhaustion_raises():
    supervise.inject_wedge("t", 5, deadline_s=0.05)
    stats: dict = {}
    with pytest.raises(supervise.WedgedDispatch):
        supervise.call("t", lambda: "never", deadline_s=9, retries=1,
                       stats=stats)
    assert stats["watchdog_trips"] == 2      # initial attempt + 1 retry


@pytest.mark.parametrize("mod", [supervise, jsup], ids=["port", "jax"])
def test_env_hooks_parse_site_count_deadline(monkeypatch, mod):
    monkeypatch.setenv("JEPSEN_TPU_WEDGE", "a:2:0.05,b")
    monkeypatch.setenv("JEPSEN_TPU_FAULT", "c:2,d")
    mod._env_wedge_loaded = mod._env_fault_loaded = None
    assert [mod._consume_injection("a") for _ in range(3)] == \
        [0.05, 0.05, None]
    assert [mod._consume_injection("b") for _ in range(2)] == [-1.0, None]
    assert [mod._consume_fault_injection("c") for _ in range(3)] == \
        [True, True, False]
    assert [mod._consume_fault_injection("d") for _ in range(2)] == \
        [True, False]


def test_disabled_supervision_runs_inline(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_SUPERVISE", "0")
    supervise.inject_wedge("t", 1)
    supervise.inject_fault("t", 1)
    # Injections are never consumed when disabled: a plain passthrough.
    assert supervise.call("t", lambda: threading.current_thread(),
                          deadline_s=0.01) is threading.main_thread()


def test_an_abandoned_attempt_stops_at_its_next_boundary():
    # The real thunk overruns; the watchdog abandons it, and at its next
    # boundary check it raises instead of going on.
    steps, ended = [], threading.Event()

    def thunk():
        try:
            for i in range(400):
                supervise.check_stop()
                steps.append(i)
                time.sleep(0.005)
            return "done"
        finally:
            ended.set()

    with pytest.raises(supervise.WedgedDispatch):
        supervise.call("t", thunk, deadline_s=0.05, retries=0)
    assert ended.wait(2.0)
    assert len(steps) < 100 and not supervise.stopped()


def test_a_failed_build_raises_and_is_not_a_fault(ledger):
    def thunk():
        raise _build.BuildError("native build failed: nvcc exit 1")

    stats: dict = {}
    with pytest.raises(_build.BuildError):
        supervise.run_guarded("chunk", "k", thunk, stats=stats)
    assert stats == {} and supervise.load_ledger() == {}
    # A device error is a fault: recorded, and no exception escapes.
    out, err = supervise.run_guarded(
        "chunk", "k", lambda: (_ for _ in ()).throw(
            RuntimeError("CUDA error: an illegal memory access")),
        stats=stats)
    assert out == "fault" and stats["faults"] == 1
    assert supervise.quarantined("k")["faulted"] is True


# --- the quarantine ledger --------------------------------------------------


def test_ledger_record_load_clear_delta(ledger):
    key = supervise.shape_key("host-fixpoint", rows=1, cap=4096, window=34,
                              kernel="cas-register")
    assert supervise.quarantined(key) is None
    before = dict(supervise.load_ledger())
    e = supervise.record_fault(key, "fault", detail="boom")
    assert e["count"] == 1 and e["reason"] == "fault"
    e2 = supervise.record_fault(key, "wedge")
    assert e2["count"] == 2 and e2["reason"] == "wedge"
    assert e2["first"] == e["first"]
    got = supervise.quarantined(key)
    assert got is not None and got["count"] == 2
    assert set(supervise.ledger_delta(before)) == {key}
    other = supervise.shape_key("spike", rows=32, cap=262144, window=49,
                                kernel="cas-register")
    supervise.record_fault(other, "fault")
    assert supervise.clear_ledger(keys=[key]) == 1
    assert supervise.quarantined(key) is None
    assert supervise.quarantined(other) is not None
    assert supervise.clear_ledger() == 1
    assert supervise.load_ledger() == {}


def test_single_wedge_tolerated_fault_quarantines(ledger):
    wk = supervise.shape_key("host-fixpoint", cap=4096, window=34,
                             kernel="cas-register")
    supervise.record_fault(wk, "wedge")
    assert supervise.quarantined(wk) is None
    supervise.record_fault(wk, "wedge")
    assert supervise.quarantined(wk) is not None
    fk = supervise.shape_key("host-pass", cap=4096, window=34,
                             kernel="cas-register")
    supervise.record_fault(fk, "fault")
    assert supervise.quarantined(fk) is not None


def test_wedge_streak_resets_outside_window(ledger):
    key = "host-fixpoint|rows1|cap4096|w34|cas-register"
    supervise.record_fault(key, "wedge")
    shapes = dict(supervise.load_ledger())
    old = time.strftime(supervise._TS_FMT, time.gmtime(
        time.time() - 2 * supervise.WEDGE_STREAK_WINDOW_S))
    shapes[key] = dict(shapes[key], last=old)
    supervise._write_ledger(supervise.ledger_path(), shapes)
    e = supervise.record_fault(key, "wedge")
    assert e["streak"] == 1 and e["count"] == 2
    assert supervise.quarantined(key) is None
    e = supervise.record_fault(key, "wedge")
    assert e["streak"] == 2
    assert supervise.quarantined(key) is not None


def test_ledger_corruption_never_blocks(ledger):
    with open(ledger, "w") as fh:
        fh.write("{not json")
    assert supervise.load_ledger() == {}
    supervise.record_fault("k", "fault")
    assert supervise.quarantined("k") is not None


def test_ledger_disabled_and_its_default(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", "0")
    assert supervise.ledger_path() is None
    assert supervise.record_fault("k", "fault") is None
    assert supervise.quarantined("k") is None
    # By default there is no ledger: a shape recorded once must not keep
    # a later run off a kernel unasked (the JAX package's is on, beside
    # its XLA programs).
    monkeypatch.delenv("JEPSEN_TPU_QUARANTINE")
    assert supervise.ledger_path() is None
    assert supervise.record_fault("k", "fault") is None
    assert jsup.ledger_path() is not None
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", "/x/q.json")
    assert supervise.ledger_path() == "/x/q.json"


def _raise(e):
    def thunk():
        raise e
    return thunk


@pytest.mark.parametrize("exc,fault", [
    (supervise.InjectedFault("injected"), True),
    (_build.LaunchError("psort kernel launch failed: CUDA error 700"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), False),
    (OSError("libpsort.so: cannot open shared object file"), False),
    (RuntimeError("shape mismatch"), False),
    (ValueError("bad input"), False),
], ids=["injected", "launch-error", "cuda-error", "oom", "oserror",
        "runtime-error", "value-error"])
def test_only_cuda_errors_are_faults(ledger, exc, fault):
    # Only a CUDA error is a fault of the card, recorded and routed; an
    # out-of-memory error, a failed library load or any other exception
    # raises through the site, and nothing is recorded.
    stats: dict = {}
    assert supervise.is_fault(exc) is fault
    if fault:
        out, err = supervise.run_guarded("chunk", "k", _raise(exc),
                                         stats=stats)
        assert (out, err, stats["faults"]) == ("fault", exc, 1)
        assert supervise.quarantined("k") is not None
    else:
        with pytest.raises(type(exc)):
            supervise.run_guarded("chunk", "k", _raise(exc), stats=stats)
        assert stats == {} and supervise.load_ledger() == {}


def test_ledger_files_are_shared_with_the_jax_package(ledger):
    # Same keys, same file format: an entry either package records
    # quarantines the shape for the other.
    key = supervise.shape_key("host-pass", cap=64, window=6,
                              kernel="cas-register")
    assert key == jsup.shape_key("host-pass", cap=64, window=6,
                                 kernel="cas-register")
    assert key == "host-pass|rows1|cap64|w6|cas-register"
    assert supervise.shape_key("pack-dev", cap=256, window=16,
                               kernel="pack-vw1", rows=4, band="r128") == \
        jsup.shape_key("pack-dev", cap=256, window=16, kernel="pack-vw1",
                       rows=4, band="r128")
    jsup.record_fault(key, "fault", detail="x")
    assert supervise.quarantined(key)["detail"] == "x"
    supervise.record_fault("other", "wedge")
    supervise.record_fault("other", "wedge")
    assert jsup.quarantined("other")["streak"] == 2


# --- the checkpoint codec ---------------------------------------------------


def test_checkpoint_roundtrip_and_fingerprint_gate(tmp_path):
    path = str(tmp_path / "c.npz")
    ck = supervise.Checkpointer(path, "fp1", every_s=0)
    seen = []
    ck.on_save = lambda kind, row: seen.append((kind, row))
    lo = np.arange(7, dtype=np.uint32)
    ck.save("host", 42, 7, {"lo": lo},
            {"key_hi": False, "b": 3, "nil_id": 2, "nw": 1,
             "sticky_lvl": 1})
    assert seen == [("host", 42)]
    for load in (supervise.load_checkpoint, jsup.load_checkpoint):
        rd = load(path, "fp1")
        assert rd["kind"] == "host" and rd["row"] == 42 and rd["count"] == 7
        assert rd["meta"]["sticky_lvl"] == 1
        np.testing.assert_array_equal(rd["lo"], lo)
        assert load(path, "fp2") is None
    ck.clear()
    assert not os.path.exists(path)
    assert supervise.load_checkpoint(path, "fp1") is None


def test_checkpoint_corruption_degrades_to_fresh(tmp_path):
    path = str(tmp_path / "c.npz")
    with open(path, "wb") as fh:
        fh.write(b"not an npz")
    assert supervise.load_checkpoint(path, "fp") is None


def test_checkpoint_interval_gating(tmp_path):
    ck = supervise.Checkpointer(str(tmp_path / "c.npz"), "fp",
                                every_s=3600)
    assert ck.due()
    ck.save("chunk", 1, 1, {"bits": np.zeros((1, 1), np.uint32),
                            "state": np.zeros((1, 1), np.int32)}, {})
    assert not ck.due() and ck.writes == 1


@pytest.mark.parametrize("key_hi,b,nw", [(False, 3, 1), (True, 5, 2),
                                         (True, 3, 1)])
def test_np_key_codec_roundtrip_and_jax_parity(key_hi, b, nw):
    nil_state = -(2 ** 31)
    nil_id = (1 << b) - 1
    rng = np.random.default_rng(7)
    n = 17
    width = (64 - b if key_hi else 31 - b)
    bits = np.zeros((n, nw), np.uint32)
    for w in range(nw):
        hi_bits = max(0, min(32, width - 32 * w))
        if hi_bits:
            bits[:, w] = rng.integers(0, 1 << hi_bits, n, np.uint32,
                                      endpoint=False)
    state = rng.integers(0, nil_id, (n, 1)).astype(np.int32)
    state[::5] = nil_state
    lo, hi = supervise.np_pack_keys(bits, state, b, nil_id, key_hi,
                                    nil_state, cap=n + 3)
    jlo, jhi = jsup.np_pack_keys(bits, state, b, nil_id, key_hi, nil_state,
                                 cap=n + 3)
    np.testing.assert_array_equal(lo, jlo)
    assert (hi is None) == (jhi is None)
    if hi is not None:
        np.testing.assert_array_equal(hi, jhi)
    assert (lo[n:] == supervise.KEY_FILL).all()
    b2, s2 = supervise.np_unpack_keys(lo, hi, n, b, nil_id, nw, key_hi,
                                      nil_state)
    jb2, js2 = jsup.np_unpack_keys(lo, hi, n, b, nil_id, nw, key_hi,
                                   nil_state)
    np.testing.assert_array_equal(b2, bits)
    np.testing.assert_array_equal(s2, state)
    np.testing.assert_array_equal(b2, jb2)
    np.testing.assert_array_equal(s2, js2)


@pytest.mark.parametrize("case", ["register", "partitioned", "mutex"])
def test_history_fingerprint_is_the_jax_packages(case):
    def make(synth):
        if case == "register":
            return synth.generate_register_history(120, concurrency=5,
                                                   seed=3, crash_prob=0.05)
        if case == "partitioned":
            return synth.generate_partitioned_register_history(
                140, concurrency=40, seed=0, partition_every=60,
                partition_len=20, max_crashes=10)
        return synth.generate_mutex_history(100, concurrency=4, seed=1)

    model = "mutex" if case == "mutex" else "cas_register"
    pj = jprep.prepare(getattr(jm, model)(), make(jsynth))
    pt = tprep.prepare(getattr(tm, model)(), make(tsynth))
    assert supervise.history_fingerprint(pt) == \
        jsup.history_fingerprint(pj)


def test_module_constants_and_knobs_match(monkeypatch):
    for name in ("CKPT_VERSION", "LEDGER_VERSION", "MAX_EVENTS",
                 "WEDGE_QUARANTINE_COUNT", "WEDGE_STREAK_WINDOW_S"):
        assert getattr(supervise, name) == getattr(jsup, name)
    for fn in ("base_deadline_s", "retry_budget", "cpu_row_max",
               "ckpt_every_s", "enabled", "ckpt_path"):
        assert getattr(supervise, fn)() == getattr(jsup, fn)()
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_DEADLINE_S", "2.5")
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_RETRIES", "3")
    monkeypatch.setenv("JEPSEN_TPU_CPU_ROW_MAX", "9")
    monkeypatch.setenv("JEPSEN_TPU_CKPT_EVERY_S", "0")
    monkeypatch.setenv("JEPSEN_TPU_CKPT", "/x.npz")
    assert (supervise.base_deadline_s(), supervise.retry_budget(),
            supervise.cpu_row_max(), supervise.ckpt_every_s(),
            supervise.ckpt_path()) == (2.5, 3, 9, 0.0, "/x.npz")


# --- the fallback ladder on both engines ------------------------------------


def _band(synth, n=60, seed=1):
    return synth.generate_register_history(n, concurrency=6, seed=seed,
                                           crash_prob=0.25)


@pytest.fixture(scope="module")
def band():
    """The JAX package's small crash-dom ladder shape, in both packages.
    At chunk cap 12 every host-row hand-back fits the chunk cap, so the
    packages run the same rows."""
    return (jprep.prepare(jm.cas_register(), _band(jsynth)),
            tprep.prepare(tm.cas_register(), _band(tsynth)))


CAPS = dict(cap_schedule=(12,), host_caps=(8, 64, 512))


def _both(band, tmp_path, monkeypatch, inject=None, **kw):
    """The band shape through both engines, each with its own ledger
    (``inject(mod)`` arms both modules' hooks before their runs)."""
    out = []
    for name, mod, bfs, p, extra in (
            ("jax", jsup, jbfs, band[0], {}),
            ("port", supervise, tbfs, band[1], {"device": "cpu"})):
        monkeypatch.setenv("JEPSEN_TPU_QUARANTINE",
                           str(tmp_path / f"{name}.json"))
        if inject is not None:
            inject(mod)
        out.append(bfs.check_packed(p, **CAPS, **kw, **extra))
        mod.reset_injections()
    return out


def _same(rj, rt):
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    hj, ht = rj.get("host-stats", {}), rt.get("host-stats", {})
    assert {k: ht.get(k, 0) for k in HOST_KEYS} == \
        {k: hj.get(k, 0) for k in HOST_KEYS}
    assert ht.get("supervise_events") == hj.get("supervise_events")


def _ledger(tmp_path, name):
    with open(tmp_path / f"{name}.json") as fh:
        return json.load(fh)["shapes"]


def test_clean_ladder_run_is_the_references(band, tmp_path, monkeypatch):
    rj, rt = _both(band, tmp_path, monkeypatch)
    _same(rj, rt)
    assert rt["valid?"] is True and rt["host-stats"]["rows"] > 0
    assert rt["host-stats"]["watchdog_trips"] == 0


def test_a_wedge_at_host_fixpoint_is_retried(band, tmp_path, monkeypatch):
    rj, rt = _both(band, tmp_path, monkeypatch, lambda mod: mod.inject_wedge(
        "host-fixpoint", 1, deadline_s=0.2))
    _same(rj, rt)
    assert rt["valid?"] is True
    assert rt["host-stats"]["watchdog_trips"] == 1
    assert rt["host-stats"]["supervise_events"] == [
        {"site": "host-fixpoint", "kind": "wedge"}]
    assert not os.path.exists(tmp_path / "port.json")   # one wedge: no record


def test_exhausted_wedges_quarantine_and_fall_to_host_pass(
        band, tmp_path, monkeypatch):
    rj, rt = _both(band, tmp_path, monkeypatch, lambda mod: mod.inject_wedge(
        "host-fixpoint", 500, deadline_s=0.05))
    _same(rj, rt)
    hs = rt["host-stats"]
    assert rt["valid?"] is True and hs["watchdog_trips"] >= 4
    assert hs["cpu_rows"] == 0 and hs["dispatches"] > hs["rows"]
    led = _ledger(tmp_path, "port")
    assert led == {k: dict(e, first=led[k]["first"], last=led[k]["last"])
                   for k, e in _ledger(tmp_path, "jax").items()}
    assert led and all(k.startswith("host-fixpoint|") and
                       e["reason"] == "wedge" for k, e in led.items())
    # A second exhausted call of one shape makes a streak: quarantined.
    assert any(supervise.quarantined(k, str(tmp_path / "port.json"))
               for k in led)
    # A fresh run reads the ledger: no wedge, the quarantined shapes
    # skipped.
    for k in led:
        supervise.record_fault(k, "wedge", path=str(tmp_path / "port.json"))
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "port.json"))
    r3 = tbfs.check_packed(band[1], **CAPS, device="cpu")
    assert r3["valid?"] is True and r3["host-stats"]["watchdog_trips"] == 0
    assert r3["host-stats"]["quarantine_skips"] >= 1


def test_everything_quarantined_reaches_the_cpu_oracle(band, ledger):
    W = band[1].window
    for cap in CAPS["host_caps"]:
        for site in ("host-fixpoint", "host-pass"):
            supervise.record_fault(supervise.shape_key(
                site, cap=cap, window=W, kernel="cas-register"), "fault")
    # At chunk cap 16 the CPU oracle's hand-backs fit the chunk cap too
    # (at 12 the reference cuts one, ROADMAP section 3).
    caps = dict(CAPS, cap_schedule=(16,))
    rj = jbfs.check_packed(band[0], **caps)
    rt = tbfs.check_packed(band[1], **caps, device="cpu")
    _same(rj, rt)
    hs = rt["host-stats"]
    assert rt["valid?"] is True and hs["cpu_rows"] == hs["rows"] >= 1
    assert hs["quarantine_skips"] == 2 * hs["cpu_rows"]
    assert hs["dispatches"] == 0


def test_wedged_host_passes_end_at_the_cpu_oracle_with_the_oracle_verdict(
        tmp_path, monkeypatch):
    # The corrupted window-34 pair-band shape: its host rows run on the
    # CPU oracle (every device rung wedged), and the verdict, dead row and
    # op are the oracle's and the reference's under the same injection.
    spec = dict(concurrency=40, seed=0, partition_every=60,
                partition_len=20, max_crashes=10)
    ps = [prep.prepare(m.cas_register(), s.corrupt_history(
        s.generate_partitioned_register_history(140, **spec), seed=3))
        for prep, m, s in ((jprep, jm, jsynth), (tprep, tm, tsynth))]
    kw = dict(cap_schedule=(8,), host_caps=(64, 4096))
    res = []
    for name, mod, bfs, p, extra in (
            ("jax", jsup, jbfs, ps[0], {}),
            ("port", supervise, tbfs, ps[1], {"device": "cpu"})):
        monkeypatch.setenv("JEPSEN_TPU_QUARANTINE",
                           str(tmp_path / f"{name}.json"))
        mod.inject_wedge("host-fixpoint", 100, deadline_s=0.02)
        mod.inject_wedge("host-pass", 100, deadline_s=0.02)
        res.append(bfs.check_packed(p, **kw, **extra))
        mod.reset_injections()
    rj, rt = res
    from jepsen_tpu_torch.lin import cpu as tcpu

    want = tcpu.check_packed(ps[1])
    assert rt["valid?"] is False is want["valid?"]
    assert (rt["dead-row"], rt["op"]) == (rj["dead-row"], rj["op"])
    assert rt["op"] == want["op"]
    # At chunk cap 8 the packages' episodes start a row apart (the
    # reference's cut hand-back, ROADMAP section 3): both end on the
    # oracle's rows.
    assert rt["host-stats"]["cpu_rows"] >= 1
    assert rj["host-stats"]["cpu_rows"] >= 1
    assert rt["host-stats"]["dispatches"] == 0


def test_a_filter_after_a_per_pass_rung_is_never_skipped(band, ledger):
    # A row whose fused fixpoint overflows at one cap and whose fused shape
    # is quarantined at the next runs the per-pass rung there, and its
    # return filter still runs: the verdict and the frontier are the clean
    # run's.
    clean = tbfs.check_packed(band[1], **CAPS, device="cpu")
    W = band[1].window
    for cap in CAPS["host_caps"][1:]:
        supervise.record_fault(supervise.shape_key(
            "host-fixpoint", cap=cap, window=W, kernel="cas-register"),
            "fault")
    r = tbfs.check_packed(band[1], **CAPS, device="cpu")
    assert r["host-stats"]["quarantine_skips"] >= 1
    assert {k: r.get(k) for k in KEYS} == {k: clean.get(k) for k in KEYS}


@pytest.mark.parametrize("kind", ["fault", "wedge"])
def test_a_chunk_fault_or_wedge_is_an_honest_unknown(band, tmp_path,
                                                     monkeypatch, kind):
    def inject(mod):
        if kind == "fault":
            mod.inject_fault("chunk", 1)
        else:
            mod.inject_wedge("chunk", 2, deadline_s=0.05)

    # explain=True: the reference's first chunk then runs at its "chunk"
    # site (without it, at "chunk-batch", which the port does not have).
    rj, rt = _both(band, tmp_path, monkeypatch, inject, explain=True)
    assert rt["valid?"] == "unknown" and rt["overflow"] == kind
    assert rt["valid?"] == rj["valid?"] and rt["overflow"] == rj["overflow"]
    if kind == "fault":
        assert rt["error"] == rj["error"]
        assert rt["host-stats"]["faults"] == 1
    else:
        assert rt["host-stats"]["watchdog_trips"] == 2
    assert rt["host-stats"]["supervise_events"] == \
        rj["host-stats"]["supervise_events"]
    led = _ledger(tmp_path, "port")
    assert list(led) == list(_ledger(tmp_path, "jax")) == \
        [f"chunk|rows512|cap12|w{band[1].window}|cas-register"]


@pytest.mark.parametrize("kind", ["fault", "wedge"])
def test_a_spike_fault_or_wedge_is_an_honest_unknown(tmp_path, monkeypatch,
                                                     kind):
    kw = dict(concurrency=16, seed=7, value_range=5)
    ps = (jprep.prepare(jm.cas_register(),
                        jsynth.generate_register_history(60, **kw)),
          tprep.prepare(tm.cas_register(),
                        tsynth.generate_register_history(60, **kw)))
    res = []
    for name, mod, bfs, p, extra in (
            ("jax", jsup, jbfs, ps[0], {}),
            ("port", supervise, tbfs, ps[1], {"device": "cpu"})):
        monkeypatch.setenv("JEPSEN_TPU_QUARANTINE",
                           str(tmp_path / f"{name}.json"))
        if kind == "fault":
            mod.inject_fault("spike", 1)
        else:
            mod.inject_wedge("spike", 2, deadline_s=0.05)
        res.append(bfs.check_packed(p, cap_schedule=(256,),
                                    spike_caps=(2048,), explain=True,
                                    **extra))
        mod.reset_injections()
    rj, rt = res
    assert rt["valid?"] == "unknown" and rt["overflow"] == kind
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    assert rt["host-stats"]["supervise_events"] == \
        rj["host-stats"]["supervise_events"]
    assert list(_ledger(tmp_path, "port")) == \
        list(_ledger(tmp_path, "jax")) == \
        [f"spike|rows32|cap2048|w{ps[1].window}|cas-register"]


# --- txn-scc and pack-dev ---------------------------------------------------


def _txn_comparable(r):
    r = json.loads(json.dumps(r, default=str))
    r.pop("analyzer", None)
    r.get("device-stats", {}).pop("seconds", None)
    return r


@pytest.mark.parametrize("how", ["quarantine", "fault", "wedge"])
def test_txn_scc_falls_back_to_the_host_tarjan(tmp_path, monkeypatch, how):
    monkeypatch.setenv("JEPSEN_TPU_TXN_STATS", str(tmp_path / "s.json"))
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    jh = jtsynth.seeded_anomaly_history("G-single")
    th = ttsynth.seeded_anomaly_history("G-single")
    clean = ttxn.check(th, algorithm="gpu", device="cpu")
    tiers = clean["device-stats"]["tiers"]
    assert tiers["full"]["device"] is True
    res = []
    for name, mod, run in (
            ("jax", jsup, lambda: jtxn.check(jh, algorithm="tpu")),
            ("port", supervise, lambda: ttxn.check(th, algorithm="gpu",
                                                   device="cpu"))):
        monkeypatch.setenv("JEPSEN_TPU_QUARANTINE",
                           str(tmp_path / f"{name}.json"))
        if how == "quarantine":
            for tier, ts in tiers.items():
                if ts.get("device"):
                    mod.record_fault(mod.shape_key(
                        "txn-scc", cap=ts["e_pad"], window=0,
                        kernel=f"txn-{tier}", rows=ts["n_pad"]), "fault")
        elif how == "fault":
            mod.inject_fault("txn-scc", 1)
        elif how == "wedge":
            mod.inject_wedge("txn-scc", 2, deadline_s=0.05)
        res.append(run())
        mod.reset_injections()
    want, got = res
    assert _txn_comparable(got) == _txn_comparable(want)
    assert got["valid?"] is clean["valid?"] is False
    assert got["anomaly-types"] == clean["anomaly-types"]
    reason = "quarantined" if how == "quarantine" else how
    assert reason in got["fallbacks"].values()
    st = got["device-stats"]
    assert st["cpu_tiers"] == len(got["fallbacks"]) >= 1
    assert st.get({"quarantine": "quarantine_skips", "fault": "faults",
                   "wedge": "watchdog_trips"}[how], 0) >= 1


def _mutex(P):
    return P.generate_mutex_history(400, concurrency=5, seed=2,
                                    crash_prob=0.02, max_crashes=6)


@pytest.mark.parametrize("how", ["quarantine", "fault"])
def test_pack_dev_falls_back_to_the_host_pack(tmp_path, monkeypatch, how):
    # The JAX package's device packer is off in the test settings; these
    # cases compare it, so its knob is on.
    monkeypatch.setenv("JEPSEN_TPU_PACK_DEV", "1")
    jpre = jpd.prepack(jm.mutex(), _mutex(jsynth))
    tpre = tpd.prepack(tm.mutex(), _mutex(tsynth))
    shape = tpd.pad_shape(tpre.n, tpre.R, tpre.window, tpre.op_v.shape[1])
    out = {}
    for name, sup, pd, pre, kw in (("jax", jsup, jpd, jpre, {}),
                                   ("port", supervise, tpd, tpre,
                                    {"device": "cpu"})):
        monkeypatch.setenv("JEPSEN_TPU_QUARANTINE",
                           str(tmp_path / f"{name}.json"))
        if how == "quarantine":
            sup.record_fault(tpd._shape_key(shape, 1), "fault")
        else:
            sup.inject_fault("pack-dev", 1)
        pd.reset_dev_stats()
        out[name] = pd.materialize(pre, **kw)
    got, want = out["port"], out["jax"]
    host = tprep.prepare(tm.mutex(), _mutex(tsynth))
    for f in ("ret_slot", "ret_op", "active", "slot_f", "slot_v", "slot_op",
              "crashed", "init_state"):
        np.testing.assert_array_equal(getattr(got, f), getattr(host, f))
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    ts, js = tpd.dev_stats(), jpd.dev_stats()
    keys = ("dev_packs", "host_fallbacks", "quarantine_skips", "wedges",
            "faults")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["host_fallbacks"] == 1 and ts["dev_packs"] == 0


def test_a_real_deadline_trip_ends_on_the_cpu_oracle(tmp_path, monkeypatch):
    # The window-34 counterexample, killed at its first host-kind
    # checkpoint and resumed with a deadline far below any dispatch: every
    # real attempt overruns and is abandoned (its stop flag set), the
    # retries too, and the host rows end on the CPU oracle with the
    # uninterrupted run's dead row and op (the oracle's frontier is the
    # exact one, so its final paths may be others).
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    h = tsynth.corrupt_history(tsynth.generate_partitioned_register_history(
        140, concurrency=40, seed=0, partition_every=60, partition_len=20,
        max_crashes=10), seed=3)
    p = tprep.prepare(tm.cas_register(), h)
    kw = dict(cap_schedule=(8,), host_caps=(64, 4096), explain=True,
              device="cpu")
    full = tbfs.check_packed(p, **kw)
    path = str(tmp_path / "c.npz")
    ckpt = supervise.Checkpointer(path, supervise.history_fingerprint(p),
                                  every_s=0)
    cancel = threading.Event()
    ckpt.on_save = lambda kind, row: kind == "host" and cancel.set()
    tbfs.check_packed(p, cancel=cancel, checkpoint=ckpt, **kw)
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_DEADLINE_S", "1e-6")
    r = tbfs.check_packed(p, checkpoint=path, **kw)
    hs = r["host-stats"]
    assert (r["valid?"], r["dead-row"], r["op"]) == \
        (False, full["dead-row"], full["op"])
    assert r["final-paths"] and r["resumed-from-row"] >= 40
    assert hs["cpu_rows"] >= 1 and hs["watchdog_trips"] >= 4
    assert {e["site"] for e in hs["supervise_events"]} == \
        {"host-fixpoint", "host-pass"}


# --- the card's routing, on the CPU -----------------------------------------
# On the card no rung moves a dispatch's work to the host: the host-row
# ladder ends after the per-pass rung, txn-scc reports unknown and pack-dev
# raises. ``supervise.host_rungs`` is the one switch; these cases give it
# the card's answer and run on the CPU.


@pytest.fixture()
def card_routing(monkeypatch):
    monkeypatch.setattr(supervise, "host_rungs", lambda device: False)


@pytest.mark.parametrize("how", ["quarantine", "wedge", "fault"])
def test_on_the_card_a_failed_host_pass_is_an_honest_unknown(
        band, ledger, card_routing, how):
    W = band[1].window
    sites = ("host-fixpoint", "host-pass") if how == "quarantine" \
        else ("host-fixpoint",)
    for cap in CAPS["host_caps"]:
        for site in sites:
            supervise.record_fault(supervise.shape_key(
                site, cap=cap, window=W, kernel="cas-register"), "fault")
    if how == "wedge":
        supervise.inject_wedge("host-pass", 2, deadline_s=0.05)
    elif how == "fault":
        supervise.inject_fault("host-pass", 1)
    r = tbfs.check_packed(band[1], **CAPS, device="cpu")
    assert r["valid?"] == "unknown"
    assert r["overflow"] == ("fault" if how == "fault" else "wedge")
    hs = r["host-stats"]
    assert hs["cpu_rows"] == 0 and hs["rows"] == 1
    assert hs["quarantine_skips"] == len(sites)
    assert (hs["watchdog_trips"], hs["faults"]) == \
        {"quarantine": (0, 0), "wedge": (2, 0), "fault": (0, 1)}[how]


@pytest.mark.parametrize("how", ["quarantine", "fault", "wedge"])
def test_on_the_card_a_failed_txn_scc_is_an_honest_unknown(
        tmp_path, monkeypatch, card_routing, how):
    monkeypatch.setenv("JEPSEN_TPU_TXN_STATS", str(tmp_path / "s.json"))
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    th = ttsynth.seeded_anomaly_history("G-single")
    clean = ttxn.check(th, algorithm="gpu", device="cpu")
    assert clean["valid?"] is False and "fallbacks" not in clean
    if how == "quarantine":
        for tier, ts in clean["device-stats"]["tiers"].items():
            if ts.get("device"):
                supervise.record_fault(supervise.shape_key(
                    "txn-scc", cap=ts["e_pad"], window=0,
                    kernel=f"txn-{tier}", rows=ts["n_pad"]), "fault")
    elif how == "fault":
        supervise.inject_fault("txn-scc", 1)
    else:
        supervise.inject_wedge("txn-scc", 2, deadline_s=0.05)
    r = ttxn.check(th, algorithm="gpu", device="cpu")
    reason = "quarantined" if how == "quarantine" else how
    assert r["valid?"] == "unknown" and r["overflow"] == reason
    assert list(r["fallbacks"].values()) == [reason]
    assert "cpu_tiers" not in r["stats"]


@pytest.mark.parametrize("how", ["quarantine", "fault", "wedge"])
def test_on_the_card_a_failed_pack_dev_raises(tmp_path, monkeypatch,
                                              card_routing, how):
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    pre = tpd.prepack(tm.mutex(), _mutex(tsynth))
    shape = tpd.pad_shape(pre.n, pre.R, pre.window, pre.op_v.shape[1])
    if how == "quarantine":
        supervise.record_fault(tpd._shape_key(shape, 1), "fault")
    elif how == "fault":
        supervise.inject_fault("pack-dev", 1)
    else:
        supervise.inject_wedge("pack-dev", 2, deadline_s=0.05)
    tpd.reset_dev_stats()
    with pytest.raises({"quarantine": supervise.Quarantined,
                        "fault": supervise.InjectedFault,
                        "wedge": supervise.WedgedDispatch}[how]):
        tpd.materialize(pre, device="cpu")
    st = tpd.dev_stats()
    assert (st["host_fallbacks"], st["dev_packs"], st["host_lanes"]) == \
        (0, 0, 0)


def test_a_real_deadline_trip_on_the_card_is_an_honest_wedge_that_resumes(
        tmp_path, monkeypatch, card_routing):
    # The window-34 counterexample, killed at its first host-kind
    # checkpoint and resumed with a deadline far below any dispatch: every
    # real attempt of both host-row rungs overruns and is abandoned, and
    # the search ends in an honest wedge that keeps its checkpoint. A re-run
    # with the default deadline resumes from it to the uninterrupted
    # verdict and deletes it.
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    h = tsynth.corrupt_history(tsynth.generate_partitioned_register_history(
        140, concurrency=40, seed=0, partition_every=60, partition_len=20,
        max_crashes=10), seed=3)
    p = tprep.prepare(tm.cas_register(), h)
    kw = dict(cap_schedule=(8,), host_caps=(64, 4096), explain=True,
              device="cpu")
    full = tbfs.check_packed(p, **kw)
    path = str(tmp_path / "c.npz")
    ckpt = supervise.Checkpointer(path, supervise.history_fingerprint(p),
                                  every_s=0)
    cancel, saved = threading.Event(), []

    def on_save(kind, row):
        if kind == "host":
            saved.append(row)
            cancel.set()

    ckpt.on_save = on_save
    tbfs.check_packed(p, cancel=cancel, checkpoint=ckpt, **kw)
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_DEADLINE_S", "1e-6")
    r = tbfs.check_packed(p, checkpoint=path, **kw)
    hs = r["host-stats"]
    assert (r["valid?"], r["overflow"]) == ("unknown", "wedge")
    kept = supervise.load_checkpoint(path, ckpt.fingerprint)
    assert r["resumed-from-row"] == saved[0] and kept is not None
    assert hs["cpu_rows"] == 0 and hs["watchdog_trips"] >= 4
    assert {e["site"] for e in hs["supervise_events"]} == \
        {"host-fixpoint", "host-pass"}
    assert supervise.join_abandoned(30.0)
    monkeypatch.delenv("JEPSEN_TPU_DISPATCH_DEADLINE_S")
    r2 = tbfs.check_packed(p, checkpoint=path, **kw)
    assert (r2["valid?"], r2["dead-row"], r2["op"]) == \
        (False, full["dead-row"], full["op"])
    assert r2["resumed-from-row"] == kept["row"] and not os.path.exists(path)
