"""Frontier checkpoint/resume and the incremental entry of the port's
sparse engine (``jepsen_tpu_torch.lin.bfs.check_packed``), on the CPU.

A search killed at a committed row boundary and resumed from its
checkpoint must give the uninterrupted run's verdict, dead row, op and
final paths, and the CPU oracle's, on the JAX package's own shapes
(``tests/test_lin_ckpt_resume.py``: the window-34 pair-band witness, a
valid history's chunk-kind checkpoints, a checkpoint of another history);
a checkpoint either package writes, the other resumes. The incremental
entry: a history split at a row boundary, its first part run with
``partial=True`` and the rest entered with the carried frontier, gives the
JAX package's ``stream-frontier`` (count, row, rows as a set) and the
one-shot verdict, in the compact, crash-dom and multiword bands. Every
comparison is exact."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import supervise as jsup
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import lin as tlin
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import cpu as tcpu
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import supervise
from jepsen_tpu_torch.lin import synth as tsynth
from jepsen_tpu_torch.models.kernels import NIL


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    for k in ("JEPSEN_TPU_CKPT", "JEPSEN_TPU_WEDGE", "JEPSEN_TPU_FAULT"):
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    # Abandoned attempts end at their next boundary: let them, so that none
    # outlives its test.
    assert supervise.join_abandoned(30.0)
    torch.set_num_threads(n)


def _witness(lib):
    prep, m, s = lib
    h = s.generate_partitioned_register_history(
        140, concurrency=40, seed=0, partition_every=60, partition_len=20,
        max_crashes=10)
    return prep.prepare(m.cas_register(), s.corrupt_history(h, seed=3))


JAX = (jprep, jm, jsynth)
PORT = (tprep, tm, tsynth)
KW = dict(cap_schedule=(8,), host_caps=(64, 4096), explain=True)


@pytest.fixture(scope="module")
def witness():
    return _witness(PORT)


def _paths_key(result):
    return sorted(repr(sorted(od["index"] for od in fp["path"]))
                  for fp in result["final-paths"])


def _killed(check, p, path, fingerprint, kind_to_kill, mod=supervise):
    """Run ``check`` with a checkpoint and cancel it right after the first
    save of ``kind_to_kill`` (a kill -9 leaves the same file: writes are
    atomic). Returns (result, saves)."""
    ckpt = mod.Checkpointer(path, fingerprint, every_s=0)
    cancel = threading.Event()
    saves = []

    def on_save(kind, row):
        saves.append((kind, row))
        if kind == kind_to_kill:
            cancel.set()

    ckpt.on_save = on_save
    return check(p, cancel=cancel, checkpoint=ckpt), saves


# --- resume parity ----------------------------------------------------------


def test_resume_parity_on_witness_shape(witness, tmp_path):
    p = witness
    assert p.window + max(len(p.unintern), 2).bit_length() > 31
    assert len(p.crashed_ops) > 0
    full = tbfs.check_packed(p, **KW, device="cpu")
    assert full["valid?"] is False and full["final-paths"]
    ck = str(tmp_path / "witness.ckpt.npz")
    killed, saves = _killed(
        lambda p, **k: tbfs.check_packed(p, **KW, device="cpu", **k), p, ck,
        supervise.history_fingerprint(p), "host")
    assert killed["valid?"] == "unknown" and killed["error"] == "cancelled"
    assert os.path.exists(ck), "an interrupted run keeps its checkpoint"
    assert any(kind == "host" for kind, _ in saves)
    meta = supervise.load_checkpoint(ck, supervise.history_fingerprint(p))
    assert meta["kind"] == "host" and meta["meta"]["key_hi"] is True
    assert meta["meta"]["host_stats"]["rows"] >= 1
    assert "sticky_lvl" in meta["meta"]

    resumed = tbfs.check_packed(p, checkpoint=ck, **KW, device="cpu")
    assert resumed["valid?"] is False
    assert resumed["resumed-from-row"] == saves[-1][1]
    for k in ("op", "dead-row"):
        assert resumed[k] == full[k]
    assert _paths_key(resumed) == _paths_key(full)
    want = tcpu.check_packed(p)
    assert want["valid?"] is False and resumed["op"] == want["op"]
    # A definite verdict deletes the checkpoint.
    assert not os.path.exists(ck)


def _valid(lib, seed=11):
    prep, m, s = lib
    return prep.prepare(m.cas_register(), s.generate_register_history(
        400, concurrency=5, seed=seed, value_range=5))


def test_chunk_kind_resume_on_valid_history(tmp_path):
    p = _valid(PORT)
    full = tbfs.check_packed(p, chunk=64, device="cpu")
    assert full["valid?"] is True
    ck = str(tmp_path / "chunk.ckpt.npz")
    ckpt = supervise.Checkpointer(ck, supervise.history_fingerprint(p),
                                  every_s=0)
    cancel = threading.Event()
    saves = []

    def on_save(kind, row):
        saves.append((kind, row))
        if len(saves) == 2:
            cancel.set()

    ckpt.on_save = on_save
    killed = tbfs.check_packed(p, chunk=64, cancel=cancel, checkpoint=ckpt,
                               device="cpu")
    assert killed["valid?"] == "unknown" and os.path.exists(ck)
    assert saves == [("chunk", 64), ("chunk", 128)]
    resumed = tbfs.check_packed(p, chunk=64, checkpoint=ck, device="cpu")
    assert resumed["valid?"] is True
    assert resumed["resumed-from-row"] == 128
    assert resumed["final-frontier-size"] == full["final-frontier-size"]
    assert not os.path.exists(ck)
    # resume=False starts fresh beside a checkpoint (and, deciding,
    # deletes it).
    _killed(lambda p, **k: tbfs.check_packed(p, chunk=64, device="cpu", **k),
            p, ck, supervise.history_fingerprint(p), "chunk")
    assert os.path.exists(ck)
    fresh = tbfs.check_packed(p, chunk=64, checkpoint=ck, resume=False,
                              device="cpu")
    assert "resumed-from-row" not in fresh and not os.path.exists(ck)


def test_env_checkpoint_through_the_entry_point(witness, tmp_path,
                                                monkeypatch):
    # JEPSEN_TPU_CKPT names the checkpoint when the caller passes none: a
    # killed run's checkpoint resumes through lin.device_check_packed and
    # lin.analysis, which forward checkpoint= and resume=.
    ck = str(tmp_path / "env.ckpt.npz")
    fp = supervise.history_fingerprint(witness)
    check = lambda p, **k: tbfs.check_packed(p, **KW, device="cpu", **k)  # noqa: E731
    _, saves = _killed(check, witness, ck, fp, "host")
    monkeypatch.setenv("JEPSEN_TPU_CKPT", ck)
    r = tlin.device_check_packed(witness, device="cpu", **KW)
    assert r["valid?"] is False and r["resumed-from-row"] == saves[-1][1]
    assert not os.path.exists(ck)
    monkeypatch.delenv("JEPSEN_TPU_CKPT")
    _, saves = _killed(check, witness, ck, fp, "host")
    h = tsynth.corrupt_history(tsynth.generate_partitioned_register_history(
        140, concurrency=40, seed=0, partition_every=60, partition_len=20,
        max_crashes=10), seed=3)
    kw = dict(KW, checkpoint=ck)
    del kw["explain"]
    r = tlin.analysis(tm.cas_register(), h, algorithm="gpu", device="cpu",
                      **kw)
    assert r["valid?"] is False and r["resumed-from-row"] == saves[-1][1]
    assert not os.path.exists(ck)


def test_mismatched_history_rejects_checkpoint(tmp_path):
    p1 = _valid(PORT, seed=1)
    p2 = _valid(PORT, seed=2)
    ck = str(tmp_path / "mismatch.ckpt.npz")
    ckpt = supervise.Checkpointer(ck, supervise.history_fingerprint(p1),
                                  every_s=0)
    cancel = threading.Event()
    ckpt.on_save = lambda kind, row: cancel.set()
    tbfs.check_packed(p1, chunk=64, cancel=cancel, checkpoint=ckpt,
                      device="cpu")
    assert os.path.exists(ck)
    r = tbfs.check_packed(p2, chunk=64, checkpoint=ck, device="cpu")
    assert r["valid?"] is True and "resumed-from-row" not in r


# --- across the packages ----------------------------------------------------


def test_a_jax_host_checkpoint_resumes_in_the_port(witness, tmp_path,
                                                   monkeypatch):
    # The reference in its per-row host-row mode, so its first host save
    # follows one host row as the port's does.
    monkeypatch.setenv("JEPSEN_TPU_HOST_SCHED", "0")
    monkeypatch.setenv("JEPSEN_TPU_HOST_ROWS_K", "1")
    pj = _witness(JAX)
    fp = jsup.history_fingerprint(pj)
    assert fp == supervise.history_fingerprint(witness)
    ck = str(tmp_path / "jax.ckpt.npz")
    killed, saves = _killed(lambda p, **k: jbfs.check_packed(p, **KW, **k),
                            pj, ck, fp, "host", mod=jsup)
    assert killed["valid?"] == "unknown" and saves[-1][0] == "host"
    full = tbfs.check_packed(witness, **KW, device="cpu")
    resumed = tbfs.check_packed(witness, checkpoint=ck, **KW, device="cpu")
    assert resumed["resumed-from-row"] == saves[-1][1]
    for k in ("valid?", "op", "dead-row"):
        assert resumed[k] == full[k]
    assert _paths_key(resumed) == _paths_key(full)
    # The reference's host stats carry on in the port's.
    assert resumed["host-stats"]["rows"] > 1
    assert not os.path.exists(ck)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chunk_checkpoints_cross_the_packages(tmp_path, writer):
    pj, pt = _valid(JAX), _valid(PORT)
    fp = supervise.history_fingerprint(pt)
    assert fp == jsup.history_fingerprint(pj)
    ck = str(tmp_path / f"{writer}.ckpt.npz")
    if writer == "jax":
        killed, saves = _killed(
            lambda p, **k: jbfs.check_packed(p, chunk=64, explain=True, **k),
            pj, ck, fp, "chunk", mod=jsup)
        resumed = tbfs.check_packed(pt, chunk=64, checkpoint=ck,
                                    device="cpu")
        full = tbfs.check_packed(pt, chunk=64, device="cpu")
    else:
        killed, saves = _killed(
            lambda p, **k: tbfs.check_packed(p, chunk=64, device="cpu", **k),
            pt, ck, fp, "chunk")
        resumed = jbfs.check_packed(pj, chunk=64, checkpoint=ck)
        full = jbfs.check_packed(pj, chunk=64)
    assert killed["valid?"] == "unknown" and saves == [("chunk", 64)]
    assert resumed["resumed-from-row"] == 64
    assert resumed["valid?"] is full["valid?"] is True
    assert resumed["final-frontier-size"] == full["final-frontier-size"]
    assert not os.path.exists(ck)


# --- the incremental entry --------------------------------------------------


def _prefix(p, k: int, window: int | None = None):
    """The first ``k`` rows of a packed history as a history of its own
    (a row-boundary split), at ``window`` slots when given (the rows must
    use no slot past it)."""
    W = p.window if window is None else window
    assert not np.asarray(p.active)[:k, W:].any()
    return dataclasses.replace(
        p, R=k, window=W, ret_slot=p.ret_slot[:k], ret_op=p.ret_op[:k],
        active=p.active[:k, :W], slot_f=p.slot_f[:k, :W],
        slot_v=p.slot_v[:k, :W], slot_op=p.slot_op[:k, :W],
        crashed=p.crashed[:k, :W])


def _rows(sf):
    n = sf["count"]
    return sorted(zip(map(tuple, np.asarray(sf["bits"])[:n].tolist()),
                      map(tuple, np.asarray(sf["state"])[:n].tolist())))


def _split_run(check, p, k, window=None, **kw):
    head = check(_prefix(p, k, window), partial=True, **kw)
    sf = head["stream-frontier"]
    tail = check(p, frontier=(sf["bits"], sf["state"], sf["count"]),
                 frontier_row=sf["row"], partial=True, **kw)
    return head, tail


BANDS = {
    # A register history on single u32 keys (compact band).
    "compact": lambda lib: lib[0].prepare(
        lib[1].cas_register(), lib[2].generate_register_history(
            300, concurrency=6, seed=5, value_range=5)),
    # Crashed mutators: the crash-dom band (with host rows at cap 12).
    "crash-dom": lambda lib: lib[0].prepare(
        lib[1].cas_register(), lib[2].generate_register_history(
            60, concurrency=6, seed=1, crash_prob=0.25)),
    # A set past one word: the multiword band.
    "multiword": lambda lib: lib[0].prepare(
        lib[1].set_model(), lib[2].generate_set_history(
            120, concurrency=3, seed=0)),
}
BAND_KW = {"compact": {}, "crash-dom": dict(cap_schedule=(12,),
                                            host_caps=(8, 64, 512)),
           "multiword": {}}


@pytest.mark.parametrize("band", list(BANDS))
def test_split_histories_match_the_jax_package(band, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_HOST_SCHED", "0")
    monkeypatch.setenv("JEPSEN_TPU_HOST_ROWS_K", "1")
    pj, pt = BANDS[band](JAX), BANDS[band](PORT)
    assert tbfs.key_band(pt) == {"compact": "compact",
                                 "crash-dom": "compact",
                                 "multiword": "multiword"}[band]
    assert (band == "crash-dom") == bool(np.asarray(pt.crashed).any())
    kw = BAND_KW[band]
    k = pt.R // 2
    th, tt = _split_run(lambda p, **a: tlin.device_check_packed(
        p, device="cpu", **kw, **a), pt, k)
    jh, jt = _split_run(lambda p, **a: jbfs.check_packed(p, **kw, **a),
                        pj, k)
    for t, j, row in ((th, jh, k), (tt, jt, pt.R)):
        assert t["valid?"] is j["valid?"] is True
        ts, js = t["stream-frontier"], j["stream-frontier"]
        assert ts["row"] == js["row"] == row
        assert ts["count"] == js["count"] == t["final-frontier-size"]
        assert np.asarray(ts["bits"]).dtype == np.uint32
        assert np.asarray(ts["state"]).dtype == np.int32
        assert _rows(ts) == _rows(js)
    # Two increments end in the one-shot verdict and frontier.
    one = tbfs.check_packed(pt, device="cpu", **kw)
    assert one["valid?"] is True
    assert one["final-frontier-size"] == tt["final-frontier-size"]
    last = tlin.device_check_packed(
        pt, device="cpu", frontier=(th["stream-frontier"]["bits"],
                                    th["stream-frontier"]["state"],
                                    th["stream-frontier"]["count"]),
        frontier_row=k, **kw)
    assert "stream-frontier" not in last
    assert last["valid?"] is True and \
        last["final-frontier-size"] == one["final-frontier-size"]


def test_a_split_counterexample_ends_in_the_one_shot_verdict(witness):
    k = 40
    head = tbfs.check_packed(_prefix(witness, k), partial=True, **KW,
                             device="cpu")
    sf = head["stream-frontier"]
    r = tbfs.check_packed(witness, frontier=(sf["bits"], sf["state"],
                                             sf["count"]),
                          frontier_row=k, **KW, device="cpu")
    one = tbfs.check_packed(witness, **KW, device="cpu")
    for key in ("valid?", "dead-row", "op"):
        assert r[key] == one[key]
    assert "stream-frontier" not in r and r["valid?"] is False


def test_a_window_crossing_a_word_boundary_pads():
    # The clean window-34 history's first rows use fewer than 32 slots:
    # its head runs at window 31 (one bitset word), the tail at 34 (two),
    # from the head's one-word frontier, padded. The tail ends on the
    # one-shot run's frontier, config for config.
    pt = tprep.prepare(tm.cas_register(),
                       tsynth.generate_partitioned_register_history(
                           140, concurrency=40, seed=0, partition_every=60,
                           partition_len=20, max_crashes=10))
    used = np.maximum.accumulate([np.flatnonzero(r).max(initial=-1)
                                  for r in np.asarray(pt.active)])
    k = int(np.flatnonzero(used >= 31)[0])
    assert pt.window > 32 and k > 4
    kw = dict(cap_schedule=(512,), host_caps=(64, 4096))
    th, tt = _split_run(lambda p, **a: tbfs.check_packed(
        p, device="cpu", **kw, **a), pt, k, window=31)
    assert np.asarray(th["stream-frontier"]["bits"]).shape[1] == 1
    assert np.asarray(tt["stream-frontier"]["bits"]).shape[1] == 2
    assert th["valid?"] is tt["valid?"] is True
    one = tbfs.check_packed(pt, device="cpu", partial=True, **kw)
    assert _rows(one["stream-frontier"]) == _rows(tt["stream-frontier"])


def test_carried_frontier_errors_are_the_jax_packages():
    pj, pt = _valid(JAX), _valid(PORT)
    cases = [
        # A state width the kernel does not have.
        (np.zeros((1, 1), np.uint32), np.zeros((1, 2), np.int32), 1),
        # An empty carry.
        (np.zeros((0, 1), np.uint32), np.zeros((0, 1), np.int32), 0),
    ]
    for fr in cases:
        want = jbfs.check_packed(pj, frontier=fr, frontier_row=3)
        got = tlin.device_check_packed(pt, frontier=fr, frontier_row=3,
                                       device="cpu")
        assert got["valid?"] == want["valid?"] == "unknown"
        assert got["error"] == want["error"]
    # Past the top chunk cap: an honest capacity overflow outside the
    # crash-dom bands.
    n = 40
    bits = np.arange(n, dtype=np.uint32)[:, None] << 1
    st = np.zeros((n, 1), np.int32)
    want = jbfs.check_packed(pj, cap_schedule=(16,), frontier=(bits, st, n),
                             frontier_row=0)
    got = tbfs.check_packed(pt, cap_schedule=(16,), frontier=(bits, st, n),
                            frontier_row=0, device="cpu")
    assert got["overflow"] == want["overflow"] == "capacity"
    assert got["error"] == want["error"]


def test_a_carry_past_the_chunk_cap_enters_the_host_rows(monkeypatch):
    # The crash-dom band takes a carried frontier bigger than its chunk cap
    # into the host-row executor, as a host-kind resume does.
    monkeypatch.setenv("JEPSEN_TPU_HOST_SCHED", "0")
    monkeypatch.setenv("JEPSEN_TPU_HOST_ROWS_K", "1")
    pj, pt = BANDS["crash-dom"](JAX), BANDS["crash-dom"](PORT)
    kw = BAND_KW["crash-dom"]
    k = 35
    head = tbfs.check_packed(_prefix(pt, k), partial=True, device="cpu",
                             cap_schedule=(4096,))
    sf = head["stream-frontier"]
    assert sf["count"] > kw["cap_schedule"][0]
    fr = (sf["bits"], sf["state"], sf["count"])
    got = tbfs.check_packed(pt, frontier=fr, frontier_row=k, partial=True,
                            device="cpu", **kw)
    want = jbfs.check_packed(pj, frontier=fr, frontier_row=k, partial=True,
                             **kw)
    assert got["valid?"] is want["valid?"] is True
    assert got["host-stats"]["episodes"] >= 1
    assert _rows(got["stream-frontier"]) == _rows(want["stream-frontier"])


def test_an_empty_history_carries_the_initial_frontier():
    pj, pt = (_prefix(p, 0) for p in (_valid(JAX), _valid(PORT)))
    got = tbfs.check_packed(pt, partial=True, device="cpu")
    want = jbfs.check_packed(pj, partial=True)
    assert got["valid?"] is True and got["stream-frontier"]["row"] == 0
    assert _rows(got["stream-frontier"]) == _rows(want["stream-frontier"])


def test_a_carried_frontier_reads_no_checkpoint(tmp_path, monkeypatch):
    # With a carried frontier the caller owns the carry: a checkpoint file
    # beside it is not read, so its row, stats and cap are not inherited.
    monkeypatch.setenv("JEPSEN_TPU_HOST_SCHED", "0")
    pt = BANDS["crash-dom"](PORT)
    kw = BAND_KW["crash-dom"]
    k = 35
    head = tbfs.check_packed(_prefix(pt, k), partial=True, device="cpu",
                             cap_schedule=(4096,))
    sf = head["stream-frontier"]
    fr = (sf["bits"], sf["state"], sf["count"])
    clean = tbfs.check_packed(pt, frontier=fr, frontier_row=k, partial=True,
                              device="cpu", **kw)
    eng = tbfs._Engine(pt, torch.device("cpu"))
    lo, hi = supervise.np_pack_keys(
        sf["bits"], sf["state"], eng.b, eng.nil_id, eng.pair, int(NIL),
        sf["count"])
    path = str(tmp_path / "c.npz")
    arrays = {"lo": lo} if hi is None else {"lo": lo, "hi": hi}
    supervise.Checkpointer(path, supervise.history_fingerprint(pt)).save(
        "host", k + 1, sf["count"], arrays,
        {"key_hi": eng.pair, "b": eng.b, "nil_id": eng.nil_id, "nw": eng.nw,
         "sticky_lvl": 0, "host_stats": {"cpu_rows": 7, "rows": 99}})
    got = tbfs.check_packed(pt, frontier=fr, frontier_row=k, partial=True,
                            checkpoint=path, device="cpu", **kw)
    assert "resumed-from-row" not in got
    assert got["host-stats"] == clean["host-stats"]
    assert _rows(got["stream-frontier"]) == _rows(clean["stream-frontier"])
