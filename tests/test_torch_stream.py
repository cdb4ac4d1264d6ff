"""The port's streaming checker (``jepsen_tpu_torch.stream``) on the CPU
(``device="cpu"``) against the JAX package's ``jepsen_tpu.stream`` on the
same seeded events, on the shapes of ``tests/test_stream.py`` and
``tests/test_pack_dev.py``'s stream cases:

- the packer: final tables, reduction tables and prefix fingerprints bit
  for bit the JAX packer's and the port's one-shot ``prepare``, in both
  settle walks; settled rows final; the unpackable-event downgrade;
- the settle paint: ``pack_dev.paint_tables_dev`` against the JAX one and
  a numpy reference; settles painted on the device against numpy's; a
  failed paint takes numpy on the CPU and raises under the card's rule;
- the session: verdict, dead row, op, final paths, increments, checked
  rows and resume rows the JAX ``StreamChecker``'s, the abort, the
  degrade to a post-hoc check, a checkpoint either package writes;
- the live checker: the abort latch, its knob, and a failure inside the
  checker thread raised by ``finish()``."""

import os

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.lin import pack_dev as jpd
from jepsen_tpu.lin import supervise as jsup
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu.stream import IncrementalPacker as JPacker
from jepsen_tpu.stream import StreamChecker as JStream
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.history import Op as TOp
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import cpu as tcpu
from jepsen_tpu_torch.lin import pack_dev as tpd
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import supervise
from jepsen_tpu_torch.lin import synth as tsynth
from jepsen_tpu_torch.stream import (IncrementalPacker, LiveChecker,
                                     StreamChecker, runner)

# The JAX side's programs are test_stream.py's (the shared .jax_cache).
pytestmark = [pytest.mark.quick, pytest.mark.compiles]

KW = dict(cap_schedule=(8,), host_caps=(64, 4096), explain=True)
TABLES = ("ret_slot", "ret_op", "active", "slot_f", "slot_v", "slot_op",
          "crashed")
# (JAX, port) modules for the history generators.
JAX, PORT = (jm, jsynth), (tm, tsynth)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    for k in ("JEPSEN_TPU_FAST_PACK", "JEPSEN_TPU_WEDGE", "JEPSEN_TPU_FAULT",
              "JEPSEN_TPU_CKPT", "JEPSEN_TPU_STREAM_ROWS",
              "JEPSEN_TPU_STREAM_CKPT", "JEPSEN_TPU_STREAM_ABORT",
              "JEPSEN_TPU_PACK_DEV_STREAM_ROWS"):
        monkeypatch.delenv(k, raising=False)
    # The JAX packer paints with numpy unless a case turns its device
    # paint on (the test settings' default).
    monkeypatch.setenv("JEPSEN_TPU_PACK_DEV", "0")
    for mod in (supervise, jsup):
        mod.reset_injections()
    tpd.reset_dev_stats()
    jpd.reset_dev_stats()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    assert supervise.join_abandoned(30.0)
    torch.set_num_threads(n)
    for mod in (supervise, jsup):
        mod.reset_injections()


def _witness(P):
    h = P[1].generate_partitioned_register_history(
        140, concurrency=40, seed=0, partition_every=60, partition_len=20,
        max_crashes=10)
    return list(P[1].corrupt_history(h, seed=3))


def _valid(P):
    return list(P[1].generate_register_history(400, concurrency=5, seed=11,
                                               value_range=5))


def _corrupt(P):
    return list(P[1].corrupt_history(_valid(P), seed=3))


# test_stream.py's TestPacker.SHAPES: (model, history) over (models, synth).
SHAPES = {
    "cas-crashes": lambda P: (P[0].cas_register(), list(
        P[1].generate_register_history(300, concurrency=8, seed=2,
                                       crash_prob=0.05, max_crashes=6))),
    "read-write": lambda P: (P[0].cas_register(), list(
        P[1].generate_register_history(200, concurrency=4, seed=5,
                                       fs=("read", "write")))),
    "mutex": lambda P: (P[0].mutex(), list(
        P[1].generate_mutex_history(200, concurrency=6, seed=3,
                                    crash_prob=0.03))),
}


def _feed(pk, events, step, sample):
    """Feed and settle ``step`` events at a time; returns the prefix
    fingerprints at each settle's R and at ``sample(R)``."""
    fps = []
    for i in range(0, len(events), step):
        pk.feed_many(events[i:i + step])
        pk.settle()
        fps.append((pk.R, pk.prefix_fingerprint(pk.R),
                    pk.prefix_fingerprint(sample(pk.R))))
    pk.settle(final=True)
    fps.append((pk.R, pk.prefix_fingerprint(pk.R),
                pk.prefix_fingerprint(sample(pk.R))))
    return fps


def _assert_packed_equal(a, b):
    assert a.window == b.window and a.R == b.R
    for k in TABLES:
        va, vb = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert va.dtype == vb.dtype, k
        np.testing.assert_array_equal(va, vb, err_msg=k)
    np.testing.assert_array_equal(a.init_state, b.init_state)
    assert a.unintern == b.unintern


def _paths_key(result):
    return sorted(repr(sorted(od["index"] for od in fp["path"]))
                  for fp in result["final-paths"])


# --- the packer ---------------------------------------------------------------


@pytest.mark.parametrize("walk", ["vec", "spec"])
@pytest.mark.parametrize("step", [13, 37, 120])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_packer_is_the_jax_packers_and_the_one_shot_pack(shape, step, walk,
                                                         monkeypatch):
    if walk == "spec":
        monkeypatch.setenv("JEPSEN_TPU_FAST_PACK", "0")
    jmodel, jev = SHAPES[shape](JAX)
    tmodel, tev = SHAPES[shape](PORT)
    ja, tp = JPacker(jmodel), IncrementalPacker(tmodel, device="cpu")
    sample = lambda r: r // 2 + 1 if r else 0  # noqa: E731
    assert _feed(tp, tev, step, sample) == _feed(ja, jev, step, sample)
    got, want = tp.packed(), ja.packed()
    _assert_packed_equal(got, want)
    _assert_packed_equal(got, tprep.prepare(tmodel, tev))
    for x, y in zip(got._reduction_tables, want._reduction_tables):
        np.testing.assert_array_equal(x, y)
    one = tprep.reduction_tables(tprep.prepare(tmodel, tev))
    for x, y in zip(got._reduction_tables, one):
        np.testing.assert_array_equal(x, y)
    assert (tp.max_used, tp._free, tp._slot_of, tp._cur_active) == \
        (ja.max_used, ja._free, ja._slot_of, ja._cur_active)
    assert tprep.pack_stats()["incr_calls"] >= 1


def test_witness_tables_and_fingerprints_match():
    jev, tev = _witness(JAX), _witness(PORT)
    ja = JPacker(jm.cas_register())
    tp = IncrementalPacker(tm.cas_register(), device="cpu",
                           paint_min_rows=1)
    rows = [0, 7, 40]
    assert _feed(tp, tev, 50, lambda r: min(r, 40)) == \
        _feed(ja, jev, 50, lambda r: min(r, 40))
    assert [tp.prefix_fingerprint(r) for r in rows] == \
        [ja.prefix_fingerprint(r) for r in rows]
    _assert_packed_equal(tp.packed(), ja.packed())
    assert tp.paint_stats["dev_paints"] > 0


def test_settled_rows_are_final():
    # Mid-stream reduction rows are a prefix of the final tables: a settled
    # row is never revised by later events.
    _, h = SHAPES["cas-crashes"](PORT)
    one = tprep.prepare(tm.cas_register(), list(h))
    r1 = tprep.reduction_tables(one)
    pk = IncrementalPacker(tm.cas_register(), device="cpu")
    seen = 0
    for i in range(0, len(h), 37):
        pk.feed_many(h[i:i + 37])
        pk.settle()
        if pk.R:
            seen += 1
            r2 = pk.reduction_tables()
            w2 = r2[0].shape[1]
            assert (r1[0][:pk.R, :w2] == r2[0][:pk.R]).all()
            assert (r1[1][:pk.R, :w2] == r2[1][:pk.R]).all()
            assert not r1[0][:pk.R, w2:].any()
            assert (r1[1][:pk.R, w2:] == -1).all()
            p = pk.packed()
            for k in TABLES:
                np.testing.assert_array_equal(
                    getattr(p, k), getattr(one, k)[:pk.R, :p.window]
                    if getattr(one, k).ndim > 1 else getattr(one, k)[:pk.R])
    assert seen >= 5


def test_unpackable_event_downgrades_as_the_jax_package():
    def events(Op):
        return [Op("invoke", "write", 1, 0), Op("invoke", "write", 2, 0),
                Op("ok", "write", 2, 0)]

    ja, tp = JPacker(jm.cas_register()), \
        IncrementalPacker(tm.cas_register(), device="cpu")
    ja.feed_many(events(JOp))
    tp.feed_many(events(TOp))
    assert (tp.incremental, tp.broken) == (ja.incremental, ja.broken)
    assert "invoked twice" in tp.broken and len(tp.history) == 3
    sc = StreamChecker(tm.cas_register(), min_rows=1, device="cpu")
    sc.append(events(TOp))
    assert len(sc.packer.history) == 3
    r = sc.finalize()
    js = JStream(jm.cas_register(), min_rows=1)
    js.append(events(JOp))
    want = js.finalize()
    assert r["valid?"] == want["valid?"] == "unknown"
    assert r["stream-fallback"] == want["stream-fallback"]
    assert r["stream"]["mode"] == want["stream"]["mode"] == "buffer"


def test_history_sized_kernels_run_in_buffer_mode():
    jh = list(jsynth.generate_set_history(40, concurrency=3, seed=4))
    th = list(tsynth.generate_set_history(40, concurrency=3, seed=4))
    sc = StreamChecker(tm.set_model(), min_rows=4, device="cpu")
    js = JStream(jm.set_model(), min_rows=4)
    assert not sc.packer.incremental
    for i in range(0, len(th), 20):
        sc.append(th[i:i + 20])
        js.append(jh[i:i + 20])
    r, want = sc.finalize(), js.finalize()
    assert r["valid?"] == want["valid?"]
    assert r["stream-fallback"] == want["stream-fallback"] == "buffer mode"
    assert r["stream"]["mode"] == "buffer"


# --- the settle paint ---------------------------------------------------------


def _painters(seed):
    rng = np.random.default_rng(seed)
    n1, n_new, W = 40, 12, 6
    # Non-overlapping intervals a column, as a settle builds them.
    p_gid, p_slot, r0, r1 = [], [], [], []
    for col in range(W):
        row = 0
        while row < n_new:
            span = int(rng.integers(1, 4))
            p_gid.append(int(rng.integers(0, n1)))
            p_slot.append(col)
            r0.append(row)
            r1.append(min(n_new, row + span))
            row += span + int(rng.integers(0, 3))
    op_f = rng.integers(0, 3, n1).astype(np.int32)
    op_v = rng.integers(-5, 5, (n1, 2)).astype(np.int32)
    op_crashed = rng.random(n1) < 0.3
    return (np.asarray(p_slot, np.int32), np.asarray(r0, np.int32),
            np.asarray(r1, np.int32), np.asarray(p_gid, np.int32) + 1,
            op_f, op_v, op_crashed, n1, n_new, W)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paint_tables_dev_is_the_jax_packages(seed, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PACK_DEV", "1")
    args = _painters(seed)
    p_slot, r0, r1, ids1, op_f, op_v, op_crashed, n1, n_new, W = args
    got = tpd.paint_tables_dev(*args, kernel="test", device="cpu")
    want = jpd.paint_tables_dev(*args, kernel="test")
    assert got is not None and want is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    grid = np.zeros((n_new, W), np.int32)
    for g, c, a, b in zip(ids1, p_slot, r0, r1):
        grid[a:b, c] = g
    active = grid != 0
    slot_op = grid - 1
    sop = np.clip(slot_op, 0, None)
    np.testing.assert_array_equal(got[0], grid)
    np.testing.assert_array_equal(got[1], active)
    np.testing.assert_array_equal(got[2], np.where(active, op_f[sop], 0))
    np.testing.assert_array_equal(
        got[3], np.where(active[..., None], op_v[sop], tprep.NIL))
    np.testing.assert_array_equal(got[4], slot_op)
    np.testing.assert_array_equal(got[5], active & op_crashed[sop])
    assert tpd.dev_stats()["dev_packs"] == 1


def _stream_pack(model, events, step, paint_min_rows):
    pk = IncrementalPacker(model, device="cpu",
                           paint_min_rows=paint_min_rows)
    return pk, _feed(pk, list(events), step, lambda r: r)


PAINT_CASES = {
    "cas-0-37": (lambda P: P[0].cas_register(), 37, lambda P:
                 P[1].generate_register_history(
                     500, concurrency=6, seed=0, crash_prob=0.03,
                     max_crashes=5)),
    "cas-1-120": (lambda P: P[0].cas_register(), 120, lambda P:
                  P[1].generate_register_history(
                      500, concurrency=6, seed=1, crash_prob=0.03,
                      max_crashes=5)),
    "mutex": (lambda P: P[0].mutex(), 60, lambda P:
              P[1].generate_mutex_history(
                  300, concurrency=5, seed=2, crash_prob=0.03,
                  max_crashes=4)),
}


@pytest.mark.parametrize("case", list(PAINT_CASES))
def test_device_paint_settles_equal_numpy_settles(case):
    mk, step, hist = PAINT_CASES[case]
    h = list(hist(PORT))
    a, fa = _stream_pack(mk(PORT), h, step, 1)
    assert a.paint_stats["dev_paints"] > 0 == a.paint_stats["host_paints"]
    assert tpd.dev_stats()["dev_packs"] == a.paint_stats["dev_paints"]
    tpd.reset_dev_stats()
    # paint_min_rows above every settle: numpy paints each one.
    b, fb = _stream_pack(mk(PORT), h, step, 1 << 30)
    assert tpd.dev_stats()["dev_packs"] == 0 == b.paint_stats["dev_paints"]
    assert fa == fb
    _assert_packed_equal(a.packed(), b.packed())
    for x, y in zip(a.reduction_tables(), b.reduction_tables()):
        np.testing.assert_array_equal(x, y)
    assert (a.max_used, a._free, a._slot_of, a._cur_active) == \
        (b.max_used, b._free, b._slot_of, b._cur_active)
    # And the JAX packer with its device paint on every settle.
    os.environ["JEPSEN_TPU_PACK_DEV"] = "1"
    os.environ["JEPSEN_TPU_PACK_DEV_STREAM_ROWS"] = "1"
    try:
        ja = JPacker(mk(JAX))
        assert _feed(ja, list(hist(JAX)), step, lambda r: r) == fa
    finally:
        os.environ["JEPSEN_TPU_PACK_DEV"] = "0"
        del os.environ["JEPSEN_TPU_PACK_DEV_STREAM_ROWS"]
    assert jpd.dev_stats()["dev_packs"] > 0
    _assert_packed_equal(a.packed(), ja.packed())


def _inject_paint_failure(how, monkeypatch):
    if how == "quarantine":
        real = supervise.quarantined
        monkeypatch.setattr(
            supervise, "quarantined",
            lambda key, path=None: {"faulted": True} if "|paint-" in key
            else real(key, path))
    elif how == "fault":
        supervise.inject_fault("pack-dev", 99)
    else:
        monkeypatch.setenv("JEPSEN_TPU_DISPATCH_RETRIES", "0")
        supervise.inject_wedge("pack-dev", 99, deadline_s=0.05)


@pytest.mark.parametrize("how", ["quarantine", "fault", "wedge"])
def test_a_failed_paint_takes_numpy_on_the_cpu(how, monkeypatch):
    h = list(tsynth.generate_register_history(
        400, concurrency=6, seed=7, crash_prob=0.02, max_crashes=3))
    b, fb = _stream_pack(tm.cas_register(), h, 80, 1 << 30)
    tpd.reset_dev_stats()
    _inject_paint_failure(how, monkeypatch)
    a, fa = _stream_pack(tm.cas_register(), h, 80, 1)
    st = tpd.dev_stats()
    settles = a.paint_stats["host_paints"]
    assert st["dev_packs"] == 0 == a.paint_stats["dev_paints"]
    assert st["host_fallbacks"] == settles > 0
    # A fault (and a streak of wedges) records its shape, so that later
    # settles of that shape skip the device.
    assert st[{"quarantine": "quarantine_skips", "fault": "faults",
               "wedge": "wedges"}[how]] >= 1
    assert st["quarantine_skips"] + st["faults"] + st["wedges"] == settles
    assert fa == fb
    _assert_packed_equal(a.packed(), b.packed())


@pytest.mark.parametrize("how", ["quarantine", "fault", "wedge"])
def test_a_failed_paint_raises_under_the_cards_rule(how, monkeypatch):
    monkeypatch.setattr(supervise, "host_rungs", lambda device: False)
    _inject_paint_failure(how, monkeypatch)
    h = list(tsynth.generate_register_history(
        400, concurrency=6, seed=7, crash_prob=0.02, max_crashes=3))
    pk = IncrementalPacker(tm.cas_register(), device="cpu",
                           paint_min_rows=1)
    pk.feed_many(h[:200])
    with pytest.raises({"quarantine": supervise.Quarantined,
                        "fault": supervise.InjectedFault,
                        "wedge": supervise.WedgedDispatch}[how]):
        pk.settle()
    st = tpd.dev_stats()
    assert (st["host_fallbacks"], st["dev_packs"]) == (0, 0)
    assert pk.paint_stats["host_paints"] == 0


# --- the session --------------------------------------------------------------


def _stream_both(jev, tev, k=4, min_rows=4, check_kw=KW):
    out = []
    for S, ev, kw in ((JStream, jev, {}),
                      (StreamChecker, tev, {"device": "cpu"})):
        sc = S((jm if S is JStream else tm).cas_register(),
               min_rows=min_rows, check_kw=check_kw, **kw)
        n = max(1, len(ev) // k)
        for i in range(0, len(ev), n):
            sc.append(ev[i:i + n])
        out.append((sc, sc.finalize()))
    return out


@pytest.fixture(scope="module")
def witness_full():
    p = tprep.prepare(tm.cas_register(), _witness(PORT))
    r = tbfs.check_packed(p, device="cpu", **KW)
    assert r["valid?"] is False
    return r


def test_witness_session_is_the_jax_sessions(witness_full):
    (jsc, want), (tsc, got) = _stream_both(_witness(JAX), _witness(PORT),
                                           k=5)
    assert got["valid?"] is False is want["valid?"]
    for k in ("dead-row", "op"):
        assert got[k] == want[k] == witness_full[k], k
    assert _paths_key(got) == _paths_key(want) == _paths_key(witness_full)
    for k in ("increments", "rows_checked", "rows_settled", "aborted",
              "aborted_row", "mode"):
        assert got["stream"][k] == want["stream"][k], k
    assert got["stream"]["increments"] >= 3
    assert not got["stream"].get("degraded")


def test_valid_session_is_the_jax_sessions():
    (_, want), (_, got) = _stream_both(_valid(JAX), _valid(PORT), min_rows=8,
                                       check_kw=None)
    assert got["valid?"] is True is want["valid?"]
    assert got["final-frontier-size"] == want["final-frontier-size"]
    assert got["analyzer"] == "gpu-bfs-stream"
    for k in ("increments", "rows_checked", "rows_settled", "lag_rows",
              "frontier"):
        assert got["stream"][k] == want["stream"][k], k
    assert got["stream"]["increments"] >= 3
    assert not got["stream"].get("degraded")


def test_abort_within_one_increment_as_the_jax_session():
    n, res = 50, []
    for S, P, kw in ((JStream, JAX, {}), (StreamChecker, PORT,
                                          {"device": "cpu"})):
        bad, h = _corrupt(P), _valid(P)
        bad_at = next(i for i, (a, b) in enumerate(zip(h, bad))
                      if a.value != b.value or a.type != b.type)
        seen = []
        sc = S(P[0].cas_register(), min_rows=8, on_abort=seen.append, **kw)
        fed = None
        for i in range(0, len(bad), n):
            sc.append(bad[i:i + n])
            if sc.aborted:
                fed = i + n
                break
        assert fed is not None and fed - bad_at <= 2 * n
        assert fed < len(bad)
        r = sc.finalize()
        assert r["valid?"] is False and seen == [sc.verdict]
        res.append((fed, r["dead-row"], r["op"], r["stream"]["aborted_row"],
                    r["stream"]["increments"], r["stream"]["rows_checked"]))
    assert res[0] == res[1]


def test_info_only_completions_decide_vacuously_valid():
    def events(Op):
        return [Op("invoke", "write", 1, 0), Op("invoke", "write", 2, 1),
                Op("info", "write", 1, 0), Op("info", "write", 2, 1)]

    sc = StreamChecker(tm.cas_register(), min_rows=1, device="cpu")
    sc.append(events(TOp))
    r = sc.finalize()
    js = JStream(jm.cas_register(), min_rows=1)
    js.append(events(JOp))
    want = js.finalize()
    assert r["valid?"] is True is want["valid?"]
    assert r["stream"]["rows_settled"] == 0 == want["stream"]["rows_settled"]


def test_a_wedged_increment_degrades_to_the_exact_posthoc_check(
        witness_full):
    # Every attempt of the first increment (one retry by default) is a fake
    # wedge that never runs the real check.
    supervise.inject_wedge("stream-incr", 2, 0.1)
    jsup.inject_wedge("stream-incr", 2, 0.1)
    (_, want), (_, got) = _stream_both(_witness(JAX), _witness(PORT))
    assert got["stream"]["degraded"].startswith("increment wedge at row 0")
    assert got["stream-fallback"] == got["stream"]["degraded"]
    assert want["stream"]["degraded"].startswith("increment wedge at row 0")
    assert got["valid?"] is False is want["valid?"]
    assert got["op"] == want["op"] == witness_full["op"]
    # On the CPU the post-hoc check races the device search and the CPU
    # oracle, as the JAX package's does.
    assert got["analyzer"] in ("gpu-bfs", "cpu-jit")
    assert got["stream"]["watchdog_trips"] == 2 == \
        want["stream"]["watchdog_trips"]
    assert got["stream"]["increments"] == 0 == want["stream"]["increments"]


@pytest.mark.parametrize("posthoc", ["decides", "chunks_wedge"])
def test_on_the_card_the_posthoc_check_is_the_device_search(
        posthoc, witness_full, monkeypatch):
    # The card's routing: a degraded session's post-hoc check is the
    # device search alone, with no CPU oracle racing it.
    monkeypatch.setattr(supervise, "host_rungs", lambda device: False)
    ran_cpu = []
    monkeypatch.setattr(tcpu, "check_packed",
                        lambda *a, **k: ran_cpu.append(1) or {})
    supervise.inject_wedge("stream-incr", 2, 0.1)
    if posthoc == "chunks_wedge":
        # Every chunk of the post-hoc search wedges too: an honest unknown
        # that names the wedge, never the host's answer.
        supervise.inject_wedge("chunk", 1000, 0.1)
    sc = StreamChecker(tm.cas_register(), min_rows=4, check_kw=KW,
                       device="cpu")
    _feed_session(sc, _witness(PORT), k=4)
    got = sc.finalize()
    assert not ran_cpu
    assert got["stream-fallback"].startswith("increment wedge at row 0")
    assert got["stream"]["increments"] == 0
    if posthoc == "decides":
        assert got["analyzer"] == "gpu-bfs"
        assert got["valid?"] is False
        assert got["op"] == witness_full["op"]
    else:
        assert got["valid?"] == "unknown"
        assert got["overflow"] == "wedge"


def _feed_session(sc, events, k=6, stop_after=None):
    n = max(1, len(events) // k)
    for j, i in enumerate(range(0, len(events), n)):
        sc.append(events[i:i + n])
        if stop_after is not None and j + 1 >= stop_after:
            return


def test_a_killed_session_resumes_at_the_jax_sessions_row(witness_full,
                                                          tmp_path):
    rows = []
    for name, S, P, kw in (("jax", JStream, JAX, {}),
                           ("port", StreamChecker, PORT, {"device": "cpu"})):
        ck = str(tmp_path / f"{name}.npz")
        sc1 = S(P[0].cas_register(), min_rows=4, checkpoint=ck,
                check_kw=KW, **kw)
        _feed_session(sc1, _witness(P), stop_after=3)
        assert sc1._row > 0 and os.path.exists(ck)
        # The killed session is dropped (a kill -9 leaves this file: the
        # writes are atomic); a fresh one is fed the same events.
        sc2 = S(P[0].cas_register(), min_rows=4, checkpoint=ck,
                check_kw=KW, **kw)
        _feed_session(sc2, _witness(P))
        r = sc2.finalize()
        assert r["valid?"] is False
        assert r["stream"]["resumed_from_row"] == sc1._row
        assert not os.path.exists(ck), "a definite verdict clears it"
        rows.append((sc1._row, r["dead-row"], r["op"], _paths_key(r)))
    assert rows[0] == rows[1]
    assert rows[1][1:] == (witness_full["dead-row"], witness_full["op"],
                           _paths_key(witness_full))


def test_foreign_events_reject_the_checkpoint(tmp_path):
    ck = str(tmp_path / "foreign.npz")
    sc1 = StreamChecker(tm.cas_register(), min_rows=4, checkpoint=ck,
                        check_kw=KW, device="cpu")
    _feed_session(sc1, _witness(PORT), stop_after=3)
    assert os.path.exists(ck)
    other = list(tsynth.generate_register_history(200, concurrency=5, seed=1,
                                                  value_range=5))
    sc2 = StreamChecker(tm.cas_register(), min_rows=8, checkpoint=ck,
                        device="cpu")
    _feed_session(sc2, other, k=4)
    r = sc2.finalize()
    assert r["valid?"] is True
    assert "resumed_from_row" not in r["stream"]
    assert r["stream"]["rows_checked"] == r["stream"]["rows_settled"]


def test_a_jax_stream_checkpoint_resumes_in_the_port(witness_full,
                                                    tmp_path):
    ck = str(tmp_path / "jax.npz")
    js = JStream(jm.cas_register(), min_rows=4, checkpoint=ck, check_kw=KW)
    _feed_session(js, _witness(JAX), stop_after=3)
    assert js._row > 0 and os.path.exists(ck)
    sc = StreamChecker(tm.cas_register(), min_rows=4, checkpoint=ck,
                       check_kw=KW, device="cpu")
    _feed_session(sc, _witness(PORT))
    r = sc.finalize()
    assert r["stream"]["resumed_from_row"] == js._row
    assert (r["valid?"], r["dead-row"], r["op"]) == \
        (False, witness_full["dead-row"], witness_full["op"])


def test_the_session_knobs(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_STREAM_ROWS", "17")
    monkeypatch.setenv("JEPSEN_TPU_STREAM_CKPT", str(tmp_path / "s.npz"))
    sc = StreamChecker(tm.cas_register(), device="cpu")
    assert (sc.min_rows, sc.ckpt_path) == (17, str(tmp_path / "s.npz"))
    assert sc.packer.paint_min_rows == tpd.STREAM_MIN_ROWS
    monkeypatch.delenv("JEPSEN_TPU_STREAM_ROWS")
    assert StreamChecker(tm.cas_register(), device="cpu").min_rows == 256


# --- the live checker ---------------------------------------------------------


def test_the_live_checker_latches_the_abort():
    bad = _corrupt(PORT)
    lc = LiveChecker(tm.cas_register(), min_rows=8, device="cpu")
    fed = 0
    for op in bad:
        lc.offer(op)
        fed += 1
        if fed % 50 == 0:
            # Give the checker thread the queue, as a run's pacing does.
            while lc._q:
                lc._thread.join(0.01)
            if lc.should_abort():
                break
    deadline = 200
    while not lc.should_abort() and deadline:
        lc._thread.join(0.05)
        deadline -= 1
    assert lc.should_abort()
    assert fed < len(bad)
    r = lc.finish()
    assert r["valid?"] is False and r["stream"]["aborted"] is True
    js = JStream(jm.cas_register(), min_rows=8)
    js.append(_corrupt(JAX))
    want = js.finalize()
    assert (r["dead-row"], r["op"]) == (want["dead-row"], want["op"])


def test_the_abort_knob_keeps_the_run_going(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_STREAM_ABORT", "0")
    lc = LiveChecker(tm.cas_register(), min_rows=8, device="cpu")
    for op in _corrupt(PORT):
        lc.offer(op)
    r = lc.finish()
    assert r["valid?"] is False and lc.session.aborted
    assert not lc.should_abort()
    assert runner.abort_enabled() is False


def test_a_failure_in_the_checker_thread_is_raised_by_finish(monkeypatch):
    lc = LiveChecker(tm.cas_register(), min_rows=8, device="cpu")
    calls = []
    real = lc.session.append

    def append(events):
        calls.append(len(events))
        if len(calls) == 1:
            raise ValueError("boom in the checker")
        return real(events)

    monkeypatch.setattr(lc.session, "append", append)
    h = _valid(PORT)
    lc.offer(h[0])
    while not calls:
        lc._thread.join(0.01)
    for op in h[1:]:
        lc.offer(op)
    with pytest.raises(ValueError, match="boom in the checker"):
        lc.finish()
    # The thread went on consuming, and the summary names the failure.
    assert len(calls) >= 2 and not lc._thread.is_alive()
    assert lc.session.stats["checker_error"] == \
        "ValueError('boom in the checker')"


# --- the band an increment reports --------------------------------------------


BANDS = {
    "compact": lambda: (tm.cas_register(), tsynth.generate_register_history(
        60, concurrency=3, seed=11), None),
    "crash-dom": lambda: (tm.cas_register(), tsynth.generate_register_history(
        80, concurrency=4, seed=2, crash_prob=0.05, max_crashes=3), None),
    "pair-crash-dom": lambda: (tm.cas_register(), list(
        tsynth.generate_partitioned_register_history(
            140, concurrency=40, seed=0, partition_every=60,
            partition_len=20, max_crashes=10)), None),
    "generic": lambda: (tm.mutex(), tsynth.generate_mutex_history(
        200, concurrency=6, seed=3), None),
    "multiword": lambda: (tm.cas_register(), tsynth.generate_register_history(
        60, concurrency=3, seed=11), False),
}


@pytest.mark.parametrize("band", sorted(BANDS))
def test_an_increment_reports_the_band_its_engine_ran(band):
    # The band a phase files an increment's launches under is the one the
    # engine reports, not a second copy of the routing.
    model, h, packed_keys = BANDS[band]()
    p = tprep.prepare(model, list(h))
    r = tbfs.check_packed(p, device="cpu", partial=True,
                          packed_keys=packed_keys, **KW)
    assert r["valid?"] is True and "stream-frontier" in r
    assert r["band"] == band
    # key_band names the engine; the engine adds crashed ops and pair keys.
    assert tbfs.key_band(p, packed_keys) == {
        "crash-dom": "compact", "pair-crash-dom": "compact"}.get(band, band)


# --- the device default -------------------------------------------------------


def test_without_a_device_the_stream_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: StreamChecker(tm.cas_register()),
                 lambda: IncrementalPacker(tm.cas_register()),
                 lambda: LiveChecker(tm.cas_register()),
                 lambda: tpd.paint_tables_dev(*_painters(0), kernel="t")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
