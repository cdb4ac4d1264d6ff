"""The port's linearizability slice end to end on the CPU: its
``checker.linearizable(algorithm="gpu", device="cpu")`` against the JAX
package's ``algorithm="tpu"`` and its CPU oracle, on seeded histories."""

import threading

import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jh
from jepsen_tpu import lin as jlin
from jepsen_tpu import models as jm
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import cpu as jcpu
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import lin as tlin
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import resolve_device
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import cpu as tcpu
from jepsen_tpu_torch.lin import dense as tdense
from jepsen_tpu_torch.lin import dense_cuda
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import synth as tsynth


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many tiny torch ops; on a loaded machine the
    barrier waits of torch's CPU thread pool dominate them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _register(kw, corrupt=False):
    hj = jsynth.generate_register_history(**kw)
    ht = tsynth.generate_register_history(**kw)
    if corrupt:
        hj = jsynth.corrupt_history(hj, seed=kw["seed"])
        ht = tsynth.corrupt_history(ht, seed=kw["seed"])
    return hj, ht, jm.cas_register(), tm.cas_register()


def _mutex(kw):
    return (jsynth.generate_mutex_history(**kw),
            tsynth.generate_mutex_history(**kw), jm.mutex(), tm.mutex())


def _double_acquire(H):
    return H.History.of(
        H.invoke_op(0, "acquire", None), H.ok_op(0, "acquire", None),
        H.invoke_op(1, "acquire", None), H.invoke_op(2, "release", None),
        H.ok_op(2, "release", None), H.ok_op(1, "acquire", None),
        H.invoke_op(2, "acquire", None), H.ok_op(2, "acquire", None))


CASES = {
    "valid": lambda: _register(dict(n_ops=200, concurrency=4, seed=11,
                                    value_range=3, crash_prob=0.05)),
    "valid-crashes": lambda: _register(dict(n_ops=300, concurrency=4,
                                            seed=12, value_range=4,
                                            crash_prob=0.08,
                                            max_crashes=5)),
    "corrupt-a": lambda: _register(dict(n_ops=200, concurrency=4, seed=13,
                                        value_range=3, crash_prob=0.05),
                                   corrupt=True),
    "corrupt-b": lambda: _register(dict(n_ops=300, concurrency=4, seed=14,
                                        value_range=3, crash_prob=0.1,
                                        max_crashes=5), corrupt=True),
    "mutex": lambda: _mutex(dict(n_ops=200, concurrency=4, seed=15,
                                 crash_prob=0.1)),
    "mutex-double-acquire": lambda: (_double_acquire(jh),
                                     _double_acquire(th), jm.mutex(),
                                     tm.mutex()),
}


def _path_ops_are_history_ops(result, packed):
    """Every final path lists ops of this history, each at most once."""
    ops = {(o.process, o.f, repr(o.value), o.op_index, o.ok)
           for o in packed.ops}
    for fp in result["final-paths"]:
        seen = [(d["process"], d["f"], repr(d["value"]), d["index"],
                 d["ok"]) for d in fp["path"]]
        assert set(seen) <= ops
        assert len(seen) == len(set(seen))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpu_path_matches_jax_tpu_and_the_oracle(case):
    hj, ht, mj, mt = CASES[case]()
    want = jchecker.linearizable(algorithm="tpu").check(None, mj, hj)
    oracle = jchecker.linearizable(algorithm="cpu").check(None, mj, hj)
    got = tchecker.linearizable(algorithm="gpu",
                                device="cpu").check(None, mt, ht)
    port_cpu = tchecker.linearizable(algorithm="cpu").check(None, mt, ht)
    assert got["valid?"] is want["valid?"] is oracle["valid?"] \
        is port_cpu["valid?"]
    assert got["analyzer"] == "gpu-dense" and got["backend"] == "plain"
    if got["valid?"] is False:
        assert got["dead-row"] == want["dead-row"] == port_cpu["dead-row"]
        assert got["op"] == want["op"] == oracle["op"] == port_cpu["op"]
        assert got["final-paths"], "an invalid verdict carries final paths"
        assert got["final-paths"] == want["final-paths"]
        assert got["configs"] == want["configs"]
        _path_ops_are_history_ops(got, tprep.prepare(mt, ht))


@pytest.mark.parametrize("case", ["valid-crashes", "corrupt-b"])
def test_small_chunks_carry_the_frontier(case):
    _, ht, _, mt = CASES[case]()
    p = tprep.prepare(mt, ht)
    whole = tdense.check_packed(p, device="cpu")
    snaps = []
    small = tdense.check_packed(p, chunk=64, device="cpu", snapshots=snaps)
    assert small["valid?"] == whole["valid?"]
    assert small.get("dead-row") == whole.get("dead-row")
    assert [b for b, _ in snaps] == list(range(0, len(snaps) * 64, 64))
    if whole["valid?"]:
        assert small["final-frontier-popcount"] == \
            whole["final-frontier-popcount"]


def test_competition_races_and_joins_its_loser():
    _, ht, _, mt = CASES["corrupt-a"]()
    before = threading.active_count()
    r = tchecker.linearizable(algorithm="competition",
                              device="cpu").check(None, mt, ht)
    assert r["valid?"] is False and r["final-paths"]
    assert threading.active_count() == before


@pytest.mark.parametrize("kw", [dict(cap_schedule=(8,)),
                                dict(cap_schedule=(8,), chunk=64,
                                     explain=False)],
                         ids=["cap_schedule", "all-options"])
def test_competition_forwards_the_device_options(monkeypatch, kw):
    """Under "competition" the device racer gets the device options the
    reference's racer gets (chunk, cap_schedule, explain). Both packages'
    sparse engines are recorded, not run (at cap 8 the frontier spikes to
    262,144 and a real run takes minutes on the CPU), and both CPU racers
    step aside, so each race returns its device racer's result: the
    analyzer and the top cap it was asked to search at."""
    kw_h = dict(concurrency=26, seed=1, value_range=5)
    calls = {}

    def engine(pkg, analyzer, default):
        def check_packed(packed, cancel=None, **k):
            calls[pkg] = k
            return {"valid?": True, "analyzer": analyzer,
                    "max-cap": tuple(k.get("cap_schedule") or default)[-1]}
        return check_packed

    def step_aside(packed, **k):
        return {"valid?": "unknown", "error": "stepped aside"}

    monkeypatch.setattr(tbfs, "check_packed",
                        engine("torch", "gpu-bfs", tbfs.PACKED_CAP_SCHEDULE))
    monkeypatch.setattr(jbfs, "check_packed",
                        engine("jax", "tpu-bfs", jbfs.PACKED_CAP_SCHEDULE))
    monkeypatch.setattr(tcpu, "check_packed", step_aside)
    monkeypatch.setattr(jcpu, "check_packed", step_aside)
    ht = tsynth.generate_register_history(400, **kw_h)
    assert tprep.prepare(tm.cas_register(), ht).window == 22
    got = tlin.analysis(tm.cas_register(), ht, algorithm="competition",
                        device="cpu", **kw)
    want = jlin.analysis(jm.cas_register(),
                         jsynth.generate_register_history(400, **kw_h),
                         algorithm="competition", **kw)
    dev = calls["torch"].pop("device")
    assert str(dev) == "cpu"
    assert calls["torch"] == calls["jax"] == kw
    assert (got["valid?"], got["analyzer"], got["max-cap"]) == \
        (True, "gpu-bfs", 8)
    assert (want["valid?"], want["analyzer"], want["max-cap"]) == \
        (True, "tpu-bfs", 8)


def _wide_window(H, n=21, crash=False):
    """A write, then n concurrent reads of its value: window n. With
    ``crash``, a concurrent write that crashes (info) joins them."""
    ops = [H.invoke_op(0, "write", 1), H.ok_op(0, "write", 1)]
    ops += [H.invoke_op(p, "read", None) for p in range(1, n + 1)]
    if crash:
        ops += [H.invoke_op(n + 1, "write", 2),
                H.info_op(n + 1, "write", 2)]
    ops += [H.ok_op(p, "read", 1) for p in range(1, n + 1)]
    return H.History.of(*ops)


def test_a_window_past_the_dense_engine_is_an_honest_unknown():
    # Crash-free, the sparse engine decides it; with a crashed op it is in
    # the crash-dom band, which the sparse engine decides too. An unknown
    # remains where a frontier outgrows the last host capacity (here a
    # tiny one), and "competition" then takes the CPU oracle's verdict.
    h = _wide_window(th)
    assert tprep.prepare(tm.cas_register(), h).window == 21
    r = tchecker.linearizable(algorithm="gpu", device="cpu").check(
        None, tm.cas_register(), h)
    assert r["valid?"] is True and r["analyzer"] == "gpu-bfs"
    hc = _wide_window(th, crash=True)
    assert tprep.prepare(tm.cas_register(), hc).window == 22
    r = tchecker.linearizable(algorithm="gpu", device="cpu").check(
        None, tm.cas_register(), hc)
    assert r["valid?"] is True and r["analyzer"] == "gpu-bfs"
    r = tchecker.linearizable(algorithm="gpu", device="cpu",
                              cap_schedule=(1,), host_caps=(1,)).check(
        None, tm.cas_register(), hc)
    assert r["valid?"] == "unknown" and r["overflow"] == "capacity"
    assert r["error"] == "frontier exceeded capacity 1"
    c = tchecker.linearizable(algorithm="competition", device="cpu").check(
        None, tm.cas_register(), hc)
    assert c["valid?"] is True
    want = jchecker.linearizable(algorithm="cpu").check(
        None, jm.cas_register(), _wide_window(jh, crash=True))
    assert want["valid?"] is True


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tchecker.linearizable(algorithm="gpu").check(
            None, tm.cas_register(), _wide_window(th, 2))
    assert resolve_device("cpu").type == "cpu"
    assert tlin.analysis(tm.cas_register(), _wide_window(th, 2),
                         algorithm="cpu")["valid?"] is True


def test_trunc_and_cancel_are_honest_unknowns(monkeypatch):
    _, ht, _, mt = CASES["valid"]()
    p = tprep.prepare(mt, ht)
    cancel = threading.Event()
    cancel.set()
    r = tdense.check_packed(p, device="cpu", cancel=cancel)
    assert r["valid?"] == "unknown" and r["error"] == "cancelled"

    plain = dense_cuda.dense_chunk_plain

    def truncated(*a, **k):
        res = plain(*a, **k)
        res.state[2] = 1
        return res

    monkeypatch.setattr(dense_cuda, "dense_chunk", truncated)
    r = tdense.check_packed(p, device="cpu")
    assert r["valid?"] == "unknown" and r["overflow"] == "budget"


def test_unknown_options_and_algorithms_are_refused():
    h = _wide_window(th, 2)
    with pytest.raises(TypeError):
        tlin.analysis(tm.cas_register(), h, algorithm="cpu", bogus=1)
    with pytest.raises(ValueError):
        tlin.analysis(tm.cas_register(), h, algorithm="tpu")


def test_check_safe_turns_a_crash_into_unknown():
    ck = tchecker.FnChecker(lambda test, model, history, opts: 1 // 0)
    r = tchecker.check_safe(ck, None, tm.cas_register(), [])
    assert r["valid?"] == "unknown" and "ZeroDivisionError" in r["error"]
