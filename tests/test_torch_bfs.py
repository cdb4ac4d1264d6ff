"""The port's sparse engine against the JAX package's: host tables bit
for bit, ``bfs.check_packed`` on seeded crash-free register histories
(verdict, dead row, op, final frontier size, max cap, final paths), and
the routing of wide windows to it or to an honest unknown."""

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import lin as tlin
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import bfs as tbfs
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


def _packed(n, concurrency, seed, corrupt=None, value_range=5,
            crash_prob=0.0):
    kw = dict(concurrency=concurrency, seed=seed, value_range=value_range,
              crash_prob=crash_prob)
    hj = jsynth.generate_register_history(n, **kw)
    ht = tsynth.generate_register_history(n, **kw)
    if corrupt is not None:
        hj = jsynth.corrupt_history(hj, seed=corrupt)
        ht = tsynth.corrupt_history(ht, seed=corrupt)
    return (jprep.prepare(jm.cas_register(), hj),
            tprep.prepare(tm.cas_register(), ht))


# name: (history args, cap_schedule, spike_caps). The spike cases reach
# spike mode at a small spike cap; the reference's own 262144 spike is
# the slow test below.
CASES = {
    "valid-chunked": ((60, 16, 7), (16384, 131072), (262144,)),
    "valid-window-22": ((200, 24, 3), (16384, 131072), (262144,)),
    "valid-spike": ((60, 16, 7), (256,), (2048,)),
    "corrupt-spike": ((60, 16, 7, 2), (256,), (2048,)),
    "capacity-overflow": ((120, 24, 3), (256,), (4096,)),
}
KEYS = ("valid?", "dead-row", "op", "final-frontier-size", "max-cap",
        "overflow")


@pytest.fixture(scope="module")
def engine_runs():
    """Each case through both engines (explain on), computed once."""
    out = {}
    for name, (args, caps, spike) in CASES.items():
        pj, pt = _packed(*args)
        rj = jbfs.check_packed(pj, cap_schedule=caps, spike_caps=spike,
                               explain=True)
        rt = tbfs.check_packed(pt, cap_schedule=caps, spike_caps=spike,
                               explain=True, device="cpu")
        out[name] = (pj, pt, rj, rt)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax(engine_runs, name):
    pj, pt, rj, rt = engine_runs[name]
    assert (pt.window, pt.R) == (pj.window, pj.R)
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    assert rt["analyzer"] == "gpu-bfs" and rt["backend"] == "plain"
    if rj["valid?"] is False:
        assert rt["final-paths"] and rt["final-paths"] == rj["final-paths"]
        assert rt["configs"] == rj["configs"]


@pytest.mark.parametrize("name", ["valid-spike", "corrupt-spike"])
def test_engine_past_the_kernel_gate_matches_jax(engine_runs, monkeypatch,
                                                 name):
    """With the sort kernels gated off, as past PSORT_MAX_N at the top
    spike caps, every dedup and compaction takes the torch.sort twins of
    the reference's lax.sort path, and the verdict is unchanged."""
    from jepsen_tpu_torch.lin import psort as tpsort

    pj, _, rj, _ = engine_runs[name]
    _, pt = _packed(*CASES[name][0])
    _, caps, spike = CASES[name]
    monkeypatch.setattr(tpsort, "available", lambda n: False)
    rt = tbfs.check_packed(pt, cap_schedule=caps, spike_caps=spike,
                           device="cpu")
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}


def test_the_cases_cover_the_engine_paths(engine_runs):
    assert engine_runs["valid-window-22"][1].window > 20
    assert engine_runs["valid-spike"][3]["max-cap"] == 2048     # spike mode
    assert engine_runs["corrupt-spike"][3]["valid?"] is False
    assert engine_runs["capacity-overflow"][3]["overflow"] == "capacity"


@pytest.mark.slow
def test_engine_matches_jax_at_the_reference_spike_cap():
    """The 60-op history past cap 256 reaches the reference's own spike
    cap 262144, whose closure runs grouped (G = M column groups)."""
    pj, pt = _packed(60, 16, 7)
    rj = jbfs.check_packed(pj, cap_schedule=(256,))
    rt = tbfs.check_packed(pt, cap_schedule=(256,), device="cpu")
    assert rj["max-cap"] == 262144
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}


def test_expansion_tables_match_jax():
    pj, pt = _packed(200, 24, 3)
    b = max(len(pj.unintern), 2).bit_length()
    for a, e in zip(tbfs.expansion_tables(pt, b),
                    jbfs.expansion_tables(pj, b)):
        assert a.dtype == np.asarray(e).dtype
        assert np.array_equal(a, np.asarray(e))
    for a, e in zip(tbfs.reduction_bit_tables(pt, 1),
                    jbfs.reduction_bit_tables(pj, 1)):
        assert np.array_equal(a, np.asarray(e))


def test_cancel_is_an_honest_unknown():
    import threading

    _, pt = _packed(60, 16, 7)
    cancel = threading.Event()
    cancel.set()
    r = tbfs.check_packed(pt, device="cpu", cancel=cancel)
    assert r["valid?"] == "unknown" and r["error"] == "cancelled"


# --- routing --------------------------------------------------------------


def test_a_crash_free_wide_window_routes_to_the_sparse_engine(monkeypatch):
    _, pt = _packed(200, 24, 3)
    assert pt.window > 20 and tbfs.band_error(pt) is None
    seen = []

    def fake(p, **kw):
        seen.append((p.window, sorted(kw)))
        return {"valid?": True, "analyzer": "gpu-bfs"}

    monkeypatch.setattr(tbfs, "check_packed", fake)
    h = tsynth.generate_register_history(200, concurrency=24, seed=3,
                                         value_range=5)
    r = tchecker.linearizable(algorithm="gpu", device="cpu",
                              cap_schedule=(256,)).check(
        None, tm.cas_register(), h)
    assert r["analyzer"] == "gpu-bfs"
    assert seen == [(pt.window, ["cancel", "cap_schedule", "device",
                                 "explain"])]


def _mutex_wide(n=22):
    """n concurrent acquires: window n (routing only, never searched)."""
    from jepsen_tpu_torch import history as th

    ops = [th.invoke_op(p, "acquire", None) for p in range(n)]
    ops += [th.ok_op(p, "acquire", None) for p in range(n)]
    return tprep.prepare(tm.mutex(), th.History.of(*ops))


@pytest.mark.parametrize("band", ["crash-dom", "pair-key", "generic packed"])
def test_bands_left_out_are_honest_unknowns(band):
    if band == "crash-dom":
        _, p = _packed(200, 24, 3, crash_prob=0.05)
        assert p.crashed.any()
    elif band == "pair-key":
        _, p = _packed(160, 40, 3)
        assert p.window + 3 > 31
    else:
        p = _mutex_wide()
    assert p.window > 20
    r = tlin.device_check_packed(p, device="cpu")
    assert r["valid?"] == "unknown" and r["analyzer"] == "gpu-bfs"
    assert band in r["error"] and "not yet ported" in r["error"]
