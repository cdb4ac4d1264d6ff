"""The port's sparse engine against the JAX package's: host tables bit
for bit, ``bfs.check_packed`` on seeded crash-free register histories
(verdict, dead row, op, final frontier size, max cap, final paths), and
the routing of wide windows to it or to an honest unknown."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import _u32
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import lin as tlin
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import synth as tsynth
from jepsen_tpu_torch.models.kernels import NIL


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many tiny torch ops; on a loaded machine the
    barrier waits of torch's CPU thread pool dominate them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return _u32.bitmap_from_numpy(np.asarray(a, np.uint32), "cpu")


def _np(t):
    return _u32.bitmap_to_numpy(t)


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
# the slow test below. The pair cases (window + state bits > 31) are
# (140, 40, 3): with 60 values (window 28, 6 state bits) valid from spike
# cap 4096, corrupted (dead row 74), and with 5 values (window 31) past
# spike cap 4096.
CASES = {
    "valid-chunked": ((60, 16, 7), (16384, 131072), (262144,)),
    "valid-window-22": ((200, 24, 3), (16384, 131072), (262144,)),
    "valid-spike": ((60, 16, 7), (256,), (2048,)),
    "corrupt-spike": ((60, 16, 7, 2), (256,), (2048,)),
    "capacity-overflow": ((120, 24, 3), (256,), (4096,)),
    "pair-valid-spike": ((140, 40, 3, None, 60), (256,), (4096,)),
    "pair-corrupt-spike": ((140, 40, 3, 2, 60), (256,), (4096,)),
    "pair-capacity-overflow": ((140, 40, 3), (256,), (4096,)),
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


@pytest.mark.parametrize("name", ["valid-spike", "corrupt-spike",
                                  "pair-valid-spike"])
def test_engine_past_the_kernel_gate_matches_jax(engine_runs, monkeypatch,
                                                 name):
    """With the sort kernels gated off (as past PSORT_MAX_N and
    DEDUP_MAX_N), every dedup and compaction takes the torch.sort twins
    of the reference's lax.sort path, and the verdict is unchanged."""
    from jepsen_tpu_torch.lin import psort as tpsort

    pj, _, rj, _ = engine_runs[name]
    _, pt = _packed(*CASES[name][0])
    _, caps, spike = CASES[name]
    monkeypatch.setattr(tpsort, "available", lambda n: False)
    monkeypatch.setattr(tpsort, "dedup_available", lambda n: False)
    rt = tbfs.check_packed(pt, cap_schedule=caps, spike_caps=spike,
                           device="cpu")
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}


def test_the_cases_cover_the_engine_paths(engine_runs):
    assert engine_runs["valid-window-22"][1].window > 20
    assert engine_runs["valid-spike"][3]["max-cap"] == 2048     # spike mode
    assert engine_runs["corrupt-spike"][3]["valid?"] is False
    assert engine_runs["capacity-overflow"][3]["overflow"] == "capacity"
    for name in ("pair-valid-spike", "pair-corrupt-spike",
                 "pair-capacity-overflow"):
        pt = engine_runs[name][1]
        assert pt.window + max(len(pt.unintern), 2).bit_length() > 31
    valid = engine_runs["pair-valid-spike"][3]
    assert valid["max-cap"] == 4096                 # spike mode from 256
    stats = valid["engine-stats"]
    # A fused pair row, unfused pair passes (the spike rows), and return
    # filters that dropped configs (compact_keys2).
    assert stats["fused_rows"] > 0 and stats["unfused_passes"] > 0
    assert stats["compactions"] > 0
    corrupt = engine_runs["pair-corrupt-spike"][3]
    assert corrupt["dead-row"] == 74 and len(corrupt["final-paths"]) == 32
    assert engine_runs["pair-capacity-overflow"][3]["overflow"] == "capacity"


@pytest.mark.slow
@pytest.mark.parametrize("args,caps,spike,window", [
    # The reference's default caps: max cap 131072, grouped unfused pair
    # passes at the big tiers.
    ((140, 40, 3), (16384, 131072), (262144, 524288, 1048576), 31),
    # Two-word bitsets (nw = 2), valid at spike cap 65536.
    ((140, 48, 3, None, 60), (4096,), (65536,), 36),
], ids=["window-31-default-caps", "window-36-spike-65536"])
def test_pair_engine_matches_jax_at_large_caps(args, caps, spike, window):
    pj, pt = _packed(*args)
    assert pt.window == window
    rj = jbfs.check_packed(pj, cap_schedule=caps, spike_caps=spike)
    rt = tbfs.check_packed(pt, cap_schedule=caps, spike_caps=spike,
                           device="cpu")
    assert rj["valid?"] is True
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    M = tbfs.expansion_tables(pt, max(len(pt.unintern), 2).bit_length())[0]
    grouped = [t for t in rt["engine-stats"]["unfused_tiers"]
               if t * (1 + M.shape[-1]) > tbfs._GROUP_BOUND]
    assert grouped


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


@pytest.mark.parametrize("band", ["crash-dom", "pair-key crash-dom",
                                  "generic packed"])
def test_bands_left_out_are_honest_unknowns(band):
    """No band is left out any more. The generic packed band decides the
    wide mutex with the reference's verdict, and only a window past the
    device bitset is still an honest unknown. The crash-dom bands take
    crashed histories; what they cannot hold (here a frontier past a tiny
    last host capacity) is an honest capacity unknown, never a guess."""
    if band == "crash-dom":
        _, p = _packed(200, 24, 3, crash_prob=0.05)
        assert p.crashed.any()
    elif band == "pair-key crash-dom":
        # Crashed ops past one u32 key: the crash-dom band at pair width.
        _, p = _packed(160, 40, 3, crash_prob=0.05)
        assert p.crashed.any() and p.window + 3 > 31
    else:
        p = _mutex_wide()
    assert p.window > 20
    if band == "generic packed":
        from jepsen_tpu import history as jh

        assert tbfs.key_band(p) == "generic"
        n = 22
        ops = [jh.invoke_op(q, "acquire", None) for q in range(n)]
        ops += [jh.ok_op(q, "acquire", None) for q in range(n)]
        rj = jbfs.check_packed(jprep.prepare(jm.mutex(), jh.History.of(*ops)))
        r = tlin.device_check_packed(p, device="cpu")
        assert r["analyzer"] == "gpu-bfs" and r["valid?"] is False
        assert {k: r.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
        wide = _mutex_wide_prepared(65)
        r = tlin.device_check_packed(wide, device="cpu")
        assert r["valid?"] == "unknown" and r["analyzer"] == "gpu-bfs"
        assert r["error"] == ("concurrency window 65 exceeds device bitset "
                              "width 64")
        return
    assert tbfs.band_error(p) is None
    r = tlin.device_check_packed(p, device="cpu", cap_schedule=(64,),
                                 host_caps=(64,))
    assert r["valid?"] == "unknown" and r["analyzer"] == "gpu-bfs"
    assert r["overflow"] == "capacity"
    assert r["error"] == "frontier exceeded capacity 64"
    assert r["host-stats"]["episodes"] == 1


def _mutex_wide_prepared(n):
    """n concurrent acquires, packed past the device bitset's 64 slots."""
    from jepsen_tpu_torch import history as th

    ops = [th.invoke_op(q, "acquire", None) for q in range(n)]
    ops += [th.ok_op(q, "acquire", None) for q in range(n)]
    return tprep.prepare(tm.mutex(), th.History.of(*ops), max_window=128)


def test_a_crash_free_pair_window_routes_to_the_sparse_engine(engine_runs,
                                                              monkeypatch):
    """A crash-free history past one u32 key (window 28 + 6 state bits)
    decides on ``gpu-bfs`` through the user's entry point, with the
    reference's verdict; ``"cpu"`` still takes the CPU oracle."""
    pj, pt, rj, _ = engine_runs["pair-valid-spike"]
    assert tbfs.band_error(pt) is None and pt.window + 6 > 31
    h = tsynth.generate_register_history(140, concurrency=40, seed=3,
                                         value_range=60)
    r = tchecker.linearizable(algorithm="gpu", device="cpu").check(
        None, tm.cas_register(), h)
    assert r["analyzer"] == "gpu-bfs" and r["valid?"] is rj["valid?"]
    from jepsen_tpu_torch.lin import cpu as tcpu

    seen = []

    def oracle(p, **kw):
        seen.append(p.window)
        return {"valid?": True, "analyzer": "cpu"}

    monkeypatch.setattr(tcpu, "check_packed", oracle)
    r = tchecker.linearizable(algorithm="cpu").check(None, tm.cas_register(),
                                                     h)
    assert r["analyzer"] == "cpu" and seen == [pt.window]


def test_filter_pass_keys2_bit_in_hi_matches_jax(monkeypatch):
    """The pair return filter with the returner's key bit in hi (slot 30
    at 3 state bits: key bit 33), dropping and clear-only, with the
    compaction kernel's plain version and past the kernels' gate."""
    from jepsen_tpu_torch.lin import psort as tpsort

    cap, b, s = 1024, 3, 30
    rng = np.random.default_rng(30)
    k = np.unique(rng.integers(0, 1 << 36, 3 * cap, dtype=np.uint64))
    k = np.sort(rng.permutation(k)[:cap])
    hi_all = (k >> np.uint64(32)).astype(np.uint32)
    lo = k.astype(np.uint32)
    n_live = 700
    for held, drops in ((hi_all, True), (hi_all | np.uint32(2), False)):
        hi, lo_ = held.copy(), lo.copy()
        hi[n_live:] = lo_[n_live:] = 0xFFFFFFFF
        jl, jh, jc, jd = jbfs._filter_pass_keys2(
            jnp.asarray(lo_), jnp.asarray(hi), jnp.int32(n_live),
            jnp.int32(s), cap=cap, b=b, use_psort=False)
        for gated in (False, True):
            with monkeypatch.context() as mp:
                if gated:
                    mp.setattr(tpsort, "available", lambda n: False)
                tl, th, tc, td = tbfs._filter_pass_keys2(
                    _t(lo_), _t(hi), n_live, s, cap=cap, b=b)
            assert np.array_equal(_np(tl), np.asarray(jl))
            assert np.array_equal(_np(th), np.asarray(jh))
            assert (tc, td) == (int(jc), bool(jd))
        assert (0 < tc < n_live) if drops else tc == n_live


def test_pair_codec_matches_jax_at_window_36():
    """``_pack_frontier_keys2``/``_unpack_frontier_keys2`` against the
    reference's at window 36 (two-word bitsets), and the round trip."""
    W, b, nil_id, cap, n = 36, 3, 5, 64, 50
    rng = np.random.default_rng(36)
    b0 = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    b1 = rng.integers(0, 1 << (W - 32), n, dtype=np.uint64)
    bits = np.stack([b0, b1], axis=1)
    state = rng.integers(0, nil_id, (n, 1))
    state[::4] = int(NIL)
    jl, jh = jbfs._pack_frontier_keys2(
        jnp.asarray(bits.astype(np.uint32)), jnp.asarray(state, jnp.int32),
        jnp.int32(n - 3), cap, b, nil_id)
    tl, th = tbfs._pack_frontier_keys2(
        torch.from_numpy(bits.astype(np.int64)),
        torch.from_numpy(state.astype(np.int64)), n - 3, cap, b, nil_id)
    assert np.array_equal(_np(tl), np.asarray(jl))
    assert np.array_equal(_np(th), np.asarray(jh))
    assert (_np(th)[:n - 3] >> b).any()          # bitset bits in hi
    jb, js = jbfs._unpack_frontier_keys2(jl, jh, jnp.int32(n - 3), cap, b,
                                         nil_id, 2)
    tb, ts = tbfs._unpack_frontier_keys2(tl, th, n - 3, cap, b, nil_id, 2)
    assert np.array_equal(tb.numpy(), np.asarray(jb).astype(np.int64))
    assert np.array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    assert np.array_equal(tb[:n - 3].numpy(), bits[:n - 3].astype(np.int64))
    assert np.array_equal(ts[:n - 3].numpy(), state[:n - 3])
