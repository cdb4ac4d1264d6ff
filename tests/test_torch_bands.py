"""The sparse engine's last two bands in the port against the JAX package:
the generic packed band (one-word packed kernels past the compact
register band: a mutex past window 20, a one-word set) and the multiword
band for one history (sets past 31 elements, the queues, any state wider
than one word, and ``packed_keys=False``), with what they need: the set
and queue models and step kernels, ``prepare``'s tables for them, the
CPU oracle's generic search and state decoding, the queue and set
generators, the dense routing of small sets and the key batch over
queue keys. Keys and states are integers, so every comparison is exact
(tolerance 0). The five full shapes of ``chip_smoke.py``'s phase 21 run
under ``-m slow``."""

import itertools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu.lin import batched as jbatched
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import cpu as jcpu
from jepsen_tpu.lin import dense as jdense
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu.models import kernels as JK
from jepsen_tpu_torch import _u32
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import lin as tlin
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import batched as tbatched
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import cpu as tcpu
from jepsen_tpu_torch.lin import dense as tdense
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import synth as tsynth
from jepsen_tpu_torch.models import kernels as TK

NIL = int(JK.NIL)
KEYS = ("valid?", "dead-row", "op", "final-frontier-size", "max-cap",
        "overflow")
PACKED = ("ret_slot", "ret_op", "active", "slot_f", "slot_v", "slot_op",
          "crashed", "init_state")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many tiny torch ops; on a loaded machine the
    barrier waits of torch's CPU thread pool dominate them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- histories, built alike in both packages ---------------------------------

def _fail_to_ok(h, seed):
    """A mutex history made invalid: one failed acquire turned ok."""
    h = list(h)
    pos = [i for i, o in enumerate(h) if o.type == "fail" and o.f == "acquire"]
    i = random.Random(seed).choice(pos)
    h[i] = h[i].replace(type="ok")
    return h


def _drop_read_element(h, seed):
    """A set history made invalid: one ok read misses its last element."""
    h = list(h)
    pos = [i for i, o in enumerate(h)
           if o.type == "ok" and o.f == "read" and o.value]
    i = random.Random(seed).choice(pos)
    h[i] = h[i].replace(value=list(h[i].value)[:-1])
    return h


def _wide_mutex(mod, n=22, rounds=2, drop_release=None):
    """n processes invoke acquire together and take the lock in turn,
    ``rounds`` times, each invoking its next acquire at once, so that the
    window stays past 20. ``drop_release`` (a process) fails that
    process's first release: the next acquire is then illegal."""
    ops = [mod.invoke_op(q, "acquire", None) for q in range(n)]
    for rnd in range(rounds):
        for q in range(n):
            ops.append(mod.ok_op(q, "acquire", None))
            ops.append(mod.invoke_op(q, "release", None))
            if rnd == 0 and q == drop_release:
                ops.append(mod.fail_op(q, "release", None))
            else:
                ops.append(mod.ok_op(q, "release", None))
            if rnd + 1 < rounds:
                ops.append(mod.invoke_op(q, "acquire", None))
    return mod.History.of(*ops)


def _crashed_mutex(mod, n=22):
    """The crashed generic-band history of test_torch_crashdom.py."""
    ops = [mod.invoke_op(p, "acquire", None) for p in range(n)]
    ops += [mod.invoke_op(n, "release", None), mod.info_op(n, "release", None)]
    ops += [mod.ok_op(p, "acquire", None) for p in range(n)]
    return mod.History.of(*ops)


def _multiset_queue(mod):
    """Repeated enqueued values: the counting unordered-queue kernel."""
    return mod.History.of(
        mod.invoke_op(0, "enqueue", 5), mod.ok_op(0, "enqueue", 5),
        mod.invoke_op(1, "enqueue", 5), mod.invoke_op(2, "dequeue", None),
        mod.ok_op(1, "enqueue", 5), mod.ok_op(2, "dequeue", 5),
        mod.invoke_op(0, "dequeue", None), mod.ok_op(0, "dequeue", 5))


def _synth(name):
    return {"j": jsynth, "t": tsynth}[name]


def _hist(mod):
    return {"j": jh, "t": th}[mod]


# name: (history of a package tag, JAX model, port model, check options).
MUTEX_2K = dict(concurrency=10, seed=7, crash_prob=0.01, max_crashes=16)
CASES = {
    # The generic packed band.
    "mutex-wide": (lambda k: _wide_mutex(_hist(k)), "mutex", {}),
    "mutex-wide-corrupt": (lambda k: _wide_mutex(_hist(k), drop_release=5),
                           "mutex", {}),
    "mutex-crashed": (lambda k: _crashed_mutex(_hist(k)), "mutex", {}),
    "mutex-2k": (lambda k: _synth(k).generate_mutex_history(2000,
                                                            **MUTEX_2K),
                 "mutex", {}),
    # bench.py's config-3 probe shape (5k ops at concurrency 30, up to 4
    # crashes): 31 return rows at window 6.
    "mutex-config3": (lambda k: _synth(k).generate_mutex_history(
        5000, concurrency=30, seed=7, crash_prob=0.002, max_crashes=4),
        "mutex", {}),
    "mutex-2k-corrupt": (lambda k: _fail_to_ok(
        _synth(k).generate_mutex_history(2000, **MUTEX_2K), 3), "mutex", {}),
    "mutex-spike": (lambda k: _synth(k).generate_mutex_history(2000,
                                                               **MUTEX_2K),
                    "mutex", dict(cap_schedule=(4,), spike_caps=(64,))),
    "mutex-capacity": (lambda k: _synth(k).generate_mutex_history(
        2000, **MUTEX_2K), "mutex", dict(cap_schedule=(2,),
                                         spike_caps=(4,))),
    "set-word": (lambda k: _synth(k).generate_set_history(40, seed=7),
                 "set_model", {}),
    "set-word-corrupt": (lambda k: _drop_read_element(
        _synth(k).generate_set_history(40, seed=7), 1), "set_model", {}),
    # The multiword band.
    "set-2w": (lambda k: _synth(k).generate_set_history(40, concurrency=4),
               "set_model", {}),
    "set-2w-corrupt": (lambda k: _drop_read_element(
        _synth(k).generate_set_history(40, concurrency=4), 2), "set_model",
        {}),
    "fifo-36": (lambda k: _synth(k).generate_queue_history(36, seed=1),
                "fifo_queue", {}),
    "fifo-from-random": (lambda k: _synth(k).generate_queue_history(
        36, seed=2, fifo=False), "fifo_queue", {}),
    "fifo-spike": (lambda k: _synth(k).generate_queue_history(36, seed=1),
                   "fifo_queue", dict(cap_schedule=(16,),
                                      spike_caps=(64, 256))),
    "unordered-36": (lambda k: _synth(k).generate_queue_history(
        36, seed=1, fifo=False, crash_prob=0.05), "unordered_queue", {}),
    "unordered-multiset": (lambda k: _multiset_queue(_hist(k)),
                           "unordered_queue", {}),
    "register-multiword": (lambda k: _synth(k).generate_register_history(
        60, concurrency=5, seed=1), "cas_register", dict(packed_keys=False)),
    "register-multiword-corrupt": (lambda k: _synth(k).corrupt_history(
        _synth(k).generate_register_history(60, concurrency=5, seed=1),
        seed=2), "cas_register", dict(packed_keys=False)),
}
BANDS = {"mutex-wide": "generic", "mutex-crashed": "generic",
         "mutex-2k": "generic", "mutex-config3": "generic",
         "set-word": "generic", "set-2w": "multiword",
         "fifo-36": "multiword", "unordered-36": "multiword",
         "unordered-multiset": "multiword"}


def _both(name):
    gen, model, kw = CASES[name]
    pj = jprep.prepare(getattr(jm, model)(), gen("j"))
    pt = tprep.prepare(getattr(tm, model)(), gen("t"))
    return pj, pt, kw


@pytest.fixture(scope="module")
def engine_runs():
    """Each case through both engines (explain on), computed once."""
    out = {}
    for name in CASES:
        pj, pt, kw = _both(name)
        rj = jbfs.check_packed(pj, explain=True, **kw)
        rt = tbfs.check_packed(pt, explain=True, device="cpu", **kw)
        out[name] = (pj, pt, rj, rt)
    return out


def _replays(p, final_paths) -> bool:
    """Each final path is a legal sequence of steps of the port's Python
    model from the history's initial model."""
    for fp in final_paths:
        st = p.model
        for od in fp["path"]:
            st = st.step(th.invoke_op(od["process"], od["f"], od["value"]))
            if tm.is_inconsistent(st):
                return False
    return True


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax(engine_runs, name):
    pj, pt, rj, rt = engine_runs[name]
    assert (pt.window, pt.R) == (pj.window, pj.R)
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    assert rt["analyzer"] == "gpu-bfs" and rt["backend"] == "plain"
    assert "host-stats" not in rt
    if rj["valid?"] is False:
        assert rt["final-paths"] and _replays(pt, rt["final-paths"])
        assert rt["final-paths"] == rj["final-paths"]


def test_the_cases_cover_both_bands(engine_runs):
    for name, band in BANDS.items():
        pt = engine_runs[name][1]
        assert tbfs.key_band(pt) == band, name
        # mutex-2k (window 18) and mutex-config3 (window 6) are the sparse
        # engine's only when called directly; the device route would plan
        # them dense.
        assert (tdense.plan(pt) is None) is \
            (name not in ("mutex-2k", "mutex-config3")), name
    assert engine_runs["mutex-wide"][1].window > 20
    assert (engine_runs["mutex-config3"][1].window,
            engine_runs["mutex-config3"][1].R) == (6, 31)
    assert engine_runs["mutex-crashed"][1].crashed.any()
    assert engine_runs["set-2w"][1].state_width == 2
    assert engine_runs["fifo-36"][1].kernel.name == "fifo-queue"
    assert engine_runs["unordered-36"][1].kernel.name == "unordered-unique"
    assert engine_runs["unordered-multiset"][1].kernel.name == \
        "unordered-queue"
    assert tbfs.key_band(engine_runs["register-multiword"][1],
                         packed_keys=False) == "multiword"
    for name in ("mutex-wide-corrupt", "mutex-2k-corrupt",
                 "set-word-corrupt", "set-2w-corrupt",
                 "register-multiword-corrupt"):
        assert engine_runs[name][3]["valid?"] is False, name
    # Spike mode: one level, and two (an escalation inside spike mode).
    assert engine_runs["mutex-spike"][3]["max-cap"] == 64
    assert engine_runs["fifo-spike"][3]["max-cap"] == 256
    r = engine_runs["mutex-capacity"][3]
    assert r["overflow"] == "capacity"
    assert r["error"] == "frontier exceeded capacity 4"


@pytest.mark.parametrize("name", ["set-2w", "fifo-36", "unordered-36"])
def test_multiword_band_counts_passes_and_fetches(engine_runs, name):
    """The multiword band's engine-stats: a row a search call, at least one
    closure pass a row, and its blocking fetches, one a pass and three a
    row (two of the row loop, one of the chunk's verdict)."""
    st = engine_runs[name][3]["engine-stats"]
    assert set(st) == {"rows", "passes", "fetches"}
    assert st["passes"] >= st["rows"] > 0
    assert st["fetches"] == st["passes"] + 3 * st["rows"]


def test_generic_band_dedups_and_compacts_through_the_kernels(monkeypatch):
    """The generic band's passes call ``psort.dedup_keys`` and its return
    filters ``psort.compact_keys``, the wrappers the card runs."""
    from jepsen_tpu_torch.lin import psort

    _, pt, _ = _both("mutex-2k")
    calls = {"dedup_keys": 0, "compact_keys": 0}
    for name in calls:
        orig = getattr(psort, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(psort, name, spy)
    r = tbfs.check_packed(pt, device="cpu")
    st = r["engine-stats"]
    assert r["valid?"] is True
    assert calls["dedup_keys"] == st["unfused_passes"] > 0
    assert calls["compact_keys"] == st["compactions"] > 0


def test_generic_band_past_the_kernel_gate_matches_jax(monkeypatch,
                                                       engine_runs):
    """With the sort kernels gated off, the generic band's dedups and
    compactions take the torch.sort twins, and the verdict is unchanged."""
    from jepsen_tpu_torch.lin import psort

    monkeypatch.setattr(psort, "available", lambda n: False)
    monkeypatch.setattr(psort, "dedup_available", lambda n: False)
    for name in ("mutex-spike", "mutex-2k-corrupt"):
        _, pt, kw = _both(name)
        rj = engine_runs[name][2]
        rt = tbfs.check_packed(pt, device="cpu", **kw)
        assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}


# --- one closure pass, bit for bit ------------------------------------------

@pytest.mark.parametrize("name", ["mutex-2k", "set-word"])
def test_closure_pass_matches_jax_bit_for_bit(name):
    """``_expand_keys`` and ``_closure_pass_keys`` against the reference's
    on the same keys and row: candidates, validity, survivors, count,
    changed and overflow flags."""
    pj, pt, _ = _both(name)
    b = TK.packed_state_bound(pt.kernel, len(pt.unintern)).bit_length()
    nil_id = TK.packed_state_bound(pt.kernel, len(pt.unintern))
    pure, pred_bit = jbfs.reduction_bit_tables(pj, 1)
    rng = np.random.default_rng(5)
    cap = 64
    for r in (pt.R // 2,):
        states = rng.integers(0, 2, 40) if name == "mutex-2k" \
            else rng.integers(0, nil_id, 40)
        bits = rng.integers(0, 1 << pt.window, 40)
        keys = np.unique(((bits << b) | states).astype(np.uint32))
        count = len(keys) - 3
        keys_in = np.full(cap, 0xFFFFFFFF, np.uint32)
        keys_in[:count] = keys[:count]
        row_j = (jnp.asarray(pj.active[r]), jnp.asarray(pj.slot_f[r]),
                 jnp.asarray(pj.slot_v[r]), jnp.asarray(pure[r]),
                 jnp.asarray(pred_bit[r, :, 0]))
        row_t = (torch.from_numpy(pt.active[r]),
                 torch.from_numpy(pt.slot_f[r]).long(),
                 torch.from_numpy(pt.slot_v[r]).long(),
                 torch.from_numpy(pure[r]),
                 torch.from_numpy(pred_bit[r, :, 0].astype(np.int64)))
        kw = dict(cap=cap, b=b, nil_id=nil_id)
        cj, vj = jbfs._expand_keys(jnp.asarray(keys_in), count, *row_j,
                                   W=pt.window, step_fn=pj.kernel.step,
                                   read_value_match=False, **kw)
        k_t = _u32.bitmap_from_numpy(keys_in, "cpu")
        ct, vt = tbfs._expand_keys(k_t, count, *row_t,
                                   step_fn=pt.kernel.step, **kw)
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
        np.testing.assert_array_equal(np.asarray(cj),
                                      _u32.bitmap_to_numpy(ct))
        out_j = jbfs._closure_pass_keys(
            jnp.asarray(keys_in), count, *row_j, W=pt.window,
            step_fn=pj.kernel.step, read_value_match=False, **kw)
        out_t = tbfs._closure_pass_keys(k_t, count, *row_t,
                                        step_fn=pt.kernel.step, **kw)
        np.testing.assert_array_equal(np.asarray(out_j[0]),
                                      _u32.bitmap_to_numpy(out_t[0]))
        assert [int(x) for x in out_j[1:]] == [int(x) for x in out_t[1:]]


# --- step kernels, models, prepare -------------------------------------------

STEP_CASES = {
    # name: (JAX kernel, port kernel, state values, value ids)
    "set-1-word": (JK.set_kernel(3), TK.set_kernel(3), (0, 1, 5, 7, NIL),
                   (NIL, 0, 1, 2, 5, 7, 31)),
    "set-2-words": (JK.set_kernel(40), TK.set_kernel(40), (0, 1, 3),
                    (NIL, 0, 1, 3, 33)),
    "unordered-queue": (JK.unordered_queue_kernel(3),
                        TK.unordered_queue_kernel(3), (0, 1, 2),
                        (NIL, -1, 0, 1, 2, 3)),
    "unordered-unique": (JK.unordered_unique_kernel(40),
                         TK.unordered_unique_kernel(40), (0, 1, 2),
                         (NIL, 0, 1, 32, 33)),
    "fifo-queue": (JK.fifo_queue_kernel(2), TK.fifo_queue_kernel(2),
                   (0, 1, 2, 3), (NIL, 0, 1, 2)),
}


def _step_grid(S, VW, svals, vals):
    st = np.array(list(itertools.product(svals, repeat=S)), np.int32)
    vv = np.array(list(itertools.product(vals, repeat=VW)), np.int32)
    i, f, k = np.meshgrid(np.arange(len(st)), np.arange(9),
                          np.arange(len(vv)), indexing="ij")
    return st[i.ravel()], f.ravel().astype(np.int32), vv[k.ravel()]


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_matches_jax_over_every_state_f_and_value(name):
    """Every (state, f, v) of a small grid, NIL and foreign f ids
    included, through the reference's jnp step and the port's torch step
    (and, on the states the Python twin takes, the port's py_step_fn)."""
    jk, tk, svals, vals = STEP_CASES[name]
    assert (tk.name, tk.state_width, tk.value_width, tk.state_bound) == \
        (jk.name, jk.state_width, jk.value_width, jk.state_bound)
    np.testing.assert_array_equal(jk.init_state(), tk.init_state())
    st, f, v = _step_grid(jk.state_width, jk.value_width, svals, vals)
    ok_j, new_j = jax.vmap(jk.step)(jnp.asarray(st), jnp.asarray(f),
                                    jnp.asarray(v))
    ok_t, new_t = tk.step(torch.from_numpy(st), torch.from_numpy(f),
                          torch.from_numpy(v))
    np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
    np.testing.assert_array_equal(np.asarray(new_j), new_t.numpy())
    # The Python twin on the ops a packed history can hold: a kernel's
    # own f, value ids in range, states that are not NIL.
    py = tprep.py_step_fn(tk.name)
    own = {"set": (TK.F_ADD, TK.F_READ)}.get(tk.name,
                                             (TK.F_ENQUEUE, TK.F_DEQUEUE))
    sel = np.isin(f, own) & (st != NIL).all(1) & (v[:, 0] >= 0) \
        & (v[:, 0] < (31 * tk.state_width if tk.name != "unordered-queue"
                      else tk.state_width))
    if tk.name == "fifo-queue":
        sel &= st[:, 0] <= tk.state_width - 1
    sel_idx = np.flatnonzero(sel)
    assert len(sel_idx) > 10
    for i in sel_idx:
        ok, new = py(tuple(int(x) for x in st[i]), int(f[i]),
                     tuple(int(x) for x in v[i]))
        assert ok == bool(ok_t[i]), (name, st[i], f[i], v[i])
        if ok:
            assert list(new) == new_t[i].tolist(), (name, st[i], f[i], v[i])


def test_step_broadcasts_configs_against_slots():
    """The engines evaluate [cap, 1, S] states against [1, W] ops."""
    k = TK.fifo_queue_kernel(3)
    states = torch.tensor([[0, 0, 0, 0], [1, 7, 0, 0]]).view(2, 1, 4)
    f = torch.tensor([[TK.F_ENQUEUE, TK.F_DEQUEUE]])
    v = torch.tensor([[[9, NIL], [7, NIL]]])
    ok, new = k.step(states, f, v)
    assert ok.tolist() == [[True, False], [True, True]]
    assert new.shape == (2, 2, 4)
    assert new[1, 0].tolist() == [2, 7, 9, 0]
    assert new[1, 1].tolist() == [0, 0, 0, 0]


def test_models_and_kernel_for_match_the_reference():
    ops = [("add", 1), ("read", [1]), ("read", [2]), ("enqueue", 3),
           ("dequeue", 3), ("dequeue", 4)]
    for jmodel, tmodel in ((jm.set_model(), tm.set_model()),
                           (jm.unordered_queue(), tm.unordered_queue()),
                           (jm.fifo_queue(), tm.fifo_queue()),
                           (jm.noop, tm.noop)):
        sj, st = jmodel, tmodel
        for f, v in ops:
            sj = sj.step(jh.invoke_op(0, f, v))
            st = st.step(th.invoke_op(0, f, v))
            assert jm.is_inconsistent(sj) == tm.is_inconsistent(st)
            if jm.is_inconsistent(sj):
                assert sj.msg == st.msg
                sj, st = jmodel, tmodel
    assert tm.multiset([1, 1, 2]) == jm.multiset([1, 1, 2])
    k = TK.kernel_for(tm.SetModel(frozenset({"a", "b"})))
    assert (k.name, k.state_bound, k.init_state().tolist()) == \
        ("set", 4, [3])
    k = TK.kernel_for(tm.FIFOQueue((4, 3)))
    assert k.name == "fifo-queue" and k.init_state().tolist() == [2, 1, 0]
    assert TK.kernel_for(tm.UnorderedQueue((1, 1))).name == "unordered-queue"
    assert TK.kernel_for(tm.UnorderedQueue((1, 2))).name == \
        "unordered-unique"
    assert TK.PACKED_STATE_KERNELS == JK.PACKED_STATE_KERNELS
    for kern in (TK.set_kernel(3), TK.set_kernel(40), TK.mutex_kernel(),
                 TK.cas_register_kernel()):
        jkern = {"set": lambda: JK.set_kernel(3 if kern.state_width == 1
                                              else 40),
                 "mutex": JK.mutex_kernel,
                 "cas-register": JK.cas_register_kernel}[kern.name]()
        for n in (0, 5):
            assert TK.packed_state_bound(kern, n) == \
                JK.packed_state_bound(jkern, n)


PREP_CASES = {
    "set-word": (lambda k: _synth(k).generate_set_history(40, seed=7),
                 "set_model"),
    "set-wide": (lambda k: _synth(k).generate_set_history(
        600, concurrency=10, seed=7), "set_model"),
    "set-initial": (lambda k: _hist(k).History.of(
        _hist(k).invoke_op(0, "read", None),
        _hist(k).ok_op(0, "read", ["b", "a"])), None),
    "queue-unique": (lambda k: _synth(k).generate_queue_history(
        300, concurrency=10, seed=7, fifo=False), "unordered_queue"),
    "queue-multiset": (lambda k: _multiset_queue(_hist(k)),
                       "unordered_queue"),
    "fifo": (lambda k: _synth(k).generate_queue_history(100, seed=7),
             "fifo_queue"),
    "fifo-initial": (lambda k: _hist(k).History.of(
        _hist(k).invoke_op(0, "dequeue", None),
        _hist(k).ok_op(0, "dequeue", "x")), None),
    "mutex-wide": (lambda k: _synth(k).generate_mutex_history(
        20_000, concurrency=10, seed=7, crash_prob=0.01, max_crashes=16),
        "mutex"),
    "set-no-kernel": (lambda k: _hist(k).History.of(
        _hist(k).invoke_op(0, "add", None), _hist(k).ok_op(0, "add", None)),
        "set_model"),
}


def _prep_models(name):
    if name == "set-initial":
        return jm.SetModel(frozenset({"a"})), tm.SetModel(frozenset({"a"}))
    if name == "fifo-initial":
        return jm.FIFOQueue(("x",)), tm.FIFOQueue(("x",))
    model = PREP_CASES[name][1]
    return getattr(jm, model)(), getattr(tm, model)()


@pytest.mark.parametrize("name", list(PREP_CASES))
def test_prepare_matches_jax(name):
    """Kernel name, state width, value width, state bound, the initial
    state, the intern table and every packed array."""
    gen = PREP_CASES[name][0]
    hj, ht = gen("j"), gen("t")
    assert [o.to_dict() for o in hj] == [o.to_dict() for o in ht]
    mj, mt = _prep_models(name)
    pj, pt = jprep.prepare(mj, hj), tprep.prepare(mt, ht)
    if pj.kernel is None:
        assert pt.kernel is None
    else:
        assert (pt.kernel.name, pt.kernel.state_width,
                pt.kernel.value_width, pt.kernel.state_bound) == \
            (pj.kernel.name, pj.kernel.state_width, pj.kernel.value_width,
             pj.kernel.state_bound)
    assert (pt.window, pt.R, pt.unintern) == (pj.window, pj.R, pj.unintern)
    for f in PACKED:
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f),
                                      err_msg=f)
        assert getattr(pt, f).dtype == getattr(pj, f).dtype, f
    rj, rt = jprep.reduction_tables(pj), tprep.reduction_tables(pt)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a, b)


def test_prepare_bounds_match_the_reference():
    assert (tprep.MAX_SET_WORDS, tprep.MAX_QUEUE_VALUES,
            tprep.MAX_FIFO_CAP) == (jprep.MAX_SET_WORDS,
                                    jprep.MAX_QUEUE_VALUES,
                                    jprep.MAX_FIFO_CAP)
    for k in ("j", "t"):
        # Repeated values past MAX_QUEUE_VALUES, and a fifo deeper than
        # MAX_FIFO_CAP: no kernel.
        mod = _hist(k)
        ops = []
        for v in range(40):
            ops += [mod.invoke_op(0, "enqueue", v), mod.ok_op(0, "enqueue",
                                                              v)]
        ops += [mod.invoke_op(0, "enqueue", 0), mod.ok_op(0, "enqueue", 0)]
        models = jm if k == "j" else tm
        prep = jprep if k == "j" else tprep
        assert prep.prepare(models.unordered_queue(),
                            mod.History.of(*ops)).kernel is None
        assert prep.prepare(models.fifo_queue(),
                            mod.History.of(*ops)).kernel is None


# --- the CPU oracle ----------------------------------------------------------

def _big_set(mod):
    """A set history past MAX_SET_WORDS x 31 = 496 elements."""
    ops = []
    for v in range(500):
        ops += [mod.invoke_op(v % 3, "add", v), mod.ok_op(v % 3, "add", v)]
    ops += [mod.invoke_op(0, "read", None),
            mod.ok_op(0, "read", list(range(499)))]
    return mod.History.of(*ops)


def _none_set(mod, bad):
    ops = [mod.invoke_op(0, "add", 1), mod.invoke_op(1, "add", None),
           mod.ok_op(0, "add", 1), mod.ok_op(1, "add", None),
           mod.invoke_op(2, "read", None),
           mod.ok_op(2, "read", [1] if bad else [1, None])]
    return mod.History.of(*ops)


ORACLE_CASES = {
    "set-word": lambda k: _synth(k).generate_set_history(40, seed=7),
    "set-word-corrupt": lambda k: _drop_read_element(
        _synth(k).generate_set_history(40, seed=7), 1),
    "set-2w-corrupt": lambda k: _drop_read_element(
        _synth(k).generate_set_history(40, concurrency=4), 2),
    "fifo-from-random": lambda k: _synth(k).generate_queue_history(
        36, seed=2, fifo=False),
    "unordered-36": lambda k: _synth(k).generate_queue_history(
        36, seed=1, fifo=False, crash_prob=0.05),
    "set-none-element": lambda k: _none_set(_hist(k), False),
    "set-none-element-bad": lambda k: _none_set(_hist(k), True),
    "set-past-496": lambda k: _big_set(_hist(k)),
}
ORACLE_MODELS = {"fifo-from-random": "fifo_queue",
                 "unordered-36": "unordered_queue"}


@pytest.mark.parametrize("name", list(ORACLE_CASES))
def test_cpu_oracle_matches_jax(name):
    """``cpu.check_packed`` (the packed search, or ``check_generic`` where
    the history has no kernel) against the reference's: verdict, op,
    analyzer and the decoded models of the reported configs."""
    model = ORACLE_MODELS.get(name, "set_model")
    gen = ORACLE_CASES[name]
    pj = jprep.prepare(getattr(jm, model)(), gen("j"))
    pt = tprep.prepare(getattr(tm, model)(), gen("t"))
    rj = jcpu.check_packed(pj, witness=True)
    rt = tcpu.check_packed(pt, witness=True)
    for k in ("valid?", "op", "analyzer"):
        assert rt.get(k) == rj.get(k), k
    if name.startswith("set-none") or name == "set-past-496":
        assert pt.kernel is None and rt["analyzer"] == "cpu-generic"
        gj = jcpu.check_generic(pj, witness=True)
        gt = tcpu.check_generic(pt, witness=True)
        assert (gt["valid?"], gt.get("op")) == (gj["valid?"], gj.get("op"))

        def as_set(m):
            return (type(m).__name__, frozenset(m.s))

        assert sorted(as_set(c["model"]) for c in gt["configs"]) == \
            sorted(as_set(c["model"]) for c in gj["configs"])
    else:
        assert sorted(map(repr, (c["model"] for c in rt["configs"]))) == \
            sorted(map(repr, (c["model"] for c in rj["configs"])))
    if rt["valid?"] is False:
        assert rt["final-paths"] and _replays(pt, rt["final-paths"])
        assert rt["dead-row"] is not None


def test_decode_states_match_the_reference():
    """The reference's decode cases (test_lin_models.py), and each
    decoder on states of a generated history."""
    cases = [
        ("set_model", lambda m: m.History.of(
            m.invoke_op(0, "add", "a"), m.ok_op(0, "add", "a")),
         frozenset(["a"])),
        ("fifo_queue", lambda m: m.History.of(
            m.invoke_op(0, "enqueue", 3), m.ok_op(0, "enqueue", 3),
            m.invoke_op(0, "enqueue", 4), m.ok_op(0, "enqueue", 4)), (3, 4)),
        ("unordered_queue", lambda m: m.History.of(
            m.invoke_op(0, "enqueue", 3), m.ok_op(0, "enqueue", 3)), (3,)),
        ("unordered_queue", _multiset_queue, ()),
    ]
    for model, gen, want in cases:
        pt = tprep.prepare(getattr(tm, model)(), gen(th))
        pj = jprep.prepare(getattr(jm, model)(), gen(jh))
        r = tcpu.check_packed(pt)
        assert r["valid?"] is True
        assert r["configs"][0]["model"] == want
        states = [tuple(int(x) for x in pt.init_state),
                  tuple(range(1, pt.state_width + 1))]
        for s in states:
            try:
                want_s = jcpu.decode_state(pj, s)
            except IndexError:
                continue
            assert tcpu.decode_state(pt, s) == want_s


def test_competition_decides_a_history_with_no_kernel():
    """The device racer answers its honest unknown; the CPU racer's
    generic search decides."""
    h = _none_set(th, True)
    r = tlin.analysis(tm.set_model(), h, algorithm="competition",
                      device="cpu")
    assert r["valid?"] is False and r["analyzer"] == "cpu-generic"
    r = tlin.analysis(tm.set_model(), h, algorithm="gpu", device="cpu")
    assert r["valid?"] == "unknown"
    assert r["error"] == "no device kernel for SetModel"


def test_generators_match_jax_op_for_op():
    for gen, kw in (("generate_queue_history",
                     dict(n_ops=300, concurrency=5, seed=3, fifo=False,
                          crash_prob=0.05, max_crashes=4)),
                    ("generate_queue_history", dict(n_ops=200, seed=9)),
                    ("generate_set_history",
                     dict(n_ops=300, concurrency=6, seed=4, read_prob=0.3))):
        hj = getattr(jsynth, gen)(**kw)
        ht = getattr(tsynth, gen)(**kw)
        assert [o.to_dict() for o in ht] == [o.to_dict() for o in hj]


# --- dense routing of small sets, and the key batch over queue keys ----------

def _small_set(mod, seed, corrupt=False):
    """Concurrent adds and reads of at most 4 elements (the reference's
    test_lin_set_packed.py shape)."""
    rng = random.Random(seed)
    items, hist, inflight = set(), [], []
    procs = list(range(3))
    nv = 0
    events = ["add"] * 4 + ["read"] * 4
    rng.shuffle(events)
    for ev in events:
        while not procs:
            q, comp = inflight.pop(0)
            hist.append(comp)
            procs.append(q)
        q = procs.pop(rng.randrange(len(procs)))
        if ev == "add":
            nv += 1
            hist.append(mod.invoke_op(q, "add", nv))
            items.add(nv)
            comp = mod.ok_op(q, "add", nv)
        else:
            hist.append(mod.invoke_op(q, "read", None))
            snap = sorted(items)
            if corrupt and snap:
                snap = snap[:-1]
            comp = mod.ok_op(q, "read", snap)
        if rng.random() < 0.5:
            inflight.append((q, comp))
        else:
            hist.append(comp)
            procs.append(q)
    hist += [comp for _, comp in inflight]
    return mod.History.of(*hist)


@pytest.mark.parametrize("corrupt", [False, True])
def test_small_sets_plan_dense_and_match_jax(corrupt):
    planned = 0
    for seed in range(6):
        pj = jprep.prepare(jm.set_model(), _small_set(jh, seed, corrupt))
        pt = tprep.prepare(tm.set_model(), _small_set(th, seed, corrupt))
        assert tdense.plan(pt) == jdense.plan(pj)
        if tdense.plan(pt) is None:
            continue
        planned += 1
        w, ns, nil_id, _ = tdense.plan(pt)
        assert nil_id == 1 << max(1, len(pt.unintern)) and ns >= nil_id + 1
        rj = jdense.check_packed(pj, explain=True)
        rt = tlin.device_check_packed(pt, device="cpu", explain=True)
        assert rt["analyzer"] == "gpu-dense"
        assert rt["valid?"] is rj["valid?"] is \
            tcpu.check_packed(pt)["valid?"]
        assert rt.get("op") == rj.get("op")
        if rt["valid?"] is False:
            assert _replays(pt, rt["final-paths"])
    assert planned >= 4


QUEUE_KEYS = {
    "mixed-fifo-sizes": ("fifo_queue", lambda m: {
        1: m.History.of(m.invoke_op(0, "enqueue", 1),
                        m.ok_op(0, "enqueue", 1)),
        2: m.History.of(m.invoke_op(0, "enqueue", 1),
                        m.ok_op(0, "enqueue", 1),
                        m.invoke_op(0, "enqueue", 2),
                        m.ok_op(0, "enqueue", 2))}),
    "same-sized-unordered": ("unordered_queue", lambda m: {
        k: m.History.of(m.invoke_op(0, "enqueue", 1),
                        m.ok_op(0, "enqueue", 1),
                        m.invoke_op(0, "dequeue", None),
                        m.ok_op(0, "dequeue", 1)) for k in (1, 2)}),
    "unordered-with-a-bad-key": ("unordered_queue", lambda m: {
        1: m.History.of(m.invoke_op(0, "enqueue", 1),
                        m.ok_op(0, "enqueue", 1),
                        m.invoke_op(0, "dequeue", None),
                        m.ok_op(0, "dequeue", 1)),
        2: m.History.of(m.invoke_op(0, "enqueue", 1),
                        m.ok_op(0, "enqueue", 1),
                        m.invoke_op(0, "dequeue", None),
                        m.ok_op(0, "dequeue", 2))}),
}


@pytest.mark.parametrize("name", list(QUEUE_KEYS))
def test_key_batch_over_queue_keys_matches_jax(name):
    model, subs = QUEUE_KEYS[name]
    rj = jbatched.try_check_batch(getattr(jm, model)(), subs(jh))
    rt = tbatched.try_check_batch(getattr(tm, model)(), subs(th),
                                  device="cpu")
    assert rj is not None and rt is not None and set(rt) == set(rj)
    for k in rj:
        assert rt[k]["valid?"] is rj[k]["valid?"], k
        assert rt[k]["analyzer"] == "gpu-bfs-batch"


# --- the five full shapes of chip_smoke.py's phase 21 ------------------------

FULL = {
    "mutex": (lambda s: s.generate_mutex_history(
        100_000, concurrency=10, seed=7, crash_prob=0.01, max_crashes=16),
        "mutex", 256, 5),
    "set-word": (lambda s: s.generate_set_history(40, concurrency=3,
                                                  seed=7),
                 "set_model", 256, 1),
    "set-wide": (lambda s: s.generate_set_history(600, concurrency=10,
                                                  seed=7),
                 "set_model", 2048, 1),
    "queue": (lambda s: s.generate_queue_history(900, concurrency=10,
                                                 seed=7, fifo=False),
              "unordered_queue", 2048, 1),
    "fifo": (lambda s: s.generate_queue_history(100, concurrency=3, seed=7),
             "fifo_queue", 16384, 3),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FULL))
def test_full_smoke_shapes_match_jax(name):
    """Each of phase 21's shapes through both engines: verdict, final
    frontier size, max cap and overflow, and the constants phase 21
    asserts on the card. Each takes 2-263 s in the reference."""
    gen, model, max_cap, final = FULL[name]
    pj = jprep.prepare(getattr(jm, model)(), gen(jsynth))
    pt = tprep.prepare(getattr(tm, model)(), gen(tsynth))
    rj = jbfs.check_packed(pj)
    rt = tbfs.check_packed(pt, device="cpu")
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    assert (rt["valid?"], rt["max-cap"], rt["final-frontier-size"]) == \
        (True, max_cap, final)
