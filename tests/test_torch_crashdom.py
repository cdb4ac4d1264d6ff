"""The crash-dom bands of the port's sparse engine against the JAX
package: the dominance dedups' plain versions bit for bit against the
reference's forced lax path (the one its crash-dom bands run), its
unforced path and its Pallas kernels in interpret mode; ``check_packed``
on crashed single-key and pair-key histories against the reference's
host-row executor in its per-row mode (verdict, dead row, op, final
frontier, max cap, overflow and the executor's counters), with final
paths that replay legally; the ``capacity`` and ``budget`` unknowns; and
the partitioned history generator. Keys are integers, so every
comparison is exact (tolerance 0)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import psort as jpsort
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import _u32
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import lin as tlin
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import psort as tpsort
from jepsen_tpu_torch.lin import synth as tsynth
from jepsen_tpu_torch.models.kernels import F_IDS, NIL

FILL = 0xFFFFFFFF


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


# --- the dominance dedups ----------------------------------------------------

SIZES = (1000, 1024, 3000)
MODES = ((True, 2), (True, 6), (False, 1))      # (dom_force, dom_iters)
# Key bits: state 0-2, crashed 3-18, read 19-24, group bits above. Pair
# keys put the crashed and read bits across both words and a group bit at
# lo's bit 31.
SINGLE_MASKS = (sum(1 << j for j in range(3, 19)),
                sum(1 << j for j in range(19, 25)))
PAIR_MASKS = (sum(1 << j for j in range(22, 42)),
              sum(1 << j for j in range(42, 48)))


def _masks(pair):
    return PAIR_MASKS if pair else SINGLE_MASKS


def _keys(n, seed, pair, masks=None):
    """Seeded (key, valid, cap) cases: mixed keys with duplicates and
    invalid entries past cap; every key invalid; and one group of most of
    the keys holding long dominance chains, in which the DOM_CHAIN span
    and the prune round count both change the output."""
    rng = np.random.default_rng(seed)
    cmask, rmask = masks or _masks(pair)
    top = 52 if pair else 28
    key = rng.integers(0, 1 << top, n, dtype=np.uint64)
    dom_bits = np.uint64(cmask | rmask)
    grp = np.uint64(5 | (1 << 31) | (3 << 48)) if pair \
        else np.uint64(5 | (3 << 25))
    mixed = key.copy()
    g = rng.random(n) < 0.4
    mixed[g] = (mixed[g] & dom_bits) | grp
    mixed[:n // 10] = mixed[n // 10:2 * (n // 10)]
    # One group: crashed bits set with probability 0.8 (long subset
    # chains), the read bits random, some duplicates.
    chain = np.full(n, grp) | (key & np.uint64(rmask))
    for b in range(top):
        if (cmask >> b) & 1:
            chain |= (rng.random(n) < 0.8).astype(np.uint64) << np.uint64(b)
    chain[:n // 20] = chain[n // 20:2 * (n // 20)]
    return [("mixed", mixed, rng.random(n) < 0.85, n // 4),
            ("all-invalid", mixed, np.zeros(n, bool), n),
            ("chain", chain, rng.random(n) < 0.95, n)]


def _split(key):
    return ((key >> np.uint64(32)).astype(np.uint32),
            key.astype(np.uint32))


def _ab_single(key, valid, masks):
    """The (group, word) pair the engine splits a key into (as the
    reference's ``bfs._dedup_keys_dom`` does)."""
    cmask, rmask = masks
    k = key.astype(np.uint32)
    a = (k & np.uint32(~(cmask | rmask) & FILL)) \
        | ((~valid).astype(np.uint32) << np.uint32(31))
    w = (k & np.uint32(cmask)) | (~k & np.uint32(rmask))
    return a, w


def _ab_pair(key, valid, masks):
    cmask, rmask = masks
    hi, lo = _split(key)
    (ch, cl), (rh, rl) = _split(np.uint64(cmask)), _split(np.uint64(rmask))
    a_hi = (hi & ~(ch | rh)) | ((~valid).astype(np.uint32) << np.uint32(31))
    a_lo = lo & ~(cl | rl)
    return a_hi, a_lo, (hi & ch) | (~hi & rh), (lo & cl) | (~lo & rl)


def _mask_words(pair, masks=None):
    cmask, rmask = masks or _masks(pair)
    if not pair:
        return cmask, rmask
    return cmask >> 32, cmask & FILL, rmask >> 32, rmask & FILL


@functools.lru_cache(maxsize=None)
def _jax_dom(pair, n, force, iters):
    """The reference's lax dominance dedup at cap = n, jitted once per
    shape and mode."""
    if pair:
        return jax.jit(lambda hi, lo, valid, *m: jbfs._dedup_keys2_dom(
            hi, lo, valid, n, *m, use_psort=False, dom_force=force,
            dom_iters=iters))
    return jax.jit(lambda key, valid, *m: jbfs._dedup_keys_dom(
        key, valid, n, *m, use_psort=False, dom_force=force,
        dom_iters=iters))


def _reference(pair, key, valid, cap, force, iters, masks=None):
    """The reference's (keys or (hi, lo), count, overflow) as numpy. It
    runs at cap = n (one compile per shape and mode), and its output is
    cut to ``cap`` by the reference's own last step: the sorted keys'
    first cap, min(total, cap) and total > cap."""
    m = [jnp.uint32(x) for x in _mask_words(pair, masks)]
    n = key.size
    if pair:
        hi, lo = _split(key)
        out = _jax_dom(pair, n, force, iters)(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), *m)
    else:
        out = _jax_dom(pair, n, force, iters)(
            jnp.asarray(key.astype(np.uint32)), jnp.asarray(valid), *m)
    *keys, total, _ = (np.asarray(x) for x in out)
    return (*(k[:cap] for k in keys), min(int(total), cap), int(total) > cap)


def _plain(pair, key, valid, cap, force, iters, masks=None):
    masks = masks or _masks(pair)
    if pair:
        words = [_t(x) for x in _ab_pair(key, valid, masks)]
        return tpsort.dedup_keys2_dom_plain(*words, *_mask_words(True, masks),
                                            cap, force=force, iters=iters)
    words = [_t(x) for x in _ab_single(key, valid, masks)]
    return tpsort.dedup_keys_dom_plain(*words, *_mask_words(False, masks),
                                       cap, force=force, iters=iters)


def _same(got, want):
    """Keys (the lax path returns keys[:min(n, cap)]; the port keys[cap]
    with FILL past them), count and overflow equal."""
    for g, w in zip(got[:-2], want[:-2]):
        g = _np(g)
        if not (np.array_equal(g[:w.size], w) and (g[w.size:] == FILL).all()):
            return False
    return (int(got[-2]), bool(got[-1])) == (int(want[-2]), bool(want[-1]))


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
@pytest.mark.parametrize("n", SIZES)
def test_dom_dedup_plain_matches_lax(n, pair):
    overflowed = False
    for name, key, valid, cap in _keys(n, n + pair, pair):
        for force, iters in MODES:
            want = _reference(pair, key, valid, cap, force, iters)
            got = _plain(pair, key, valid, cap, force, iters)
            assert _same(got, want), (name, force, iters)
            overflowed |= bool(got[-1])
    assert overflowed


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_dom_dedup_chain_and_rounds_change_the_output(monkeypatch, pair):
    """On the chain case the prune round count and the DOM_CHAIN span both
    change the survivors, so the parity above holds them both."""
    n = 3000
    _, key, valid, cap = _keys(n, n + pair, pair)[2]
    outs = [_plain(pair, key, valid, cap, True, k) for k in (2, 6)]
    assert int(outs[0][-2]) > int(outs[1][-2])
    monkeypatch.setattr(tpsort, "DOM_CHAIN", 1 << 20)
    wide = _plain(pair, key, valid, cap, True, 6)
    assert int(wide[-2]) < int(outs[1][-2])


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_dom_dedup_plain_matches_pallas_interpret(monkeypatch, pair):
    """At n = 1024 against the reference's Pallas kernels in interpret
    mode: forced (its DOM_ITERS rounds and the chain) and unforced."""
    monkeypatch.setenv("JEPSEN_TPU_PSORT", "interpret")
    n = 1024
    _, key, valid, cap = _keys(n, 7 + pair, pair)[0]
    for force in (True, False):
        iters = jpsort.DOM_ITERS if force else 1
        if pair:
            words = _ab_pair(key, valid, PAIR_MASKS)
            want = jpsort.dedup_keys2_dom(
                *(jnp.asarray(x) for x in words),
                *(jnp.uint32(x) for x in _mask_words(True)), cap,
                force_window=force)
        else:
            words = _ab_single(key, valid, SINGLE_MASKS)
            want = jpsort.dedup_keys_dom(
                *(jnp.asarray(x) for x in words),
                *(jnp.uint32(x) for x in _mask_words(False)), cap,
                force_window=force)
        want = tuple(np.asarray(x) for x in want)
        got = _plain(pair, key, valid, cap, force, iters)
        assert _same(got, want), force


@pytest.mark.slow
@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_dom_dedup_plain_matches_lax_fuzz(pair):
    """Wider fuzz: more sizes and seeds, the masks drawn per trial."""
    rng = np.random.default_rng(41 + pair)
    for trial, n in enumerate((2048, 4096, 6000, 1500)):
        bits = rng.permutation(44 if pair else 24)[:16] + 3
        masks = (sum(1 << int(b) for b in bits[:11]),
                 sum(1 << int(b) for b in bits[11:]))
        for name, key, valid, cap in _keys(n, 100 + trial, pair, masks):
            for force, iters in MODES + ((True, 3),):
                want = _reference(pair, key, valid, cap, force, iters, masks)
                got = _plain(pair, key, valid, cap, force, iters, masks)
                assert _same(got, want), (n, name, force, iters)


def test_dom_constants_match_the_reference():
    assert (tpsort.DOM_WINDOW, tpsort.DOM_WINDOW_MAX_N, tpsort.DOM_CHAIN,
            tpsort.DOM_ITERS) == (jpsort.DOM_WINDOW, jpsort.DOM_WINDOW_MAX_N,
                                  jpsort.DOM_CHAIN, jpsort.DOM_ITERS)
    for n in (1000, 1 << 18, (1 << 18) + 1):
        for force in (False, True):
            assert tpsort.dom_window(n, force) == jpsort.dom_window(n, force)


# --- the engine ---------------------------------------------------------------

KEYS = ("valid?", "dead-row", "op", "final-frontier-size", "max-cap",
        "overflow")
HOST_KEYS = ("rows", "dispatches", "passes", "wasted_passes")
# The reference's own crash-dom test shapes: the single-key band
# (tests/test_lin_hostrow_wave.py) and the window-34 pair-key partition
# history (tests/test_lin_crashdom_witness.py), clean and corrupted.
SINGLE = ("generate_register_history", (60,),
          dict(concurrency=6, seed=1, crash_prob=0.25))
PARTITION = ("generate_partitioned_register_history", (140,),
             dict(concurrency=40, seed=0, partition_every=60,
                  partition_len=20, max_crashes=10))
# Chunk cap 12 for the single-key case: every frontier the reference's
# host-row executor hands back fits it, so its resume cuts nothing (at
# the reference's own cap 1 it does; see the cap-1 test below), and a
# row still escalates past host cap 8.
ENGINE_CASES = {
    "single": (SINGLE, None, (12,), (8, 64, 512)),
    "pair-corrupt": (PARTITION, 3, (8,), (64, 4096)),
}
# The clean partition history at chunk cap 512, the smallest whose
# hand-backs all fit (at cap 8 the reference's resume cuts 13 of them);
# the reference's chain scans keep it out of the quick tier.
SLOW_CASES = {"pair": (PARTITION, None, (512,), (64, 4096))}


def _packed(spec, corrupt):
    gen, args, kw = spec
    hj = getattr(jsynth, gen)(*args, **kw)
    ht = getattr(tsynth, gen)(*args, **kw)
    if corrupt is not None:
        hj = jsynth.corrupt_history(hj, seed=corrupt)
        ht = tsynth.corrupt_history(ht, seed=corrupt)
    return (jprep.prepare(jm.cas_register(), hj),
            tprep.prepare(tm.cas_register(), ht))


@pytest.fixture
def per_row(monkeypatch):
    """The reference's host-row executor in its per-row mode (no episode
    scheduler, one row per dispatch, sticky caps), the mode the port
    implements; the switches are the reference's own."""
    monkeypatch.setenv("JEPSEN_TPU_HOST_SCHED", "0")
    monkeypatch.setenv("JEPSEN_TPU_HOST_ROWS_K", "1")
    monkeypatch.setenv("JEPSEN_TPU_HOST_STICKY", "1")


def _both(spec, corrupt, caps, host):
    """One case through both engines, explain on, the reference in its
    per-row mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_HOST_SCHED", "0")
        mp.setenv("JEPSEN_TPU_HOST_ROWS_K", "1")
        mp.setenv("JEPSEN_TPU_HOST_STICKY", "1")
        pj, pt = _packed(spec, corrupt)
        rj = jbfs.check_packed(pj, cap_schedule=caps, host_caps=host,
                               explain=True)
        rt = tbfs.check_packed(pt, cap_schedule=caps, host_caps=host,
                               explain=True, device="cpu")
    return pj, pt, rj, rt


@pytest.fixture(scope="module")
def engine_runs():
    """Each quick case through both engines, computed once."""
    return {name: _both(*case) for name, case in ENGINE_CASES.items()}


def _replays_legally(p, final_paths):
    """Each final path is a legal linearization prefix under the model,
    stepped by the port's own step function."""
    step = tprep.py_step_fn(p.kernel.name)
    by_index = {o.op_index: o for o in p.ops}
    for fp in final_paths:
        st = tuple(int(x) for x in p.init_state)
        for od in fp["path"]:
            o = by_index[od["index"]]
            if o.f == "cas":
                v = (p.intern.get(o.value[0], int(NIL)),
                     p.intern.get(o.value[1], int(NIL)))
            else:
                v = (int(NIL) if o.value is None
                     else p.intern.get(o.value, int(NIL)), int(NIL))
            ok, st = step(st, F_IDS[o.f], v)
            if not ok:
                return False
    return True


def _engine_parity(pj, pt, rj, rt):
    assert (pt.window, pt.R) == (pj.window, pj.R)
    assert pt.crashed.any() and tbfs.band_error(pt) is None
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    assert rt["analyzer"] == "gpu-bfs" and rt["backend"] == "plain"
    hj, ht = rj["host-stats"], rt["host-stats"]
    assert {k: ht[k] for k in HOST_KEYS} == {k: hj[k] for k in HOST_KEYS}
    assert ht["rows"] >= 1 and ht["passes"] >= ht["dispatches"]
    if rj["valid?"] is False:
        assert rt["final-paths"] and _replays_legally(pt, rt["final-paths"])


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_crash_dom_engine_matches_jax(engine_runs, name):
    _engine_parity(*engine_runs[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW_CASES))
def test_crash_dom_engine_matches_jax_slow(name):
    pj, pt, rj, rt = _both(*SLOW_CASES[name])
    _engine_parity(pj, pt, rj, rt)
    assert rt["valid?"] is True and rt["max-cap"] == 4096


@pytest.mark.slow
def test_partition_history_at_default_caps_matches_jax(per_row):
    """A 2k-op partition history at config 5's pacing (window 24, crashed
    mutators: the single-key crash-dom band) at the default caps."""
    spec = ("generate_partitioned_register_history", (2000,),
            dict(seed=7, invoke_bias=0.45))
    pj, pt = _packed(spec, None)
    assert pt.window == 24 and pt.crashed.any()
    rj = jbfs.check_packed(pj)
    rt = tbfs.check_packed(pt, device="cpu")
    assert rj["valid?"] is True
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    hj, ht = rj.get("host-stats"), rt.get("host-stats")
    assert (hj is None) == (ht is None)
    if hj is not None:
        assert {k: ht[k] for k in HOST_KEYS} == {k: hj[k] for k in HOST_KEYS}


def test_the_cases_cover_both_key_widths(engine_runs):
    b = 3
    single = engine_runs["single"][1]
    assert single.window + b <= 31
    pt = engine_runs["pair-corrupt"][1]
    assert pt.window == 34 and pt.window + b > 31
    corrupt = engine_runs["pair-corrupt"][3]
    assert corrupt["valid?"] is False and corrupt["dead-row"] == 45
    assert engine_runs["single"][3]["valid?"] is True


def test_host_row_hand_back_fits_the_chunk_cap(per_row, monkeypatch):
    """At chunk cap 1 the reference's host-row executor hands back up to
    11 configs and its resume keeps one (ROADMAP section 3); the port
    clamps its dropback to the top chunk cap, so every hand-back before
    the history's end fits, and the search ends on the frontier of a
    run that never leaves the chunks. Same verdict as the reference,
    with more host rows."""
    pj, pt = _packed(SINGLE, None)
    backs = []
    host_rows = tbfs._host_rows

    def spy(eng, r0, lo, hi, count, **kw):
        out = host_rows(eng, r0, lo, hi, count, **kw)
        backs.append((out[2], out[3]))
        return out

    monkeypatch.setattr(tbfs, "_host_rows", spy)
    host = (8, 64, 512)
    rj = jbfs.check_packed(pj, cap_schedule=(1,), host_caps=host)
    rt = tbfs.check_packed(pt, cap_schedule=(1,), host_caps=host,
                           device="cpu")
    whole = tbfs.check_packed(pt, cap_schedule=(4096,), device="cpu")
    assert "host-stats" not in whole and whole["valid?"] is True
    assert backs and all(c <= 1 for c, nxt in backs if nxt < pt.R)
    assert rt["valid?"] is rj["valid?"] is True
    assert rt["final-frontier-size"] == whole["final-frontier-size"]
    assert rt["host-stats"]["rows"] > rj["host-stats"]["rows"]


@pytest.mark.parametrize("kind", ["capacity", "budget"])
def test_host_row_overflow_is_the_references_unknown(per_row, monkeypatch,
                                                     kind):
    """The last host cap overflowing answers ``overflow: capacity``; a
    pass budget of 1 answers ``overflow: budget`` (the reference reads its
    budget from JEPSEN_TPU_HOST_IT_MAX; the port's is patched)."""
    pj, pt = _packed(SINGLE, None)
    host = (8, 16) if kind == "capacity" else (8, 64, 512)
    if kind == "budget":
        monkeypatch.setenv("JEPSEN_TPU_HOST_IT_MAX", "1")
        monkeypatch.setattr(tbfs, "_host_it_max", lambda W: 1)
    rj = jbfs.check_packed(pj, cap_schedule=(12,), host_caps=host)
    rt = tbfs.check_packed(pt, cap_schedule=(12,), host_caps=host,
                           device="cpu")
    assert rt["valid?"] == "unknown" and rt["overflow"] == kind
    assert {k: rt.get(k) for k in KEYS + ("error",)} == \
        {k: rj.get(k) for k in KEYS + ("error",)}
    assert {k: rt["host-stats"][k] for k in HOST_KEYS} == \
        {k: rj["host-stats"][k] for k in HOST_KEYS}


def test_a_crashed_generic_band_history_decides_like_the_reference():
    """Crashed ops outside the register family (a mutex, the generic
    packed band) decide on ``gpu-bfs`` with the reference's verdict, dead
    row and op, through the band's ordinary loop: no crash-dom path, so
    no host-row stats."""
    from jepsen_tpu import history as jh

    n = 22

    def ops(h):
        out = [h.invoke_op(p, "acquire", None) for p in range(n)]
        out += [h.invoke_op(n, "release", None),
                h.info_op(n, "release", None)]
        out += [h.ok_op(p, "acquire", None) for p in range(n)]
        return h.History.of(*out)

    p = tprep.prepare(tm.mutex(), ops(th))
    assert p.window > 20 and p.crashed.any()
    assert tbfs.key_band(p) == "generic"
    rj = jbfs.check_packed(jprep.prepare(jm.mutex(), ops(jh)))
    r = tlin.device_check_packed(p, device="cpu")
    assert r["analyzer"] == "gpu-bfs" and r["valid?"] is False
    assert {k: r.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    assert "host-stats" not in r


@pytest.mark.parametrize("seed", [0, 7])
def test_partitioned_history_matches_the_reference(seed):
    kw = dict(concurrency=30, seed=seed, partition_every=400,
              partition_len=120, invoke_bias=0.45)
    hj = jsynth.generate_partitioned_register_history(1500, **kw)
    ht = tsynth.generate_partitioned_register_history(1500, **kw)

    def ops(h):
        return [(o.type, o.f, o.value, o.process, o.index) for o in h]

    assert ops(ht) == ops(hj)
    assert any(o.type == "info" for o in ht)
